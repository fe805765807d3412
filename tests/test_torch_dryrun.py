"""The port's pod-scale dry run on meta tensors against the JAX package.

``launch.cells`` builds a cell's arguments as meta tensors at one rank's
local shapes and ``launch.dryrun`` drives the card's own step on them
under ``launch.dry_costs.DryCounter`` over a ``launch.mesh.DryMesh``
(no process group, no allocation).  Held here, with no spawn:

- ``input_specs`` and ``cell_skip_reason`` equal the reference's on every
  assigned (arch x shape) cell;
- each production cell's per-rank argument bytes (f32 moments for train)
  equal the reference's leaves cut by its ``resolve_pspec`` on a stub of
  the 16x16 and 2x16x16 meshes, exactly; and, for reduced olmo-1b train
  and decode on one device, XLA's compiled ``argument_size_in_bytes`` of
  the reference's own ``build_cell``;
- ``collective_bytes``, ``terms_from_pair`` and ``extrapolate`` equal the
  reference's on the same inputs (hand-written HLO lines on its side, the
  matching dry-mesh records on the port's);
- on a dry 2x2 mesh the depth-1 / depth-2 extrapolation of FLOPs, bytes,
  collective bytes and counts equals the full-depth pass exactly;
- a reduced train step calls the GEMM exactly 3 times a forward GEMM (4 a
  layer's GEMM under ``remat_policy="full"``), and the plain attention's
  ``attn_core`` scope books its backward ops too;
- full-width olmo-1b ``train_4k`` and kimi-k2 ``decode_32k`` on 16x16 run
  on meta in seconds;
- every kernel wrapper refuses meta outside a counter and, inside one,
  returns its CUDA route's output shapes and dtypes without a launch;
- full qwen3-moe-30b-a3b ``train_4k`` under ``parallel_mode="fsdp"`` on
  16x16 (dispatch groups over ranks) runs and gathers each group's int32
  choice counts, a MoE layer's forward and recompute each.

The dry mesh's counts against a live mesh's are held in the spawned groups
of ``tests/test_torch_mesh_train.py`` and ``tests/test_torch_mesh_serving.py``.
"""
import math
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch import cells as JCELLS
from repro.launch import roofline as JR
from repro.launch import sharding as JS
from repro.models import model as JM
from repro.models.params import is_spec as j_is_spec
import repro_torch.configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels import ops
from repro_torch.launch import roofline as TR
from repro_torch.launch.cells import build_cell, input_specs
from repro_torch.launch.dry_costs import DryCounter
from repro_torch.launch.dryrun import count, fresh, run_cell
from repro_torch.launch.mesh import DryMesh, dry_production_mesh
from repro_torch.models import model as TM
from repro_torch.training.optimizer import AdamWConfig

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
CELLS = [(a, s) for a in TC.ASSIGNED for s in TC.SHAPES]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jdtype(dt) -> torch.dtype:
    return DTYPES[jnp.dtype(dt).type]


def _jleaves(tree):
    """(path, spec) of every leaf of a reference spec tree."""
    if j_is_spec(tree):
        yield "", tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            for p, s in _jleaves(v):
                yield f"{k}/{p}", s
    else:
        for i, v in enumerate(tree):
            for p, s in _jleaves(v):
                yield f"{i}/{p}", s


def test_input_specs_and_skips_equal_reference():
    """Every assigned cell: the same inputs (shape, logical axes, dtype
    mapped) and the same skip reason in both packages."""
    assert sorted(TC.ASSIGNED) == sorted(JC.ASSIGNED) and list(TC.SHAPES) == list(JC.SHAPES)
    for arch, shape in CELLS:
        tcfg, jcfg = TC.get_config(arch), JC.get_config(arch)
        assert TC.cell_skip_reason(tcfg, TC.SHAPES[shape]) == \
            JC.cell_skip_reason(jcfg, JC.SHAPES[shape]), (arch, shape)
        got = input_specs(tcfg, TC.SHAPES[shape])
        want = JCELLS.input_specs(jcfg, JC.SHAPES[shape])
        assert list(got) == list(want), (arch, shape)
        for k, w in want.items():
            g = got[k]
            assert (tuple(g.shape), tuple(g.axes)) == (tuple(w.shape), tuple(w.axes)), (arch, k)
            assert g.dtype == _jdtype(w.dtype), (arch, shape, k)


def _local_bytes(spec, pspec, mesh_shape, dtype) -> int:
    n = math.prod(spec.shape)
    for entry in pspec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n //= mesh_shape[a]
    return n * jnp.dtype(spec.dtype or dtype).itemsize


def _reference_argument_bytes(arch: str, shape_name: str, mesh_shape: dict) -> int:
    """The bytes one rank holds of the reference's cell arguments: every
    param / input / cache leaf cut by the reference's ``resolve_pspec`` on a
    stub mesh (f32 moments twice the params' elements for train, the step
    and decode's position an int32 scalar).  A MoE router counts whole: the
    port keeps it whole on every rank (``model.param_pspecs``; it has no
    partitioner to gather its logits).  Serving params are cut without
    FSDP, as the port's engine holds them (the reference's serving cells
    cut them with ``cfg.fsdp``)."""
    stub = types.SimpleNamespace(shape=mesh_shape)
    cfg = JCELLS.prepare_arch(JC.get_config(arch), stub)
    shape = JC.SHAPES[shape_name]
    prof = JS.profile_for(cfg)
    total = params = 0
    for path, s in _jleaves(JM.param_specs(cfg)):
        ps = (None,) * len(s.shape) if path.endswith("router/") else \
            JS.resolve_pspec(s, stub, fsdp=cfg.fsdp and shape.step == "train", profile=prof)
        params += _local_bytes(s, ps, mesh_shape, cfg.param_dtype)
        if shape.step == "train":
            total += 2 * _local_bytes(s._replace(dtype=jnp.float32), ps, mesh_shape, None)
    total += params
    for _, s in _jleaves(JCELLS.input_specs(cfg, shape)):
        total += _local_bytes(s, JS.resolve_pspec(s, stub, profile=prof), mesh_shape, None)
    if shape.step == "decode":
        for _, s in _jleaves(JM.cache_specs(cfg, shape.global_batch, shape.seq_len)):
            total += _local_bytes(s, JS.resolve_pspec(s, stub, profile=prof), mesh_shape,
                                  cfg.compute_dtype)
    return total + (0 if shape.step == "prefill" else 4)  # the step / the position


def _argument_bytes(args) -> int:
    c = DryCounter()
    c.arguments(args)
    return c.argument_bytes


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_equal_reference_specs(mesh_name):
    """Every production cell's per-rank arguments, byte for byte."""
    shape, axes = MESHES[mesh_name]
    mesh = DryMesh(shape, axes)
    checked = 0
    for arch, sname in CELLS:
        if TC.cell_skip_reason(TC.get_config(arch), TC.SHAPES[sname]):
            continue
        cell = build_cell(TC.get_config(arch), TC.SHAPES[sname], mesh)
        assert _argument_bytes(cell.args) == \
            _reference_argument_bytes(arch, sname, dict(zip(axes, shape))), (arch, sname)
        checked += 1
    assert checked == 32


@pytest.mark.parametrize("step", ["train", "decode"])
def test_argument_bytes_equal_xla(step):
    """Reduced olmo-1b on one device: the port's arguments equal XLA's
    ``argument_size_in_bytes`` of the reference's compiled cell."""
    jcfg = JC.reduce_config(JC.get_config("olmo-1b"))
    tcfg = TC.reduce_config(TC.get_config("olmo-1b"))
    B, S = 4, 32
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcell = JCELLS.build_cell(jcfg, JC.base.ShapeConfig("t", S, B, step), jmesh)
    with JS.activation_mesh(jmesh, JS.profile_for(jcell.cfg)):
        lowered = jax.jit(jcell.fn, in_shardings=jcell.in_shardings,
                          donate_argnums=jcell.donate).lower(*jcell.args)
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    cell = build_cell(tcfg, ShapeConfig("t", S, B, step), DryMesh((1, 1), ("data", "model")))
    assert _argument_bytes(cell.args) == want


def test_collective_bytes_equals_reference():
    """The same collectives as HLO lines (the reference's reader) and as a
    dry mesh's records (the port's): every kind's wire bytes, the total,
    the cross-pod share (a group of 2 there, the ``pod`` axis here) and the
    counts."""
    hlo = "\n".join([
        "%ag = bf16[16,128]{1,0} all-gather(bf16[1,128]{1,0} %x), "
        "replica_groups=[16,16]<=[256], dimensions={0}",
        "%ar = f32[64,32]{1,0} all-reduce(f32[64,32]{1,0} %y), "
        "replica_groups=[16,16]<=[256], to_apply=%add",
        "%rs = f32[4,32]{1,0} reduce-scatter(f32[64,32]{1,0} %z), "
        "replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add",
        "%cp = bf16[8,8]{1,0} collective-permute(bf16[8,8]{1,0} %w), "
        "source_target_pairs={{0,1},{1,2}}",
        "%pd = f32[3,5]{1,0} all-reduce(f32[3,5]{1,0} %v), replica_groups={{0,256}}, "
        "to_apply=%add",
        "%ai = s32[7]{0} all-reduce(s32[7]{0} %u), replica_groups=[16,16]<=[256], "
        "to_apply=%add",
    ])
    records = [("all-gather", "model", 16, 1 * 128 * 2),
               ("all-reduce", "model", 16, 64 * 32 * 4),
               ("reduce-scatter", "data", 16, 64 * 32 * 4),
               ("collective-permute", "model", 16, 8 * 8 * 2),
               ("all-reduce", "pod", 2, 3 * 5 * 4),
               ("all-reduce", "data", 16, 7 * 4)]
    assert TR.collective_bytes(records) == JR.collective_bytes(hlo)
    assert TR.collective_bytes(records)["cross_pod"] == 2 * 3 * 5 * 4


def test_terms_and_extrapolation_equal_reference():
    """``terms_from_pair`` and ``extrapolate`` on the same dicts: the same
    extrapolated counts; each time term the count over the port's own
    data-sheet constant."""
    c1, c2 = {"flops": 3e12, "bytes accessed": 5e10}, {"flops": 5e12, "bytes accessed": 8e10}
    k1 = TR.collective_bytes([("all-gather", "data", 16, 4096), ("all-reduce", "pod", 2, 8)])
    k2 = TR.collective_bytes([("all-gather", "data", 16, 4096), ("all-reduce", "pod", 2, 8),
                              ("all-reduce", "model", 16, 1000)])
    got = TR.terms_from_pair(c1, c2, k1, k2, 61, 1e9, 3e9)
    want = JR.terms_from_pair(c1, c2, k1, k2, 61, 1e9, 3e9)
    for key in ("flops", "bytes", "coll_bytes", "attn_core_bytes", "coll_detail"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.t_compute == got.flops / TR.PEAK_FLOPS
    assert got.t_collective == got.coll_bytes / TR.LINK_BW
    assert got.t_bound_serial == got.t_compute + got.t_memory + got.t_collective
    assert set(got.as_dict()) == set(want.as_dict())
    for v in (0.0, 7.5, 1e12):
        assert TR.extrapolate(v, 2 * v + 1, 61) == JR.extrapolate(v, 2 * v + 1, 61)


def _reduced(arch="olmo-1b", **kw):
    return TC.reduce_config(TC.get_config(arch)).with_(**kw)


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_depth_extrapolation_is_exact(step):
    """Reduced olmo-1b at 4 layers (one stage of 4) with FSDP (train
    cells; serving cells hold their params without it) on a dry 2x2 mesh: FLOPs, bytes, collective bytes by kind and counts from depths 1
    and 2 equal the full-depth pass."""
    cfg = _reduced(num_layers=4, fsdp=True)
    shape = ShapeConfig("t", 16, 4, step)
    mesh = DryMesh((2, 2), ("data", "model"))
    assert max(s.repeats for s in cfg.stages()) == 4

    def measure(r):
        m = fresh(mesh)
        c = count(build_cell(cfg, shape, m, main_repeats=r))
        return c, TR.collective_bytes(m.records)

    (c1, k1), (c2, k2), (cf, kf) = measure(1), measure(2), measure(None)
    terms = TR.terms_from_pair({"flops": c1.flops, "bytes accessed": c1.bytes},
                               {"flops": c2.flops, "bytes accessed": c2.bytes}, k1, k2, 4)
    assert (terms.flops, terms.bytes, terms.coll_bytes) == (cf.flops, cf.bytes, kf["total"])
    assert terms.coll_detail == {k: kf[k] for k in terms.coll_detail}
    assert {k: TR.extrapolate(k1["counts"][k], k2["counts"][k], 4) for k in kf["counts"]} \
        == kf["counts"]
    assert c2.flops > c1.flops and k2["total"] > k1["total"]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gemm_calls_per_forward_gemm(remat):
    """A reduced train step calls the GEMM 3 times a forward GEMM (the
    forward, ``g @ W^T``, ``A^T @ g``); under ``full`` a layer's GEMMs run a
    fourth time in the recompute, the head's does not.  The forward GEMMs
    are counted by a forward without autograd at depths 1 and 2."""
    cfg = _reduced(remat_policy=remat)
    mesh = DryMesh((1, 1), ("data", "model"))
    shape = ShapeConfig("t", 16, 4, "train")

    def forward_calls(r):
        cell = build_cell(cfg, shape, fresh(mesh), main_repeats=r)
        params, batch = cell.args[0].params, cell.args[1]
        with DryCounter() as c, torch.no_grad():
            TM.loss_fn(cell.cfg, params, batch, main_repeats=r)
        return c.kernel_calls["block_gemm"]

    per_layer = forward_calls(2) - forward_calls(1)
    layers = cfg.num_layers
    n_fwd = forward_calls(1) + per_layer * (layers - 1)
    c = count(build_cell(cfg, shape, fresh(mesh)))
    want = 3 * n_fwd + (per_layer * layers if remat == "full" else 0)
    assert per_layer == 7 and c.kernel_calls == {"block_gemm": want}


def test_attention_core_books_forward_and_backward():
    """The plain attention's ``attn_core`` scope books its forward ops and,
    through the autograd nodes it recorded, its backward ones: a train step
    books more than the same forward alone, and no kernel's call."""
    cfg = _reduced()
    cell = build_cell(cfg, ShapeConfig("t", 16, 4, "train"), DryMesh((1, 1), ("data", "model")))
    step = count(cell)
    params = cell.args[0].params
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with DryCounter() as fwd:
        TM.loss_fn(cell.cfg, tree_unflatten(params, leaves), cell.args[1])
    assert 0 < fwd.scope_bytes["attn_core"] < step.scope_bytes["attn_core"] < step.bytes
    assert "flash_attention" not in step.kernel_calls


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "train_4k"),
                                        ("kimi-k2-1t-a32b", "decode_32k")])
def test_full_width_cells_on_meta(arch, shape):
    """A full-width cell on the 16x16 mesh, full depth, in seconds: a memory
    record, the kernels' calls and collectives, nothing allocated."""
    t0 = time.time()
    rec = run_cell(arch, shape, dry_production_mesh(), "pod16x16", overrides={},
                   opt=AdamWConfig(), do_roofline=False)
    assert time.time() - t0 < 60
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert 0 < mem["peak_per_device_gib"] < 1000
    assert rec["kernel_calls"]["block_gemm"] > 0 and rec["collectives"]["total"] > 0
    if shape.startswith("decode"):
        assert rec["kernel_calls"]["flash_decode"] == TC.get_config(arch).num_layers
        assert mem["alias_bytes"] > 0  # the caches, written in place
    else:
        assert "flash_attention" not in rec["kernel_calls"]  # plain under autograd


def _wrapper_cases():
    """(wrapper, args, kwargs, the CUDA route's output (shape, dtype)s)."""
    m, bf, f32, i8, i32 = "meta", torch.bfloat16, torch.float32, torch.int8, torch.int32

    def t(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device=m)
    M, K, N = 8, 64, 32
    B, H, Kh, S, d = 2, 4, 2, 16, 16
    pool = t(6, 8, Kh, d)
    pages, rows = t(B, 3, dtype=i32), t(B, dtype=i32)
    return [
        (ops.block_gemm, (t(M, K), t(K, N)), {}, [((M, N), bf)]),
        (ops.block_gemm_int8, (t(M, K, dtype=i8), t(N, K, dtype=i8), t(M, 1, dtype=f32),
                               t(1, N, dtype=f32)), {}, [((M, N), f32)]),
        (ops.quantize_rows, (t(M, K),), {}, [((M, K), i8), ((M, 1), f32)]),
        (ops.flash_attention, (t(B, H, S, d), t(B, Kh, S, d), t(B, Kh, S, d)), {},
         [((B, H, S, d), bf)]),
        (ops.flash_attention_paged, (t(B, H, 4, d), pool, pool, pages, rows, rows), {},
         [((B, H, 4, d), bf)]),
        (ops.flash_decode, (t(B, H, d), t(B, S, Kh, d), t(B, S, Kh, d), rows, rows), {},
         [((B, H, d), bf)]),
        (ops.flash_decode_paged, (t(B, H, d), pool, pool, rows, rows, pages), {},
         [((B, H, d), bf)]),
        (ops.block_gemm_int8_acc, (t(M, K, dtype=i8), t(N, K, dtype=i8)), {},
         [((M, N), i32)]),
        (ops.int8_epilogue, (t(M, N, dtype=i32), t(M, 1, dtype=f32), t(1, N, dtype=f32)),
         {"out_dtype": bf}, [((M, N), bf)]),
        (ops.row_amax, (t(M, K),), {}, [((M, 1), f32)]),
        (ops.quantize_rows_given, (t(M, K), t(M, 1, dtype=f32)), {},
         [((M, K), i8), ((M, 1), f32)]),
    ]


def test_wrappers_on_meta():
    """Every wrapper of ``LAUNCH_COUNTERS``: a meta tensor raises outside a
    dry run; inside one the call returns the CUDA route's outputs, is
    reported once and launches nothing."""
    cases = _wrapper_cases()
    assert {w for w, *_ in cases} == set(ops.LAUNCH_COUNTERS)
    for w, args, kw, want in cases:
        with pytest.raises(ValueError):
            w(*args, **kw)
        before = w.launches
        with DryCounter() as c:
            out = w(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        assert [(tuple(o.shape), o.dtype) for o in outs] == want, w.__name__
        assert all(o.is_meta for o in outs)
        assert w.launches == before and sum(c.kernel_calls.values()) == 1, w.__name__


def test_fsdp_moe_cell_gathers_the_group_counts():
    """Full qwen3-moe-30b-a3b ``train_4k`` under ``parallel_mode="fsdp"`` on
    the 16x16 mesh: the batch splits 256 ways over (data, model) and its 16
    dispatch groups each span the 16 ranks of a model line.  The cell runs,
    and each MoE layer's forward (and its recompute under ``full`` remat)
    all-gathers this rank's int32 counts [1, k, E] over model (the group's
    line) alone."""
    cfg = TC.get_config("qwen3-moe-30b-a3b").with_(parallel_mode="fsdp")
    mesh = dry_production_mesh()
    c = count(build_cell(cfg, TC.SHAPES["train_4k"], mesh, attn_chunk=2048))
    assert 0 < c.memory()["peak_per_device_gib"] < 80
    n = cfg.experts_per_token * cfg.num_experts * 4  # bytes of one rank's counts
    recs = mesh.records
    assert sum(x == ("all-gather", "model", 16, n) for x in recs) == 2 * cfg.num_layers
