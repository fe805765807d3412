"""Drive the static checks over every shipped config (the port's
counterpart of ``repro.analysis.runner``).

For each (config, mode, quant) cell the runner drives the port's served
entries -- the training forward and its logits, ``model.prefill``, and the
engine's decode, mixed or whole-prefill and copy-on-write steps -- under an
``op_lints.OpRecorder`` and lints what ran (J001-J006), checks the cache
buffers around the entries that update them in place (D001, D002), and on
the card counts the one device -> host copy of each ``ModelRunner`` tick
and every synchronising call under ``torch.cuda.set_sync_debug_mode``
(J003).  Per config it proves the address arithmetic of every kernel the
config reaches (K001-K003, ``bounds``) and drives the mesh engine at 1 x 2
on a ``mesh_lints.RecordingMesh`` (J007); then the paging workload (P001)
and the resilience scenarios (R001).

:data:`MODES`, each asked for explicitly -- nothing is chosen by whether a
card is present, and nothing falls back:

``plain``  CPU tensors through the kernels' plain versions;
``meta``   meta tensors through the wrappers' card route inside a
           ``launch.dry_costs.DryCounter`` (dtypes and ops, no data): a
           host read raises there and is reported as J003;
``cuda``   the card (raises without one).

Configs are reduced with ``reduce_config`` but keep their shipped compute
dtype (``reduce_config`` forces f32, which would hide every promotion this
tool exists to catch)."""
from __future__ import annotations

import contextlib
import warnings
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.bounds import check_kernel_spec
from repro_torch.analysis.donation import check_aliases, check_donation, storages
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.mesh_lints import (RecordingMesh, lint_collectives,
                                             param_gather_shapes)
from repro_torch.analysis.op_lints import (_DATA_SHAPED, OpRecorder, check_logits_dtype,
                                           lint_ops)
from repro_torch.configs import REGISTRY, get_config, reduce_config
from repro_torch.launch.dry_costs import DryCounter
from repro_torch.models import model as M
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine, ModelRunner
from repro_torch.serving.paging import PagePool, RadixCache, check_invariants

MODES = ("plain", "meta", "cuda")
QUANTS = ("none", "w8a8")
DEVICES = {"plain": "cpu", "meta": "meta", "cuda": "cuda"}

# geometry: small enough to run fast, big enough to reach every structural
# path (window 32 after reduce_config, a page table of 4 pages a slot)
_S = 32          # forward / prefill sequence length
_B = 2           # batch
_C = 8           # a mixed tick's chunk
_ENGINE = dict(page_size=16, max_batch=2, max_len=64, decode_chunk=2)
_TP = 2          # the mesh engine's model axis


def analysis_config(name: str):
    """Reduced config with the *shipped* compute dtype (which also stores
    the float weights): a bf16 serving stack run in f32 would show none of
    the promotions the J-rules look for."""
    full = get_config(name)
    return reduce_config(full).with_(compute_dtype=full.compute_dtype)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, tuple):  # QTensor
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev)


def _batch(cfg, dev, B: int = _B, S: int = _S) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    if cfg.frontend_dim:
        batch["frames"] = torch.zeros((B, S, cfg.frontend_dim), dtype=torch.float32,
                                      device=dev)
    if cfg.vision_tokens:
        batch["images"] = torch.zeros((B, cfg.vision_tokens, cfg.vision_dim),
                                      dtype=torch.float32, device=dev)
    return batch


@contextlib.contextmanager
def _mode(mode: str):
    """The context an entry runs in: a dry-run counter on meta (the
    wrappers take meta tensors only inside one), nothing else."""
    if mode == "meta":
        with DryCounter():
            yield
    else:
        yield


def _lint_entry(report: Report, fn, ctx: str, mode: str, *, logits: bool = False,
                caches=None, sync: bool = False):
    """Run ``fn()`` under an :class:`OpRecorder` and lint it: J001-J005 on
    its ops, J006 on its result's logits (``logits``: the result or its
    first element), D001 on ``caches`` around it.  A host read that raises
    on meta ends the entry as a J003 finding.  ``sync`` (the card): every
    synchronising call is a J003 finding.  Returns the recorder."""
    before = storages(caches) if caches is not None else None
    rec = OpRecorder()
    result = None
    with warnings.catch_warnings(record=True) as caught, _mode(mode):
        warnings.simplefilter("always")
        if sync:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                result = fn()
        except (NotImplementedError, RuntimeError) as exc:
            last = rec.ops[-1] if rec.ops else None
            if mode != "meta" or last is None or last.name not in _DATA_SHAPED:
                raise
            report.add(Finding("J003", f"host read '{last.name}' raised on meta: {exc}"
                                       .splitlines()[0][:200], ctx, last.file, last.line))
        finally:
            if sync:
                torch.cuda.set_sync_debug_mode(0)
    report.extend(lint_ops(rec.ops, ctx, DEVICES[mode]))
    for w in caught:  # (the mode's own note that it is a prototype is no finding)
        if sync and "synchronizing CUDA operation" in str(w.message):
            report.add(Finding("J003", f"synchronising call inside a served entry: "
                                       f"{str(w.message).splitlines()[0][:160]}", ctx,
                               w.filename, w.lineno))
    if logits and result is not None:
        out = result[0] if isinstance(result, tuple) else result
        report.extend(check_logits_dtype(out, ctx))
    if before is not None:
        report.extend(check_donation(before, caches, ctx))
        report.extend(check_aliases(caches, ctx))
    report.checked.append(ctx)
    return rec


def _decode_args(runner: ModelRunner, npp: int, dev):
    B = runner.max_batch
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    return dict(pages=torch.zeros((B, npp), dtype=torch.int32, device=dev), cur=z, pos=z,
                nanmask=torch.zeros(B, dtype=torch.bool, device=dev),
                remaining=torch.full((B,), 3, dtype=torch.int32, device=dev),
                temps=[0.0] * B, gens=[None] * B)


def _decode_entry(runner: ModelRunner, a: dict, steps: int):
    """The decode tick's device work: the decode graph's buffers loaded and
    ``steps`` steps (the step, the sampler, the state update)."""
    def run():
        runner.graph.load(a["cur"], a["pos"], a["pages"], a["nanmask"])
        with runner.on_mesh():
            return runner._decode_steps(a["remaining"], a["temps"], a["gens"], steps)
    return run


def _mixed_entry(runner: ModelRunner, cfg, a: dict, dev):
    """The mixed tick's device work: a C-row chunk over slot 0's table,
    then one decode step of every slot."""
    buf = torch.zeros((1, _C), dtype=torch.int32, device=dev)

    def run():
        with runner.on_mesh():
            logits, _ = M.chunk_step(cfg, runner.params, runner.caches, buf, a["pages"][:1],
                                     0, _C)
        _decode_entry(runner, a, 1)()
        return logits
    return run


def _whole_prefill_entry(runner: ModelRunner, cfg, npp: int, dev):
    """The whole-prefill tick's device work: ``model.prefill`` of an
    8-token prompt and its rows scattered into slot 0's pages."""
    toks = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    table = torch.arange(npp, dtype=torch.int32, device=dev)

    def run():
        with runner.on_mesh():
            logits, small = M.prefill(cfg, runner.params, toks, full_kv=True)
        runner._scatter_new(small, table, 0, 8)
        return logits
    return run


def _tick_copies(report: Report, fn, ctx: str):
    """The card: a ``ModelRunner`` tick makes exactly its one documented
    device -> host copy (J003)."""
    rec = OpRecorder()
    with rec:
        fn()
    d2h = [op for op in rec.ops if op.name in ("_to_copy", "copy_")
           and "cpu" in op.out_devices and "cuda" in op.in_devices]
    if len(d2h) != 1:
        where = dict(file=d2h[1].file, line=d2h[1].line) if len(d2h) > 1 else {}
        report.add(Finding("J003", f"the tick made {len(d2h)} device -> host copies, not "
                                   f"its one documented copy", ctx, **where))
    report.checked.append(ctx)


def check_cell(name: str, mode: str, quant: str, report: Report, params=None) -> None:
    """Every entry check of one (config, mode, quant) cell.  ``params``:
    the config's float weights on the CPU (seed 0 when None)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    cfg = analysis_config(name)
    dev = DEVICES[mode]
    base = f"config={name} mode={mode} quant={quant}"
    if params is None:
        params = M.init(cfg, seed=0, device="cpu")
    card = mode == "cuda"
    fwd_params = _to(M.quantize_params(cfg, params) if quant == "w8a8" else params, dev)
    batch = _batch(cfg, dev)

    def fwd():
        with torch.no_grad():
            hidden, _ = M.forward_hidden(cfg, fwd_params, batch["tokens"], mode="train",
                                         frames=batch.get("frames"),
                                         images=batch.get("images"))
            return M.lm_logits(cfg, fwd_params, hidden)

    _lint_entry(report, fwd, f"{base} entry=forward", mode, logits=True, sync=card)
    if cfg.kind != "decoder":
        return

    def pfx():
        with torch.no_grad():
            return M.prefill(cfg, fwd_params, batch["tokens"], images=batch.get("images"),
                             full_kv=True)

    _lint_entry(report, pfx, f"{base} entry=prefill", mode, logits=True, sync=card)
    if cfg.vision_tokens:
        # the engine serves tokens only (as the reference's, whose prefill
        # passes no images); the model's prefill above takes the images
        report.checked.append(f"{base} entry=decode (skipped: the engine serves no "
                              f"cross-attention model)")
        return
    with torch.no_grad():
        _check_engine(cfg, params, quant, mode, base, report)


def _check_engine(cfg, params, quant, mode, base, report, mesh=None):
    """The engine's entries (decode, the decode step's logits, copy_page,
    mixed or whole prefill) of one cell, or with ``mesh`` the mesh engine's
    (decode, mixed or whole prefill) and their collectives; on the card
    also each tick's one device -> host copy."""
    dev = DEVICES[mode]
    card = mode == "cuda"
    ec = EngineConfig(quant="w8a8" if quant == "w8a8" else None, **_ENGINE)
    npp = ec.cache_spec().pages_per_seq
    with _mode(mode):
        if mesh is None:
            eng = Engine(cfg, _to(params, dev), ec, device=dev)
            runner, chunked, cfg = eng.runner, eng.sched.chunked, eng.cfg
        else:
            runner = ModelRunner(cfg, _to(params, dev), ec, dev, mesh)
            chunked = not cfg.use_mla and all(sp.mixer != "ssm" for sp in cfg.layer_specs())
    report.extend(check_aliases(runner.caches, f"{base} caches"))
    a = _decode_args(runner, npp, dev)
    shapes = param_gather_shapes(params) if mesh is not None else None

    def entry(fn, name, **kw):
        ctx = f"{base} entry={name}"
        if mesh is not None:
            mesh.trace.clear()
        _lint_entry(report, fn, ctx, mode, sync=card, **kw)
        if mesh is not None:
            report.extend(lint_collectives(mesh.trace, shapes, ctx, mesh.backend, dev))

    def dec_logits():
        with runner.on_mesh():
            return M.decode_step(cfg, runner.params, runner.caches, a["cur"][:, None],
                                 a["pos"], pages=a["pages"])

    entry(_decode_entry(runner, a, 2), "decode", caches=runner.caches)
    if mesh is None:
        entry(dec_logits, "decode_step", logits=True)
        entry(lambda: runner.copy_page(1, 2), "copy_page", caches=runner.caches)
    if chunked:
        entry(_mixed_entry(runner, cfg, a, dev), "mixed", logits=True, caches=runner.caches)
    else:
        entry(_whole_prefill_entry(runner, cfg, npp, dev), "whole_prefill", logits=True,
              caches=runner.caches)
    if card and mesh is None:  # the ticks themselves: one device -> host copy each
        B = runner.max_batch
        host = dict(cur=np.zeros(B, np.int32), pos=np.zeros(B, np.int32),
                    remaining=np.full(B, 2, np.int32), nanmask=np.zeros(B, bool))
        pages = np.zeros((B, npp), np.int32)
        temps, gens = [0.0] * B, [None] * B
        _tick_copies(report, lambda: runner.decode(
            pages, host["cur"], host["pos"], host["remaining"], host["nanmask"], temps,
            gens, 2), f"{base} tick=decode")
        if chunked:
            _tick_copies(report, lambda: runner.mixed(
                np.zeros((1, _C), np.int32), pages[:1], 0, _C, 0.0, None, False, pages,
                host["cur"], host["pos"], host["remaining"], host["nanmask"], temps, gens),
                f"{base} tick=mixed")
        else:
            _tick_copies(report, lambda: runner.whole_prefill(
                list(range(1, 9)), np.arange(npp, dtype=np.int32), 0, 0.0, None),
                f"{base} tick=whole_prefill")


def check_sharded(name: str, report: Report, params=None) -> None:
    """J007 (and the J / D rules) on the mesh engine at 1 x 2: a
    ``ModelRunner`` over a :class:`RecordingMesh` standing for rank 0 of a
    nccl mesh, on meta tensors inside a dry-run counter, its decode and its
    mixed or whole-prefill entry.  A dry mesh needs no devices, so this
    never skips."""
    cfg = analysis_config(name)
    if cfg.kind != "decoder" or cfg.vision_tokens:
        return
    mesh = RecordingMesh((1, _TP), ("data", "model"), backend="nccl")
    if cfg.num_experts and cfg.num_experts % _TP == 0:
        cfg = cfg.with_(moe_shard_map=True)  # expert-parallel, as the mesh engine holds it
    if params is None:
        params = M.init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        _check_engine(cfg, params, "none", "meta", f"config={name} mesh=1x{_TP}", report,
                      mesh=mesh)


def check_kernels(name: str, report: Report) -> None:
    """K-rule proofs for every kernel the config can reach, at the
    engine's geometry (mode- and quant-independent: the specs describe the
    kernels' grids and addresses)."""
    from repro_torch.kernels.block_gemm import gemm_spec
    from repro_torch.kernels.decode_attention import fd_dense_spec, fd_paged_spec
    from repro_torch.kernels.flash_attention import fa_dense_spec, fa_paged_spec

    cfg = analysis_config(name)
    ctx = f"config={name}"
    ec = EngineConfig(**_ENGINE)
    ps, npp, n_pages = ec.page_size, ec.cache_spec().pages_per_seq, ec.n_pages
    D, V = cfg.d_model, cfg.padded_vocab
    specs = [gemm_spec(M_, D, V, int8=q) for M_ in (_B, D) for q in (False, True)]
    mixers = {sp.mixer for sp in cfg.layer_specs()}
    dt = cfg.compute_dtype
    if any(m.startswith("attn") or m == "cross" for m in mixers):
        H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        causal = cfg.kind == "decoder"
        specs.append(fa_dense_spec(_B, H, K, _S, _S, d, causal=causal, dtype=dt))
        if cfg.window_size:
            specs.append(fa_dense_spec(_B, H, K, _S, _S, d, window=cfg.window_size // 2,
                                       dtype=dt))
        if "cross" in mixers:
            specs.append(fa_dense_spec(_B, H, K, _S, cfg.vision_tokens, d, causal=False,
                                       dtype=dt))
        if cfg.kind == "decoder" and not cfg.use_mla:
            specs.append(fa_paged_spec(_B, H, K, ps, d, ps, npp, n_pages, dtype=dt))
            specs.append(fd_dense_spec(_B, H, K, ec.max_len, d, d, layout="linear"))
            if cfg.window_size:
                specs.append(fd_dense_spec(_B, H, K, cfg.window_size, d, d, layout="ring"))
            specs.append(fd_paged_spec(_B, H, K, d, d, ps, npp, n_pages))
    if cfg.use_mla:  # the latent call: every head over one latent kv-head, v is k
        dq, dv = cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank
        specs.append(fd_paged_spec(_B, cfg.num_heads, 1, dq, dv, ps, npp, n_pages, v_row=dq))
        specs.append(fd_dense_spec(_B, cfg.num_heads, 1, ec.max_len, dq, dv, v_row=dq))
        # minicpm3-4b's full latent shape: 40 heads in 5 head groups
        specs.append(fd_paged_spec(_B, 40, 1, 288, 256, ps, npp, n_pages, v_row=288))
    for spec in specs:
        report.extend(check_kernel_spec(spec, ctx))
        report.checked.append(f"{ctx} kernel={spec.name}")


def check_paging(report: Report) -> None:
    """P001: a deterministic alloc / share / evict workload, the structural
    invariants verified at every quiescent point."""
    ctx = "paging workload"

    def verify(step: str, pool, radix=None, tables=None) -> None:
        for msg in check_invariants(pool, radix, tables):
            report.add(Finding("P001", msg, f"{ctx} step={step}"))

    pool = PagePool(12)
    radix = RadixCache(4, pool)
    verify("init", pool, radix, [])
    a = [pool.alloc() for _ in range(3)]  # request A: 3 pages, 2 full ones published
    toks_a = list(range(8))
    radix.insert(toks_a, a[:2])
    tables = [a]
    verify("insert", pool, radix, tables)
    m = radix.match(toks_a + [9, 9, 9, 9], max_match=11)  # B: A's prefix + a fresh page
    for pid in m.full_pages:
        pool.incref(pid)
    b = list(m.full_pages) + [pool.alloc()]
    tables.append(b)
    verify("match", pool, radix, tables)
    for pid in a:  # retire A: the tree keeps its pages
        pool.decref(pid)
    tables.remove(a)
    verify("retire", pool, radix, tables)
    radix.evict(pool.n_pages)
    verify("evict", pool, radix, tables)
    radix.clear()
    for pid in b:
        pool.decref(pid)
    tables.remove(b)
    verify("clear", pool, radix, tables)
    report.checked.append(ctx)


def check_resilience(report: Report, device: str = "cpu") -> None:
    """R001: every ``FinishReason`` is reachable.  A small engine on the
    reduced edge config (f32), run on ``device``, through one canonical
    scenario a finish reason -- STOP / LENGTH, deadline expiry under a
    skewed chaos clock, cancellation and the bounded queue's rejection,
    preemption under page pressure (``preemption="drop"``), NaN fault
    isolation -- reports a finding for a reason that never surfaces and
    for a resilience counter that never moves."""
    from repro_torch.serving import ChaosInjector
    from repro_torch.serving.engine import FinishReason

    ctx = "resilience scenarios"
    cfg = reduce_config(get_config("cgra-edge"))
    params = M.init(cfg, seed=0, device=device)
    ec = dict(page_size=16, max_batch=2, max_len=64, decode_chunk=2, prefix_cache=False)
    prompt = list(range(1, 9))
    counters = ("preempted", "rejected", "deadline_expired", "cancelled", "faults_isolated")
    seen: set = set()
    moved: set = set()

    def run(eng):
        res = eng.run()
        seen.update(r.finish_reason for r in res)
        moved.update(f for f in counters if getattr(eng.stats, f) > 0)
        return res

    eng = Engine(cfg, params, EngineConfig(**ec), device=device)  # LENGTH
    eng.submit(prompt, max_new=2)
    first = run(eng)[0].generated[0]
    eng = Engine(cfg, params, EngineConfig(eos_id=first, **ec), device=device)  # STOP
    eng.submit(prompt, max_new=4)
    run(eng)
    chaos = ChaosInjector(schedule={"clock.skew": {0}}, skew_s=1000.0)  # DEADLINE
    eng = Engine(cfg, params, EngineConfig(**ec), device=device, chaos=chaos)
    eng.submit(prompt, max_new=4, deadline_s=5.0)
    run(eng)
    eng = Engine(cfg, params, EngineConfig(max_queue=1, **ec), device=device)
    rid = eng.submit(prompt, max_new=4)  # CANCELLED (queued) + REJECTED (bound 1)
    eng.submit(list(prompt), max_new=4)
    eng.cancel(rid)
    run(eng)
    eng = Engine(cfg, params, EngineConfig(n_pages=4, preemption="drop", **ec),
                 device=device)  # PREEMPTED: 3 usable pages for two requests
    eng.submit(list(range(1, 17)), max_new=20)
    eng.submit(list(range(2, 18)), max_new=20)
    run(eng)
    chaos = ChaosInjector(schedule={"logits.nan": {0}})  # FAULT
    eng = Engine(cfg, params, EngineConfig(**ec), device=device, chaos=chaos)
    eng.submit(prompt, max_new=4)
    run(eng)
    for reason in FinishReason:
        if reason not in seen:
            report.add(Finding("R001", f"FinishReason.{reason.name} was never produced by "
                                       f"its canonical scenario", ctx))
    for f in counters:
        if f not in moved:
            report.add(Finding("R001", f"ServeStats.{f} never incremented across the "
                                       f"scenario suite", ctx))
    report.checked.append(ctx)


def run_analysis(configs: Optional[Sequence[str]] = None, modes: Iterable[str] = ("cuda",),
                 quants: Iterable[str] = QUANTS, disabled: Iterable[str] = (),
                 progress=None) -> Report:
    """The full matrix: every named config x mode x quant, the kernels'
    proofs and the mesh entries a config, then paging and resilience (on
    the card when ``cuda`` is among the modes, else on the CPU)."""
    modes, quants = tuple(modes), tuple(quants)
    for m in modes:
        if m not in MODES:
            raise ValueError(f"mode {m!r}: one of {MODES}")
    if "cuda" in modes and not torch.cuda.is_available():
        raise RuntimeError("mode 'cuda' needs a card; on the CPU ask for --modes plain,meta")
    report = Report(disabled=sorted(disabled))
    names = list(configs) if configs else sorted(REGISTRY)
    for name in names:
        get_config(name)  # fail fast on typos
    for name in names:
        params = M.init(analysis_config(name), seed=0, device="cpu")
        for mode in modes:
            for quant in quants:
                if progress:
                    progress(f"{name} mode={mode} quant={quant}")
                check_cell(name, mode, quant, report, params=params)
        if progress:
            progress(f"kernel bounds {name}")
        check_kernels(name, report)
        if progress:
            progress(f"mesh entries {name} 1x{_TP}")
        check_sharded(name, report)
    check_paging(report)
    if progress:
        progress("resilience scenarios")
    check_resilience(report, "cuda" if "cuda" in modes else "cpu")
    return report
