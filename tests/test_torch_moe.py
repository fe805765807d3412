"""The capacity-routed MoE FFN (qwen3-moe-30b-a3b) in the port against the
JAX package on the same weights and inputs (CPU, plain kernel versions; the
reference's experts are ``jnp.einsum``s, no Pallas kernel).

Weights come from ``repro.models.model.init`` on the reduced qwen3-moe
(4 experts, top-2, expert width 32, d_model 64, 4 heads over 2 kv-heads
with qk-norm), flattened as ``repro.checkpoint`` flattens them, through
``models.bridge``.

Tolerances (compute dtype f32 throughout):
- one MoE layer: max abs <= 1e-5, the port's layer-parity bound (the
  frameworks sum in different orders; gaps are ~1e-7); top-k indices and
  kept masks equal; ``aux`` within 1e-6.  No input has a tie between the
  k-th and (k+1)-th probability within 1e-6 (asserted), where
  ``torch.topk`` and ``lax.top_k`` may choose differently;
- whole-model logits, float weights and w8a8: <= 1e-4, the model-parity
  bound of ``tests/test_torch_edge.py``;
- int8 weights and scales: bit-identical; greedy engine tokens: identical.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.core.quant import QTensor as JQ
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import count_params as jcount
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.core.quant import QTensor
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models.params import (ParamSpec, count_params, init_params,
                                       tree_map_specs)
from repro_torch.serving import Engine, EngineConfig, check_invariants

LAYER_ATOL, MODEL_ATOL, AUX_ATOL, TIE_GAP = 1e-5, 1e-4, 1e-6, 1e-6
NAME = "qwen3-moe-30b-a3b"
MOE_FIELDS = ("num_experts", "experts_per_token", "moe_d_ff", "moe_every",
              "capacity_factor", "num_moe_groups")
CONFIG_FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
                 "num_kv_heads", "head_dim", "d_ff", "vocab_size", "padded_vocab",
                 "padded_heads", "norm_type", "rope_theta", "use_qk_norm",
                 "tie_embeddings") + MOE_FIELDS


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.reduce_config(JC.get_config(NAME))
    tcfg = TC.reduce_config(TC.get_config(NAME))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, bridge.params_from_numpy(
        tcfg, _flatten(params), device="cpu")


def _gap(name, got, want, atol):
    gap = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    print(f"{name}: max abs gap {gap:.3e} (bound {atol})")
    assert gap <= atol, (name, gap)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_reduce_config_match_jax(reduced):
    """qwen3-moe-30b-a3b and its reduced form have the JAX package's widths,
    the MoE fields included, field by field, and the same layer list."""
    jc, tc = JC.get_config(NAME), TC.get_config(NAME)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert str(jnp.dtype(jc.compute_dtype)) == str(tc.compute_dtype)[6:]
    assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
        [(s.mixer, s.ffn) for s in tc.layer_specs()]
    assert {s.ffn for s in tc.layer_specs()} == {"moe"}


def test_qwen3_moe_param_count():
    """The full spec (counted, never allocated here): ~30.5 B parameters,
    as JAX's, with the 151936-entry vocabulary padded to 152064 and the
    router f32."""
    cfg = TC.get_config(NAME)
    specs = TM.param_specs(cfg)
    n = count_params(specs)
    assert n == jcount(JM.param_specs(JC.get_config(NAME)))
    assert 30.4e9 < n < 30.6e9
    assert cfg.padded_vocab == 152064
    ffn = specs["stages"][0]["0"]["ffn"]
    assert ffn["router"].shape == (48, 2048, 128) and ffn["router"].dtype == torch.float32
    assert ffn["w_down"].shape == (48, 128, 768, 2048) and ffn["w_gate"].dtype is None


def _ffn(pair):
    """Layer 0's MoE weights on both sides."""
    jcfg, tcfg, params, tparams = pair
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["0"]["ffn"])
    tp = TM._unstack(tparams["stages"][0]["0"]["ffn"], 1)[0]
    return jcfg, tcfg, jp, tp


def _jax_routing(jcfg, jp, x):
    """The reference's routing, computed with the lines of
    ``repro.models.layers.moe_forward``: (probs [G,T,E], top-k indices
    [G,T,k], kept mask [G,T,k])."""
    B, S, D = x.shape
    E, k = jcfg.num_experts, jcfg.experts_per_token
    G = max(1, min(jcfg.num_moe_groups, B * S))
    T = B * S // G
    xt = jnp.asarray(x).reshape(G, T, D)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                                      jp["router"].astype(jnp.float32)), -1)
    _, topi = lax.top_k(probs, k)
    ohp = jax.nn.one_hot(topi.transpose(0, 2, 1).reshape(G, k * T), E, dtype=jnp.int32)
    pos = ((jnp.cumsum(ohp, 1) - ohp) * ohp).sum(-1).reshape(G, k, T).transpose(0, 2, 1)
    return np.asarray(probs), np.asarray(topi), np.asarray(pos < JL.moe_capacity(jcfg, T))


def _no_tie(probs, k):
    s = np.sort(probs, -1)[..., ::-1]
    gap = float(np.min(s[..., k - 1] - s[..., k]))
    assert gap > TIE_GAP, f"k-th / (k+1)-th probability tie: gap {gap:.3e}"


@pytest.mark.parametrize("groups,capacity_factor",
                         [(1, 1.0), (2, 1.0), (4, 1.0), (1, 0.25), (2, 0.25)])
def test_moe_forward_matches_jax(pair, groups, capacity_factor):
    """One MoE layer on x [2, 12, 64] (24 tokens) in 1, 2 or 4 dispatch
    groups: the output within 1e-5 of JAX's, ``aux`` within 1e-6, top-k
    indices and kept masks equal.  At capacity factor 0.25 (C = 4 slots for
    ~6-12 choices an expert) choices are dropped, as many on both sides."""
    jcfg, tcfg, jp, tp = _ffn(pair)
    jcfg = jcfg.with_(num_moe_groups=groups, capacity_factor=capacity_factor)
    tcfg = tcfg.with_(num_moe_groups=groups, capacity_factor=capacity_factor)
    x = np.random.RandomState(groups).randn(2, 12, jcfg.d_model).astype(np.float32)
    jout, jaux = JL.moe_forward(jcfg, jp, jnp.asarray(x))
    tout, route = TL.moe_forward(tcfg, tp, _t(x))
    assert tout.shape == (2, 12, jcfg.d_model) and tout.dtype == torch.float32
    _gap(f"moe_forward G={groups} cf={capacity_factor}", tout, jout, LAYER_ATOL)
    taux = TL.moe_aux(tcfg, route)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL, (float(taux), float(jaux))
    probs, jtopi, jkept = _jax_routing(jcfg, jp, x)
    _no_tie(probs, jcfg.experts_per_token)
    np.testing.assert_array_equal(route.topi.numpy(), jtopi)
    np.testing.assert_array_equal(route.kept.numpy(), jkept)
    dropped = int((~route.kept).sum())
    assert dropped == int((~jkept).sum())
    if capacity_factor < 1:
        assert route.C == 4 and dropped > 0
    print(f"G={groups} cf={capacity_factor}: C={route.C}, {dropped} of "
          f"{route.kept.numel()} choices dropped")


@pytest.mark.parametrize("s", [2, 4])
def test_group_split_over_ranks_places_every_choice_as_the_whole_group(pair, s):
    """One dispatch group of 48 tokens cut into ``s`` consecutive slices, as
    a group spans ``s`` batch ranks: each slice routed alone, handed every
    slice's per-priority counts (``GroupSpan``), gives each of its choices
    the slot and kept mask of ``moe_route`` on the whole group (and of the
    reference's routing), and the group's capacity, at a capacity factor
    of 0.5 that drops choices."""
    jcfg, tcfg, jp, tp = _ffn(pair)
    jcfg, tcfg = (c.with_(capacity_factor=0.5) for c in (jcfg, tcfg))
    E, T = tcfg.num_experts, 48
    x = np.random.RandomState(40 + s).randn(1, T, tcfg.d_model).astype(np.float32)
    whole = TL.moe_route(tcfg, tp, _t(x))
    probs, jtopi, jkept = _jax_routing(jcfg, jp, x)
    _no_tie(probs, tcfg.experts_per_token)
    np.testing.assert_array_equal(whole.kept.numpy(), jkept)
    slices = _t(x).chunk(s, 1)
    counts = []  # each slice's [k, E], as it hands them to the gather
    for xs in slices:
        TL.moe_route(tcfg, tp, xs, TL.GroupSpan(1, 0, lambda c: counts.append(c) or c[None]))
    assert counts[0].dtype == torch.int32 and counts[0].shape == (tcfg.experts_per_token, E)
    assert sum(int(c.sum()) for c in counts) == T * tcfg.experts_per_token
    n = T // s
    for j, xs in enumerate(slices):
        def gather(c, j=j):  # what the ranks' all-gather hands slice j
            assert torch.equal(c, counts[j])
            return torch.stack(counts)
        r = TL.moe_route(tcfg, tp, xs, TL.GroupSpan(s, j, gather))
        assert r.C == whole.C == TL.moe_capacity(tcfg, T)
        np.testing.assert_array_equal(r.pos.numpy(), whole.pos[:, j * n:(j + 1) * n].numpy())
        np.testing.assert_array_equal(r.kept.numpy(), jkept[:, j * n:(j + 1) * n])
    assert int((~whole.kept).sum()) > 0


def test_ffn_cut_down_product_is_f32_of_bf16_operands():
    """The FFN cut's down product (``layers._BmmF32``): bf16 operands, an
    f32 result and f32 gradients cast back to bf16, equal to autograd
    through ``bmm`` of the operands cast to f32 (what the CPU runs, and
    what the reference's ``preferred_element_type=F32`` einsum computes);
    on meta (the dry run) the f32 result and the product's FLOPs counted
    without an f32 copy of either operand."""
    from repro_torch.launch.dry_costs import DryCounter
    rs = np.random.RandomState(3)
    a0, b0, g = (torch.from_numpy(rs.randn(*sh).astype(np.float32))
                 for sh in ((4, 6, 8), (4, 8, 5), (4, 6, 5)))
    a, b = (t.to(torch.bfloat16).requires_grad_() for t in (a0, b0))
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    y = TL._BmmF32.apply(a, b)
    want = torch.bmm(a2.float(), b2.float())
    assert y.dtype == torch.float32 and torch.equal(y, want)
    y.backward(g)
    want.backward(g)
    for got, ref in ((a.grad, a2.grad), (b.grad, b2.grad)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    am, bm = (torch.empty(t.shape, dtype=torch.bfloat16, device="meta", requires_grad=True)
              for t in (a0, b0))
    with DryCounter() as c:
        ym = TL._BmmF32.apply(am, bm)
    assert ym.dtype == torch.float32 and ym.is_meta
    assert c.flops == 2 * 4 * 6 * 8 * 5


def test_moe_capacity_matches_jax(pair):
    """``moe_capacity`` at the engine's token counts (decode batches, chunk
    buffers, prefills) of the reduced and the full config."""
    jcfg, tcfg = pair[0], pair[1]
    for jc, tc in ((jcfg, tcfg), (JC.get_config(NAME), TC.get_config(NAME))):
        for T in (1, 3, 8, 16, 64, 100, 600, 4096):
            assert TL.moe_capacity(tc, T) == JL.moe_capacity(jc, T)
    full = TC.get_config(NAME)
    assert [TL.moe_capacity(full, T) for T in (8, 64, 600)] == [4, 4, 40]


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), TM.quantize_params(tcfg, tparams)


def test_quantize_params_keeps_the_experts_and_router_float(pair):
    """w8a8 quantizes the attention projections and the head bit for bit as
    JAX does; the router and the experts stay float, as the same tensors
    (no copy of the expert weights)."""
    jcfg, tcfg, jq, tq = _variant(pair, "w8a8")
    tparams = pair[3]
    for si, (sj, st) in enumerate(zip(jq["stages"], tq["stages"])):
        for name, w in st["0"]["ffn"].items():
            assert not isinstance(w, QTensor) and not isinstance(sj["0"]["ffn"][name], JQ)
            assert w is tparams["stages"][si]["0"]["ffn"][name]
        for name in ("wq", "wk", "wv", "wo"):
            jw, tw = sj["0"]["mixer"][name], st["0"]["mixer"][name]
            assert isinstance(tw, QTensor) and isinstance(jw, JQ)
            q = np.asarray(jw.q)  # [R, D, heads, dh], wo [R, H, dh, D]
            K = int(np.prod(q.shape[1:-1])) if name == "wo" else q.shape[1]
            np.testing.assert_array_equal(
                tw.q.numpy(), np.swapaxes(q.reshape(q.shape[0], K, -1), -1, -2))
            np.testing.assert_array_equal(tw.scale.numpy().ravel(),
                                          np.asarray(jw.scale).ravel())
    np.testing.assert_array_equal(tq["lm_head"].q.numpy(), np.asarray(jq["lm_head"].q).T)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_prefill_then_decode_matches_jax(pair, quant):
    """Whole-model prefill(cache_len) over two 20-token prompts (T = 40
    tokens a MoE call), then 8 decode_steps (T = 2) on the slot caches:
    logits agree."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=40)
    tl, tc = TM.prefill(tcfg, tp, _t(toks), cache_len=40)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.padded_vocab)
    _gap(f"{quant} prefill logits", tl, jl, MODEL_ATOL)
    jdecode = jax.jit(lambda p, c, tok, pos: JM.decode_step(jcfg, p, c, tok, pos))
    for i in range(8):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(20 + i))
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(tok), 20 + i)
        _gap(f"{quant} decode {i} logits", tl, jl, MODEL_ATOL)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_chunk_then_paged_decode_matches_jax(pair, quant):
    """Two 16-row chunks of a prompt (the second a partial buffer: its zero
    tail takes capacity, as in the reference), then 6 paged decode steps
    over 3 slots (one frozen on the trash page): logits agree."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    ps, P, B, C = 8, 13, 3, 16
    jc = JM.init_paged_cache(jcfg, B, P, ps)
    tc = TM.init_paged_cache(tcfg, B, P, ps, device="cpu")
    rng = np.random.RandomState(5)
    pages = np.array([[3, 1, 7, 5], [2, 9, 4, 8], [10, 6, 11, 12]], np.int32)
    V = jcfg.vocab_size
    jchunk = jax.jit(lambda p, c, tok, pg, past, n: JM.chunk_step(jcfg, p, c, tok, pg,
                                                                   past, n))
    jdecode = jax.jit(lambda p, c, tok, pos, pg: JM.decode_step(jcfg, p, c, tok, pos,
                                                                pages=pg))
    for past, n in ((0, 16), (16, 9)):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = rng.randint(0, V, n)
        jl, jc = jchunk(jp, jc, jnp.asarray(toks), jnp.asarray(pages[:1]),
                        jnp.int32(past), jnp.int32(n))
        tl, tc = TM.chunk_step(tcfg, tp, tc, _t(toks), _t(pages[:1]), past, n)
        _gap(f"{quant} chunk {past}+{n} logits", tl, jl, MODEL_ATOL)
    dpages = pages.copy()
    dpages[2] = 0
    for i in range(6):
        pos = np.array([25 + i, i, 0], np.int32)
        tok = rng.randint(0, V, (B, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(dpages))
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(tok), _t(pos), pages=_t(dpages))
        _gap(f"{quant} paged decode {i} logits", tl, jl, MODEL_ATOL)


def test_engine_greedy_matches_jax(pair):
    """Four requests on three slots in 16-token chunks, two sharing a
    40-token prefix (radix hit: 2 full pages and an 8-row copy-on-write
    share): greedy tokens equal JAX's, and the pool reconciles."""
    jcfg, tcfg, params, tparams = pair
    rng = np.random.RandomState(6)
    prefix = rng.randint(3, 256, 40).tolist()
    prompts = [prefix + [1] * 8, rng.randint(1, 256, 5).tolist(),
               prefix + [2] * 6, rng.randint(1, 256, 30).tolist()]
    kw = dict(max_batch=3, max_len=96, page_size=16, chunk_tokens=16, decode_chunk=4)
    jout, jst = JEngine(jcfg, params, JEngineConfig(**kw)).generate(prompts, max_new=8)
    eng = Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    tout, tst = eng.generate(prompts, max_new=8)
    assert tout == jout
    assert tst.prefix_hit_tokens == jst.prefix_hit_tokens == 40
    assert tst.mixed_steps == jst.mixed_steps > 0
    assert check_invariants(eng.pool, eng.radix, tables=eng.sched.owned) == []


def test_engine_recompute_preemption_matches_jax(pair):
    """``preemption="recompute"`` with 3 usable pages for two 16-token
    prompts of 20 new tokens: the victim re-prefills prompt + generated
    tokens in chunks; every request finishes with JAX's tokens."""
    def run(mod_engine, mod_config, cfg, params, **dev):
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 256, 16).tolist() for _ in range(2)]
        eng = mod_engine(cfg, params, mod_config(
            max_len=64, max_batch=2, n_pages=4, page_size=16, chunk_tokens=16,
            decode_chunk=4, prefix_cache=False, preemption="recompute"), **dev)
        rids = [eng.submit(p, max_new=20) for p in prompts]
        res = {r.rid: r for r in eng.run()}
        return ([(res[r].finish_reason.value, res[r].generated) for r in rids],
                eng.stats.preempted, eng.stats.prefills)
    jcfg, tcfg, params, tparams = pair
    want = run(JEngine, JEngineConfig, jcfg, params)
    got = run(Engine, EngineConfig, tcfg, tparams, device="cpu")
    assert got == want
    assert got[1] >= 1 and got[2] == 2 + got[1]
    assert all(reason == "length" for reason, _ in got[0])


def test_bridge_keeps_the_router_f32():
    """Under a bf16 compute dtype the bridge stores every leaf in bf16 but
    the router, whose spec names f32 (the reference's own dtype for it)."""
    jcfg = JC.reduce_config(JC.get_config(NAME))
    tcfg = TC.reduce_config(TC.get_config(NAME)).with_(compute_dtype=torch.bfloat16)
    flat = _flatten(JM.init(jcfg, jax.random.PRNGKey(1)))
    p = bridge.params_from_numpy(tcfg, flat, device="cpu")
    ffn = p["stages"][0]["0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(flat["stages/0/0/ffn/router"]))
    assert ffn["w_gate"].dtype == p["embed"].dtype == torch.bfloat16
    init = TM.init(tcfg, seed=0, device="cpu")["stages"][0]["0"]["ffn"]
    assert init["router"].dtype == torch.float32 and init["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("init", ["scaled", "normal"])
def test_sliced_draw_keeps_shape_dtype_and_std(init, monkeypatch):
    """A leaf over ``MAX_DRAW`` elements (lowered here to 4500: slices of 2
    rows) is drawn in slices along its leading axis into a bf16 tensor: its
    shape and dtype, and the whole leaf's std (``scaled``: 1/sqrt(fan_in)
    over all dims but the last, the stacked axis included; ``normal``:
    0.02), within 3 %."""
    spec = {"w": ParamSpec((6, 50, 40), (None, None, None), init)}
    whole = init_params(spec, torch.Generator().manual_seed(0), torch.bfloat16)["w"]
    monkeypatch.setattr(TP, "MAX_DRAW", 4500)
    sliced = init_params(spec, torch.Generator().manual_seed(0), torch.bfloat16)["w"]
    assert sliced.shape == whole.shape == (6, 50, 40)
    assert sliced.dtype == torch.bfloat16
    want = 0.02 if init == "normal" else 1 / math.sqrt(6 * 50)
    got = float(sliced.float().std())
    assert abs(got / want - 1) < 0.03, (got, want)
    assert abs(float(whole.float().std()) / want - 1) < 0.03


def test_leaves_under_the_threshold_draw_as_before():
    """Every leaf of full olmo-1b, gemma3-4b and minicpm3-4b is under the
    threshold (their seeded weights do not move), and every leaf of the
    reduced models is one f32 draw scaled once, as before slicing existed:
    the same bits from the same seed."""
    for name in ("olmo-1b", "gemma3-4b", "minicpm3-4b"):
        sizes = []
        tree_map_specs(lambda s: sizes.append(math.prod(s.shape)),
                       TM.param_specs(TC.get_config(name)))
        assert max(sizes) <= TP.MAX_DRAW, name

    def before(spec, gen, dtype):
        shape = tuple(spec.shape)
        dtype = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(shape, dtype=dtype)
        if spec.init == "ones":
            return torch.ones(shape, dtype=dtype)
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        if spec.init == "normal":
            return (0.02 * x).to(dtype)
        return (x * (1.0 / math.sqrt(max(1, math.prod(shape[:-1]))))).to(dtype)

    def walk(t, gen, dtype):
        if isinstance(t, ParamSpec):
            return before(t, gen, dtype)
        if isinstance(t, dict):
            return {k: walk(t[k], gen, dtype) for k in sorted(t)}
        return [walk(v, gen, dtype) for v in t]

    for name in ("olmo-1b", "minicpm3-4b", NAME):
        cfg = TC.reduce_config(TC.get_config(name)).with_(compute_dtype=torch.bfloat16)
        got = TM.init(cfg, seed=7, device="cpu")
        want = walk(TM.param_specs(cfg), torch.Generator().manual_seed(7), torch.bfloat16)
        flat_g = _flatten(jax.tree.map(lambda t: t.float().numpy(), got))
        flat_w = _flatten(jax.tree.map(lambda t: t.float().numpy(), want))
        assert flat_g.keys() == flat_w.keys()
        for k in flat_g:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# kimi-k2: the same MoE layer at 384 experts top-8 (registered in the port)
# ---------------------------------------------------------------------------

KIMI = "kimi-k2-1t-a32b"


@pytest.mark.parametrize("reduced", [False, True])
def test_kimi_k2_config_matches_jax(reduced):
    """kimi-k2 is registered; its full and reduced configs have the JAX
    package's widths field by field, every layer a MoE layer; the full
    tree (counted, never allocated) has JAX's 1.042 T parameters, shape for
    shape."""
    jc, tc = JC.get_config(KIMI), TC.get_config(KIMI)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert {s.ffn for s in tc.layer_specs()} == {"moe"}
    jleaves = jax.tree_util.tree_flatten_with_path(
        JM.param_specs(jc), is_leaf=lambda x: hasattr(x, "init"))[0]
    jshapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
               tuple(spec.shape) for path, spec in jleaves}
    tshapes = {}

    def walk(t, path):
        if isinstance(t, ParamSpec):
            tshapes["/".join(path)] = tuple(t.shape)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        else:
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
    walk(TM.param_specs(tc), [])
    assert tshapes == jshapes
    n = count_params(TM.param_specs(tc))
    assert n == jcount(JM.param_specs(jc))
    if not reduced:
        assert 1.04e12 < n < 1.05e12


@pytest.fixture(scope="module")
def kimi_pair():
    jcfg = JC.reduce_config(JC.get_config(KIMI))
    tcfg = TC.reduce_config(TC.get_config(KIMI))
    params = JM.init(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, params, bridge.params_from_numpy(tcfg, _flatten(params), device="cpu")


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_kimi_k2_prefill_then_decode_matches_jax(kimi_pair, quant):
    """Reduced kimi-k2 (2 MoE layers, 4 experts top-2): prefill(cache_len)
    over two 20-token prompts, then 6 decode steps: logits within 1e-4 of
    JAX's, as for qwen3-moe."""
    jcfg, tcfg, jp, tp = _variant(kimi_pair, quant)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tc = TM.prefill(tcfg, tp, _t(toks), cache_len=32)
    _gap(f"kimi {quant} prefill logits", tl, jl, MODEL_ATOL)
    jdecode = jax.jit(lambda p, c, tok, pos: JM.decode_step(jcfg, p, c, tok, pos))
    for i in range(6):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(20 + i))
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(tok), 20 + i)
        _gap(f"kimi {quant} decode {i} logits", tl, jl, MODEL_ATOL)
