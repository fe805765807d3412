"""Mamba-2 SSD (mamba2-130m) and the jamba hybrid in the port against the
JAX package on the same weights and inputs (CPU, plain kernel versions;
the reference's SSD is plain JAX — einsums and a ``lax.scan`` — with no
Pallas kernel).

Weights come from ``repro.models.model.init`` on the reduced configs
(mamba2: 2 layers, d_model 64, 8 SSD heads of 16, state 16, chunk 32;
jamba: one period of 8 layers, attention at index 4, MoE on odd layers),
flattened as ``repro.checkpoint`` flattens them, through
``models.bridge``.  Inputs are drawn with numpy from a seed.

Tolerances (compute dtype f32 throughout):
- one SSD layer (forward, its decode state, streaming decode): max abs
  <= 1e-5, the port's layer-parity bound (the frameworks sum in different
  orders);
- whole-model logits and hidden states, float weights and w8a8: <= 1e-4,
  the model-parity bound of ``tests/test_torch_edge.py``.  Under w8a8 an
  activation within f32 rounding of an int8 rounding boundary can take the
  neighbouring step in one framework: reduced jamba's head input does so at
  one decode step here (one entry 1.5e-5 steps from the boundary; logits
  1.5e-3 apart at that step only, since the head feeds no cache).  Such a
  step passes only with the witness of ``_head_flip_witness``; the hidden
  states and caches stay within 1e-4 throughout;
- greedy engine tokens: identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.core.quant import QTensor as JQ
from repro.core.quant import quantize as j_quantize
from repro.core.quant import quantized_matmul_ref as j_qmatmul
from repro.models import model as JM
from repro.models import ssd as JS
from repro.models.params import count_params as jcount
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.core.gemm import quantize_act
from repro_torch.core.quant import QTensor
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.models import ssd as TS
from repro_torch.models.graph import DecodeGraph
from repro_torch.models.params import count_params, init_params
from repro_torch.serving import Engine, EngineConfig, check_invariants

LAYER_ATOL, MODEL_ATOL = 1e-5, 1e-4
MAMBA, JAMBA = "mamba2-130m", "jamba-v0.1-52b"
SSM_FIELDS = ("ssm_state", "ssm_expand", "ssm_headdim", "ssm_chunk",
              "ssm_conv_width", "ssm_every", "d_inner", "ssm_heads")
CONFIG_FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
                 "num_kv_heads", "head_dim", "d_ff", "vocab_size", "padded_vocab",
                 "norm_type", "tie_embeddings", "num_experts", "experts_per_token",
                 "moe_d_ff", "moe_every") + SSM_FIELDS


def _pair(name):
    jcfg = JC.reduce_config(JC.get_config(name))
    tcfg = TC.reduce_config(TC.get_config(name))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, bridge.params_from_numpy(tcfg, _flatten(params),
                                                        device="cpu")


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in (MAMBA, JAMBA)}


def _gap(name, got, want, atol):
    gap = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    print(f"{name}: max abs gap {gap:.3e} (bound {atol})")
    assert gap <= atol, (name, gap)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_reduce_config_match_jax(name, reduced):
    """Both configs and their reduced forms have the JAX package's widths,
    the SSD fields included, and the same layer list (mamba2: SSD layers
    with no FFN; jamba: attention at index 4 of each 8, MoE on odd
    layers)."""
    jc, tc = JC.get_config(name), TC.get_config(name)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
        [(s.mixer, s.ffn) for s in tc.layer_specs()]


@pytest.mark.parametrize("name,lo,hi", [(MAMBA, 0.16e9, 0.18e9),
                                        (JAMBA, 51e9, 53e9)])
def test_param_count_matches_jax(name, lo, hi):
    """The full specs (counted, never allocated here) equal JAX's: mamba2
    ~0.17 B with the 50280-entry vocabulary padded to 50432, jamba ~52 B."""
    n = count_params(TM.param_specs(TC.get_config(name)))
    assert n == jcount(JM.param_specs(JC.get_config(name)))
    assert lo < n < hi
    assert TC.get_config(MAMBA).padded_vocab == 50432


def test_ssd_init_kinds_draw_the_reference_ranges():
    """``ssm_a`` is log U[1, 16] and ``dt_bias`` the inverse softplus of
    U[1e-3, 1e-1], drawn from the generator, kept f32 under a bf16 default."""
    cfg = TC.get_config(MAMBA)
    specs = {k: v for k, v in TS.ssd_specs(cfg).items() if k in ("A_log", "dt_bias", "D_skip")}
    specs = {k: v._replace(shape=(4096,)) for k, v in specs.items()}
    p = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in p.values())
    a = torch.exp(p["A_log"])
    assert 1.0 <= float(a.min()) and float(a.max()) <= 16.0 and float(a.std()) > 3.0
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert 0.99e-3 <= float(dt.min()) and float(dt.max()) <= 1.01e-1
    assert bool((p["D_skip"] == 1).all())
    again = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(again["A_log"], p["A_log"])


def _layer(pair):
    """Layer 0's SSD weights on both sides."""
    jcfg, tcfg, params, tparams = pair
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["0"]["mixer"])
    tp = TM._unstack(tparams["stages"][0]["0"]["mixer"], 1)[0]
    return jcfg, tcfg, jp, tp


# S: a multiple of ssm_chunk (32), not a multiple (Q = 15), prime (Q = 1,
# one chunk a row), shorter than a chunk
@pytest.mark.parametrize("S", [64, 45, 37, 20])
def test_ssd_forward_matches_jax(pairs, S):
    """One SSD layer over S rows, without and with the decode state: the
    output, the final state ``h`` and the raw pre-conv tails equal JAX's."""
    jcfg, tcfg, jp, tp = _layer(pairs[MAMBA])
    x = 0.5 * np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    want, (jout, jcache) = jax.jit(lambda p, x: (
        JS.ssd_forward(jcfg, p, x), JS.ssd_forward(jcfg, p, x, return_cache=True)))(
        jp, jnp.asarray(x))
    _gap(f"ssd_forward S={S}", TS.ssd_forward(tcfg, tp, _t(x)), want, LAYER_ATOL)
    tout, tcache = TS.ssd_forward(tcfg, tp, _t(x), return_cache=True)
    _gap(f"ssd_forward S={S} with cache", tout, jout, LAYER_ATOL)
    for name in ("h", "conv_x", "conv_B", "conv_C"):
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape), name
        _gap(f"ssd_forward S={S} {name}", tcache[name], jcache[name], LAYER_ATOL)
    assert tcache["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [32, 37])
def test_ssd_decode_streams_after_prefill(pairs, S):
    """A prefill's state, then 6 decode steps on the cache tensors, which
    ``ssd_decode`` overwrites in place: every step's output and the final
    state equal JAX's."""
    jcfg, tcfg, jp, tp = _layer(pairs[MAMBA])
    rng = np.random.RandomState(100 + S)
    x = 0.5 * rng.randn(2, S, jcfg.d_model).astype(np.float32)
    _, tcache = TS.ssd_forward(tcfg, tp, _t(x), return_cache=True)
    _, jcache = jax.jit(lambda p, x: JS.ssd_forward(jcfg, p, x, return_cache=True))(
        jp, jnp.asarray(x))
    jdecode = jax.jit(lambda p, c, x: JS.ssd_decode(jcfg, p, c, x))
    tcache = {k: v.clone() for k, v in tcache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for step in range(6):
        xt = 0.5 * rng.randn(2, 1, jcfg.d_model).astype(np.float32)
        jout, jcache = jdecode(jp, jcache, jnp.asarray(xt))
        tout, tret = TS.ssd_decode(tcfg, tp, tcache, _t(xt))
        assert tret is tcache
        _gap(f"ssd_decode S={S} step {step}", tout, jout, LAYER_ATOL)
    assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs
    for name in ("h", "conv_x", "conv_B", "conv_C"):
        _gap(f"ssd_decode S={S} {name}", tcache[name], jcache[name], LAYER_ATOL)


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), TM.quantize_params(tcfg, tparams)


def test_quantize_params_keeps_the_ssd_weights_float(pairs):
    """As JAX, w8a8 quantizes only ``dense_proj`` weights: the SSD
    projections stay float; jamba's attention, dense FFN and the head
    become int8."""
    _, _, _, tq = _variant(pairs[JAMBA], "w8a8")
    group = tq["stages"][0]
    assert not any(isinstance(v, QTensor) for v in group["0"]["mixer"].values())
    assert isinstance(group["4"]["mixer"]["wq"], QTensor)
    assert isinstance(group["0"]["ffn"]["w_up"], QTensor)
    assert isinstance(tq["lm_head"], QTensor)
    _, _, _, mq = _variant(pairs[MAMBA], "w8a8")
    assert not any(isinstance(v, QTensor) for v in mq["stages"][0]["0"]["mixer"].values())


def _head_flip_witness(what, tcfg, tp, jp, tl, t_hidden, j_hidden):
    """A w8a8 step whose logits differ by more than MODEL_ATOL is accepted
    only as a rounding-boundary flip of the head's int8 activation: the
    hidden states agree within MODEL_ATOL, the two frameworks' int8 rows
    differ by one step, only at entries within 1e-3 steps of a rounding
    boundary, and the port's logits equal JAX's head applied to the port's
    int8 row (within MODEL_ATOL)."""
    _gap(f"{what} hidden", t_hidden, j_hidden, MODEL_ATOL)
    tq = quantize_act(t_hidden)
    jq = j_quantize(jnp.asarray(j_hidden).reshape(-1, tcfg.d_model), axis=0)
    diff = np.asarray(jq.q, np.int32).reshape(tq.q.shape) - tq.q.numpy().astype(np.int32)
    steps = t_hidden.numpy() / tq.scale.numpy()
    near = np.abs(np.abs(steps) - np.floor(np.abs(steps)) - 0.5)
    print(f"{what}: {int((diff != 0).sum())} head activation flips, "
          f"{float(near[diff != 0].max()) if diff.any() else 0:.2e} steps from a boundary")
    assert diff.any() and np.abs(diff).max() == 1 and near[diff != 0].max() < 1e-3
    want = j_qmatmul(JQ(jnp.asarray(tq.q.numpy()).reshape(-1, tcfg.d_model),
                        jnp.asarray(tq.scale.numpy()).reshape(-1, 1)), jp["lm_head"])
    _gap(f"{what} logits from the port's int8 row", tl, np.asarray(want).reshape(tl.shape),
         MODEL_ATOL)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_prefill_then_decode_matches_jax(pairs, name, quant):
    """Whole-model prefill(cache_len) over a 37-token (prime) prompt, then
    12 decode steps (``forward_hidden`` + ``lm_logits``, the two halves of
    ``decode_step``): hidden states and logits agree, and the caches (SSD
    state; jamba's KV).  Under w8a8 a logits gap past the bound must be a
    head activation flip (:func:`_head_flip_witness`)."""
    jcfg, tcfg, jp, tp = _variant(pairs[name], quant)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t}, cache_len=64))(
        jp, jnp.asarray(toks))
    tl, tc = TM.prefill(tcfg, tp, _t(toks), cache_len=64)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.padded_vocab)
    _gap(f"{name} {quant} prefill logits", tl, jl, MODEL_ATOL)

    @jax.jit
    def jstep(p, c, t, pos):
        hidden, _, c = JM.forward_hidden(jcfg, p, {"tokens": t}, mode="decode",
                                         caches=c, pos=pos)
        return hidden, JM.lm_logits(jcfg, p, hidden), c

    flips = 0
    for i in range(12):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full(2, 37 + i, np.int32)
        jh, jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        th, tc = TM.forward_hidden(tcfg, tp, _t(tok), mode="decode", caches=tc, pos=_t(pos))
        tl = TM.lm_logits(tcfg, tp, th)
        _gap(f"{name} {quant} decode {i} hidden", th, jh, MODEL_ATOL)
        gap = float(np.max(np.abs(tl.numpy() - np.asarray(jl))))
        if quant == "w8a8" and gap > MODEL_ATOL:
            flips += 1
            _head_flip_witness(f"{name} decode {i}", tcfg, tp, jp, tl, th, jh)
        else:
            _gap(f"{name} {quant} decode {i} logits", tl, jl, MODEL_ATOL)
    assert flips <= 1
    for ts, js in zip(tc, jc):
        for g in ts:
            for leaf in ts[g]:
                assert tuple(ts[g][leaf].shape) == tuple(js[g][leaf].shape)
                _gap(f"{name} {quant} cache {g}/{leaf}", ts[g][leaf], js[g][leaf], MODEL_ATOL)


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_ssd_has_no_chunk_step(pairs, name):
    """As in JAX, chunked prefill over a paged past refuses SSD state."""
    _, tcfg, _, tparams = pairs[name]
    caches = TM.init_paged_cache(tcfg, 1, 5, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="SSM"):
        TM.chunk_step(tcfg, tparams, caches, torch.zeros(1, 8, dtype=torch.int32),
                      torch.tensor([[1, 2]], dtype=torch.int32), 0, 8)


def _engines(pair, prompts, max_new, **kw):
    jcfg, tcfg, params, tparams = pair
    kw = dict(dict(max_len=96, page_size=16, decode_chunk=4), **kw)
    jeng = JEngine(jcfg, params, JEngineConfig(**kw))
    teng = Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    jout, jst = jeng.generate(prompts, max_new=max_new)
    tout, tst = teng.generate(prompts, max_new=max_new)
    return jout, tout, jst, tst, teng


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_engine_greedy_matches_jax(pairs, name):
    """Five requests (two prompt lengths, one prime: two whole-prefill
    compilations on the JAX side) on three slots, so that slots are
    refilled: whole-prompt prefill at admission, then decode ticks only,
    every slot's state advancing each step; greedy tokens equal JAX's and
    the pool reconciles."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, n).tolist() for n in (20, 37, 20, 37, 20)]
    jout, tout, jst, tst, eng = _engines(pairs[name], prompts, 10, max_batch=3)
    assert tout == jout
    assert eng.radix is None and tst.mixed_steps == jst.mixed_steps == 0
    assert (tst.prefills, tst.chunks, tst.tokens_out) == \
        (jst.prefills, jst.chunks, jst.tokens_out) == (5, tst.chunks, 50)
    assert check_invariants(eng.pool, eng.radix, tables=eng.sched.owned) == []
    assert eng.pool.num_free == eng.pool.n_pages - 1


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_engine_recompute_preemption_matches_jax(pairs, name):
    """``preemption="recompute"`` with 3 usable pages for two 16-token
    prompts of 20 new tokens: the victim re-prefills prompt + generated
    tokens whole into its slot's state row; every request finishes with
    JAX's tokens."""
    def run(mod_engine, mod_config, cfg, params, **dev):
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 256, 16).tolist() for _ in range(2)]
        eng = mod_engine(cfg, params, mod_config(
            max_len=64, max_batch=2, n_pages=4, page_size=16, decode_chunk=4,
            prefix_cache=False, preemption="recompute"), **dev)
        rids = [eng.submit(p, max_new=20) for p in prompts]
        res = {r.rid: r for r in eng.run()}
        return ([(res[r].finish_reason.value, res[r].generated) for r in rids],
                eng.stats.preempted, eng.stats.prefills)
    jcfg, tcfg, params, tparams = pairs[name]
    want = run(JEngine, JEngineConfig, jcfg, params)
    got = run(Engine, EngineConfig, tcfg, tparams, device="cpu")
    assert got == want
    assert got[1] >= 1 and got[2] == 2 + got[1]
    assert all(reason == "length" for reason, _ in got[0])


def test_prefix_cache_auto_disabled_for_ssm(pairs):
    """SSM prefill is not prefix-decomposable: the engine refuses to
    radix-share even when the config asks for it (JAX's
    ``test_prefix_cache_auto_disabled_for_ssm``), and still serves."""
    _, tcfg, _, tparams = pairs[MAMBA]
    eng = Engine(tcfg, tparams, EngineConfig(max_len=96, page_size=16, decode_chunk=4,
                                             max_batch=2, prefix_cache=True), device="cpu")
    assert eng.radix is None
    p = [ord(c) % tcfg.vocab_size for c in "state space"]
    out, _ = eng.generate([p], max_new=4)
    assert len(out[0]) == len(p) + 4


def test_short_prompt_is_refused_by_both(pairs):
    """A 2-token mamba2 prompt has no full conv tail (W - 1 = 3 rows): the
    JAX engine fails to write its short tail into the cache, and the port
    refuses it at the prefill; both raise."""
    jcfg, tcfg, params, tparams = pairs[MAMBA]
    kw = dict(max_len=96, page_size=16, decode_chunk=4, max_batch=2)
    with pytest.raises(ValueError):
        JEngine(jcfg, params, JEngineConfig(**kw)).generate([[5, 6]], max_new=4)
    with pytest.raises(ValueError, match="conv tail"):
        Engine(tcfg, tparams, EngineConfig(**kw), device="cpu").generate([[5, 6]], max_new=4)


# ---------------------------------------------------------------------------
# Cache leaves without a kv_seq axis (the repairs SSD needed)
# ---------------------------------------------------------------------------

def _filled_engine(pair, seed):
    """A reduced engine whose every cache leaf holds random values."""
    _, tcfg, _, tparams = pair
    eng = Engine(tcfg, tparams, EngineConfig(max_len=64, page_size=16, max_batch=4,
                                             decode_chunk=4), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _, leaf in TM.cache_leaves(eng.runner.specs, eng.runner.caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return eng


def _by_kind(eng):
    kv = [leaf.clone() for spec, leaf in TM.cache_leaves(eng.runner.specs, eng.runner.caches)
          if "kv_seq" in spec.axes]
    state = [leaf.clone() for spec, leaf in TM.cache_leaves(eng.runner.specs, eng.runner.caches)
             if "kv_seq" not in spec.axes]
    return kv, state


def test_paged_specs_keep_state_slot_indexed(pairs):
    """Only ``kv_seq`` leaves become page pools: jamba's attention k/v are
    [R, n_pages, page_size, K, dh]; SSD state is [R, max_batch, ...]."""
    _, tcfg, _, _ = pairs[JAMBA]
    group = TM.init_paged_cache(tcfg, 3, 9, 16, device="cpu")[0]
    assert tuple(group["4"]["k"].shape) == (1, 9, 16, 2, 16)
    assert tuple(group["0"]["h"].shape) == (1, 3, 8, 16, 16)
    assert tuple(group["0"]["conv_x"].shape) == (1, 3, 3, 8, 16)
    assert group["0"]["h"].dtype == torch.float32


def test_copy_page_leaves_state_untouched(pairs):
    """The copy-on-write page copy copies only ``kv_seq`` pools: every SSD
    state leaf is bit-equal before and after."""
    eng = _filled_engine(pairs[JAMBA], 1)
    kv0, state0 = _by_kind(eng)
    eng.runner.copy_page(2, 5)
    kv1, state1 = _by_kind(eng)
    assert all(torch.equal(a, b) for a, b in zip(state0, state1))
    for a, b in zip(kv0, kv1):
        assert torch.equal(b[:, 5], a[:, 2]) and torch.equal(b[:, 2], a[:, 2])


def test_pad_cache_len_leaves_state_as_is(pairs):
    """``prefill(cache_len=...)`` pads only ``kv_seq`` axes, as JAX's
    ``pad_cache_len``: the SSD state is returned as it is, its head axis
    and its conv-tail axis are no row axes.  A conv tail shorter than W - 1
    rows (what the reference's prefill keeps of a 2-token prompt) is not
    zero-padded into a full one either."""
    _, tcfg, _, tparams = pairs[JAMBA]
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (2, 20)).astype(np.int32))
    _, small = TM.prefill(tcfg, tparams, toks)
    for stage in small:
        for layer in stage.values():
            if "conv_x" in layer:
                layer["conv_x"] = layer["conv_x"][:, :, 1:]  # a 2-row tail
    padded = TM.pad_cache_len(tcfg, small, 48)
    for spec, a, b in TM.cache_leaves(TM.cache_specs(tcfg, 1, 48), small, padded):
        if "kv_seq" in spec.axes:
            assert b.shape[2] == 48 and torch.equal(b[:, :, :20], a)
            assert not bool(b[:, :, 20:].any())
        else:
            assert b is a


def test_scatter_new_writes_state_to_the_slot_row_only(pairs):
    """A whole prefill into slot 2: its state leaves land in row 2, every
    other row is bit-equal before and after, and its KV rows go to the
    table's pages."""
    eng = _filled_engine(pairs[JAMBA], 2)
    runner = eng.runner
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (1, 20)).astype(np.int32))
    _, small = TM.prefill(runner.cfg, runner.params, toks)
    before = [leaf.clone() for _, leaf in TM.cache_leaves(runner.specs, runner.caches)]
    table = torch.tensor([7, 3, 0, 0], dtype=torch.int32)
    runner._scatter_new(small, table, 2, 20)
    for (spec, leaf, new), old in zip(TM.cache_leaves(runner.specs, runner.caches, small),
                                      before):
        if "kv_seq" in spec.axes:
            assert torch.equal(leaf[:, 7], new[:, 0, :16])
            assert torch.equal(leaf[:, 3, :4], new[:, 0, 16:])
            assert torch.equal(leaf[:, 3, 4:], old[:, 3, 4:])
        else:
            assert torch.equal(leaf[:, 2], new[:, 0])
            others = [0, 1, 3]
            assert torch.equal(leaf[:, others], old[:, others])


def test_decode_graph_lists_the_state_leaves(pairs):
    """``DecodeGraph.state`` holds exactly the slot-indexed state leaves it
    saves around its warm-up (SSD layers' four a layer; none for
    attention)."""
    eng = _filled_engine(pairs[JAMBA], 3)
    g = eng.runner.graph
    state = [leaf for spec, leaf in TM.cache_leaves(eng.runner.specs, eng.runner.caches)
             if "kv_seq" not in spec.axes]
    assert len(g.state) == 4 * 7 and all(a is b for a, b in zip(g.state, state))
    _, tcfg, _, tparams = pairs[MAMBA]
    caches = TM.init_cache(tcfg, 2, 16, device="cpu")
    assert len(DecodeGraph(tcfg, tparams, caches, 2).state) == 4
