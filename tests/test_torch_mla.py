"""Multi-head latent attention (MLA, minicpm3-4b) in the port against the
JAX package on the same weights and inputs (CPU, plain kernel versions;
JAX in reference mode, its decode also through the interpret-mode Pallas
flash-decode).

Weights come from ``repro.models.model.init`` on the reduced minicpm3-4b
(kv_lora_rank 16, qk_rope 8, qk_nope 8, v_head 16, 4 heads), flattened as
``repro.checkpoint`` flattens them, through ``models.bridge``.

Tolerances (compute dtype f32 throughout):
- one MLA layer (prefill, slot and paged decode) and the plain flash-decode
  at the full latent shape: max abs <= 1e-5, the port's kernel-parity bound
  (the frameworks sum in different orders; gaps are ~1e-7);
- whole-model logits, float weights and w8a8: <= 1e-4, the model-parity
  bound of ``tests/test_torch_edge.py`` (the same rule for w8a8: no int8
  activation sits within f32 rounding of a rounding boundary here);
- int8 weights and scales: bit-identical; greedy engine tokens: identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.core.quant import QTensor as JQ
from repro.kernels.decode_attention import flash_decode as j_flash_decode
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import count_params as jcount
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.core.quant import QTensor
from repro_torch.kernels.decode_attention import decode_scratch, head_groups
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import count_params
from repro_torch.serving import Engine, EngineConfig, check_invariants

LAYER_ATOL, MODEL_ATOL = 1e-5, 1e-4
NAME = "minicpm3-4b"
MLA_FIELDS = ("use_mla", "q_lora_rank", "kv_lora_rank", "qk_nope_dim",
              "qk_rope_dim", "v_head_dim")
CONFIG_FIELDS = ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
                 "head_dim", "d_ff", "vocab_size", "padded_vocab", "padded_heads",
                 "norm_type", "rope_theta", "tie_embeddings") + MLA_FIELDS


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
    """minicpm3-4b and its reduced form have the JAX package's widths, MLA
    ranks included, field by field."""
    jc, tc = JC.get_config(NAME), TC.get_config(NAME)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert str(jnp.dtype(jc.compute_dtype)) == str(tc.compute_dtype)[6:]
    assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
        [(s.mixer, s.ffn) for s in tc.layer_specs()]


def test_minicpm3_4b_param_count():
    """The full spec (counted, never allocated here): ~4.3 B parameters, as
    JAX's, with the 73448-entry vocabulary padded to 73472."""
    cfg = TC.get_config(NAME)
    n = count_params(TM.param_specs(cfg))
    assert n == jcount(JM.param_specs(JC.get_config(NAME)))
    assert 4.2e9 < n < 4.4e9
    assert cfg.padded_vocab == 73472


def _layer(pair):
    """Layer 0's MLA weights on both sides."""
    jcfg, tcfg, params, tparams = pair
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["0"]["mixer"])
    tp = TM._unstack(tparams["stages"][0]["0"]["mixer"], 1)[0]
    return jcfg, tcfg, jp, tp


def test_mla_forward_and_prefill_match_jax(pair):
    """One MLA layer over a 20-token prompt: the output and the fused
    [latent | k_rope] cache equal JAX's."""
    jcfg, tcfg, jp, tp = _layer(pair)
    x = np.random.RandomState(1).randn(2, 20, jcfg.d_model).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)
    rows = TL.StepRows(_t(pos), None)
    _gap("mla_forward", TL.mla_forward(tcfg, tp, _t(x), rows),
         JL.mla_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos)), LAYER_ATOL)
    tout, tcache = TL.mla_prefill(tcfg, tp, _t(x), rows)
    jout, jcache = JL.mla_prefill(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    assert tuple(tcache["kv"].shape) == (2, 20, jcfg.kv_lora_rank + jcfg.qk_rope_dim)
    _gap("mla_prefill out", tout, jout, LAYER_ATOL)
    _gap("mla_prefill kv", tcache["kv"], jcache["kv"], LAYER_ATOL)


@pytest.mark.parametrize("mode", ["reference", "interpret"])
@pytest.mark.parametrize("paged", [False, True])
def test_mla_decode_matches_jax(pair, paged, mode):
    """Three absorbed decode steps of one layer, per-slot positions (slot 1
    ahead of slot 0, slot 2 at row 0): the output and the updated cache
    (slot cache [B, S, kvr+dr] or pool [P, ps, kvr+dr] through the page
    table) equal JAX's, in reference mode and through the interpret-mode
    Pallas flash-decode."""
    jcfg, tcfg, jp, tp = _layer(pair)
    jcfg = jcfg.with_(kernel_mode=mode)
    rng = np.random.RandomState(2)
    B, S, D = 3, 32, jcfg.kv_lora_rank + jcfg.qk_rope_dim
    ps, P = 8, 14
    if paged:
        pages = np.array([[3, 1, 7, 5], [2, 9, 4, 8], [10, 6, 11, 12]], np.int32)
        pool = TM.init_paged_cache(tcfg, B, P, ps, device="cpu")[0]["0"]["kv"][0]
        assert tuple(pool.shape) == (P, ps, D)
        tcache = {"kv": pool.copy_(_t(rng.randn(P, ps, D).astype(np.float32)))}
        tpages = _t(pages)
    else:
        pages, tpages = None, None
        tcache = {"kv": _t(rng.randn(B, S, D).astype(np.float32))}
    jcache = {"kv": jnp.asarray(tcache["kv"].numpy().copy())}
    for step in range(3):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        pos = np.array([10 + step, 17 + step, step], np.int32)
        jout, jcache = JL.mla_decode(jcfg, jp, jcache, jnp.asarray(x), jnp.asarray(pos),
                                     pages=None if pages is None else jnp.asarray(pages))
        tout, tcache = TL.mla_decode(tcfg, tp, tcache, _t(x),
                                     TL.StepRows(_t(pos)[:, None], tpages))
        _gap(f"mla_decode {mode} paged={paged} step {step}", tout, jout, LAYER_ATOL)
    _gap(f"mla_decode {mode} paged={paged} cache", tcache["kv"], jcache["kv"], LAYER_ATOL)


def test_flash_decode_ref_matches_jax_at_the_latent_shape():
    """The plain flash-decode at minicpm3-4b's latent call (B = 1, S = 128,
    40 query heads over one kv-head, dq 288, dv 256, v is k, scale
    (64 + 32)^-0.5) against the interpret-mode Pallas kernel, linear
    validity over rows [0, 100]."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, 40, 288).astype(np.float32)
    kv = rng.randn(1, 128, 1, 288).astype(np.float32)
    scale = 96 ** -0.5
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), 100,
                          scale=scale, dv=256, interpret=True)
    tkv = _t(kv)
    got = flash_decode_ref(_t(q), tkv, tkv, 100, scale=scale, dv=256)
    assert tuple(got.shape) == (1, 40, 256)
    _gap("flash_decode_ref latent shape", got, want, LAYER_ATOL)


def test_latent_call_splits_heads_into_groups():
    """The decode kernel's head groups (one CUDA block each): one group on
    rows up to 256 columns (every GQA shape keeps its one-group kernel) and
    up to 8 heads a kv-head; 5 groups of 8 at MLA's G = 40 and 288-column
    rows.  One ticket per (slot, kv-head, head group), the partials
    unchanged."""
    assert [head_groups(G, 288) for G in (1, 2, 4, 8)] == [1, 1, 1, 1]
    assert [head_groups(G, 256) for G in (16, 40, 64)] == [1, 1, 1]
    assert head_groups(40, 288) == 5 and head_groups(16, 288) == 2
    assert head_groups(11, 288) == 11
    part, tickets = decode_scratch(8, 40, 1, 1024, 256, 288)
    assert (part, tickets) == (8 * 16 * 40 * 258, 8 * 5)
    assert decode_scratch(8, 40, 1, 1024, 256) == (part, 8)
    assert decode_scratch(8, 16, 16, 1024, 128)[1] == 8 * 16


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), TM.quantize_params(tcfg, tparams)


def test_quantize_params_keeps_the_absorbed_weights_float(pair):
    """w8a8 quantizes wq_a, wkv_a, wo, the FFN and the head bit for bit as
    JAX does; wq_b and wkv_b stay float (the absorbed decode reads wkv_b)."""
    jcfg, tcfg, jq, tq = _variant(pair, "w8a8")
    mix_j, mix_t = jq["stages"][0]["0"]["mixer"], tq["stages"][0]["0"]["mixer"]
    for name in ("wq_b", "wkv_b", "q_norm", "kv_norm"):
        assert not isinstance(mix_j[name], JQ) and not isinstance(mix_t[name], QTensor)
    for name in ("wq_a", "wkv_a", "wo"):
        jw, tw = mix_j[name], mix_t[name]
        assert isinstance(tw, QTensor)
        q = np.asarray(jw.q)
        K = int(np.prod(q.shape[1:-1]))
        np.testing.assert_array_equal(
            tw.q.numpy(), np.swapaxes(q.reshape(q.shape[0], K, -1), -1, -2))
        np.testing.assert_array_equal(tw.scale.numpy().ravel(),
                                      np.asarray(jw.scale).ravel())


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_prefill_then_decode_matches_jax(pair, quant):
    """Whole-model prefill(cache_len) over a 20-token prompt, then 12
    decode_steps on the linear slot caches: logits and caches agree."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=40)
    tl, tc = TM.prefill(tcfg, tp, _t(toks), cache_len=40)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.padded_vocab)
    _gap(f"{quant} prefill logits", tl, jl, MODEL_ATOL)
    for i in range(12):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), 20 + i)
        tl, tc = TM.decode_step(tcfg, tp, tc, _t(tok), 20 + i)
        _gap(f"{quant} decode {i} logits", tl, jl, MODEL_ATOL)
    for ts, js in zip(tc, jc):
        for g in ts:
            assert tuple(ts[g]["kv"].shape) == tuple(js[g]["kv"].shape)
            _gap(f"{quant} caches layer {g}", ts[g]["kv"], js[g]["kv"], MODEL_ATOL)


def test_mla_has_no_chunk_step(pair):
    """As in JAX, chunked prefill over a paged past refuses MLA's fused
    cache (the engine prefills MLA prompts whole)."""
    _, tcfg, _, tparams = pair
    caches = TM.init_paged_cache(tcfg, 1, 5, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
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


def test_engine_greedy_matches_jax(pair):
    """Four requests (two prompt lengths) on three slots: whole-prompt
    prefill at admission, then decode ticks only (no radix tree, no
    chunk); greedy tokens equal JAX's and the pool reconciles."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, n).tolist() for n in (12, 20, 12, 20)]
    jout, tout, jst, tst, eng = _engines(pair, prompts, 10, max_batch=3)
    assert tout == jout
    assert eng.radix is None and tst.mixed_steps == jst.mixed_steps == 0
    assert (tst.prefills, tst.chunks, tst.tokens_out) == \
        (jst.prefills, jst.chunks, jst.tokens_out) == (4, tst.chunks, 40)
    assert check_invariants(eng.pool, eng.radix, tables=eng.sched.owned) == []
    assert eng.pool.num_free == eng.pool.n_pages - 1


def test_engine_recompute_preemption_matches_jax(pair):
    """``preemption="recompute"`` with 3 usable pages for two 16-token
    prompts of 20 new tokens: the victim re-prefills prompt + generated
    tokens whole; every request finishes with JAX's tokens."""
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
    jcfg, tcfg, params, tparams = pair
    want = run(JEngine, JEngineConfig, jcfg, params)
    got = run(Engine, EngineConfig, tcfg, tparams, device="cpu")
    assert got == want
    assert got[1] >= 1 and got[2] == 2 + got[1]
    assert all(reason == "length" for reason, _ in got[0])
