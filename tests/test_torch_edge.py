"""The paper's int8 edge-inference path in the port against the JAX package:
``quantize_params``, whole-prompt ``prefill(cache_len=...)`` into linear and
ring slot caches, ``decode_step`` past the window, the training forward,
and the w8a8 paged engine — reduced gemma3-4b (5 local : 1 global, window
32, qk-norm, GeGLU, tied head) and cgra-edge, on the same weights and
tokens, with the port on its plain kernel versions (CPU) and JAX in
reference mode.

Tolerances (compute dtype f32 throughout):
- int8 weights and scales: bit-identical;
- logits and caches, float weights and w8a8: max abs <= 1e-4, the repo's
  model-parity bound (the two frameworks sum in different orders; the
  largest gap observed is 8.7e-6).  Under w8a8 an activation within an f32
  ulp of a rounding boundary could round to the neighbouring int8 step in
  one framework only; none does at these inputs (every gap is printed with
  ``-s``: w8a8 gaps are <= 1e-6);
- greedy engine tokens: identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.core.quant import QTensor as JQ
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.core.quant import QTensor
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.serving import Engine, EngineConfig, check_invariants

ATOL = {"none": 1e-4, "w8a8": 1e-4}
PROMPT, CACHE_LEN, STEPS = 40, 64, 12


def _load(name):
    jcfg = JC.reduce_config(JC.get_config(name))
    tcfg = TC.reduce_config(TC.get_config(name))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, bridge.params_from_numpy(
        tcfg, _flatten(params), device="cpu")


@pytest.fixture(scope="module", params=["gemma3-4b", "cgra-edge"])
def pair(request):
    return _load(request.param)


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), \
        TM.quantize_params(tcfg, tparams)


def _gap(name, got, want, atol):
    gap = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    print(f"{name}: max abs gap {gap:.3e} (bound {atol})")
    assert gap <= atol, (name, gap)


def _caches_close(what, tc, jc, atol):
    for si, (ts, js) in enumerate(zip(tc, jc)):
        for g in ts:
            for kv in ("k", "v"):
                assert tuple(ts[g][kv].shape) == tuple(js[g][kv].shape)
                _gap(f"{what} stage {si} layer {g} {kv}", ts[g][kv], js[g][kv], atol)


def test_gemma3_4b_config_matches_jax():
    jc, tc = JC.get_config("gemma3-4b"), TC.get_config("gemma3-4b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "window_size", "rope_theta",
              "use_qk_norm", "tie_embeddings", "local_global_pattern"):
        assert getattr(jc, f) == getattr(tc, f), f
    assert [s.mixer for s in jc.layer_specs()] == [s.mixer for s in tc.layer_specs()]
    assert sum(s.mixer == "attn_global" for s in tc.layer_specs()) == 5


def _jq_packed(jq: JQ, lead: int, n_red: int):
    """JAX QTensor -> the port's packed layout (q [.., N, K], scale [.., 1, N])."""
    q, s = np.asarray(jq.q), np.asarray(jq.scale)
    L = q.shape[:lead]
    K = int(np.prod(q.shape[lead:lead + n_red]))
    q = q.reshape(*L, K, -1)
    return np.swapaxes(q, -1, -2), s.reshape(*L, 1, q.shape[-1])


def test_quantize_params_bit_identical(pair):
    """Every int8 value and scale equals JAX's, including wo's two
    contraction axes and the head (tied: ``lm_head_q``); idempotent."""
    jcfg, tcfg, params, tparams = pair
    jq = JM.quantize_params(jcfg.with_(quant="w8a8"), params)
    tq = TM.quantize_params(tcfg, tparams)
    n = 0
    for js, ts in zip(jq["stages"], tq["stages"]):
        for g in js:
            for part in ("mixer", "ffn"):
                for name, jw in js[g][part].items():
                    tw = ts[g][part][name]
                    if not isinstance(jw, JQ):
                        assert not isinstance(tw, QTensor)
                        continue
                    n_red = 2 if name == "wo" else 1
                    q, s = _jq_packed(jw, 1, n_red)
                    np.testing.assert_array_equal(tw.q.numpy(), q)
                    np.testing.assert_array_equal(tw.scale.numpy(), s)
                    assert tw.q.dtype == torch.int8 and tw.q.is_contiguous()
                    n += 1
    head = "lm_head_q" if tcfg.tie_embeddings else "lm_head"
    q, s = _jq_packed(jq[head], 0, 1)
    np.testing.assert_array_equal(tq[head].q.numpy(), q)
    np.testing.assert_array_equal(tq[head].scale.numpy(), s)
    assert n == 7 * sum(len(st.group) for st in tcfg.stages())
    again = TM.quantize_params(tcfg, tq)
    assert again["stages"][0]["0"]["mixer"]["wq"] is tq["stages"][0]["0"]["mixer"]["wq"]


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_prefill_then_decode_matches_jax(pair, quant):
    """prefill(cache_len) over a 40-token prompt (past the 32-row window, so
    every local ring is rolled), then 12 decode steps on the linear and
    ring caches: logits and caches agree with JAX reference mode."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    atol = ATOL[quant]
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=CACHE_LEN)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(toks), cache_len=CACHE_LEN)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, jcfg.padded_vocab)
    _gap(f"{quant} prefill logits", tl, jl, atol)
    _caches_close(f"{quant} prefill", tc, jc, atol)
    for i in range(STEPS):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = PROMPT + i
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), pos)
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
        _gap(f"{quant} decode {i} logits", tl, jl, atol)
    _caches_close(f"{quant} decode", tc, jc, atol)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_train_forward_logits_match_jax(pair, quant):
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jh, _, _ = JM.forward_hidden(jcfg, jp, {"tokens": jnp.asarray(toks)}, mode="train")
    th, none = TM.forward_hidden(tcfg, tp, torch.from_numpy(toks), mode="train")
    assert none is None
    _gap(f"{quant} train logits", TM.lm_logits(tcfg, tp, th),
         JM.lm_logits(jcfg, jp, jh), ATOL[quant])


def test_suffix_prefill_over_a_past_matches_jax():
    """prefill(past=...) continues a cached prefix: 8 new queries over 24
    past rows (Sq < Sk), per-slot positions offset by the past length."""
    jcfg, tcfg, jp, tp = _load("gemma3-4b")
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    more = rng.randint(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    _, jpast = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, tpast = TM.prefill(tcfg, tp, torch.from_numpy(toks))
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(more)}, past=jpast, past_len=24)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(more), past=tpast, past_len=24)
    _gap("suffix prefill logits", tl, jl, ATOL["none"])
    _caches_close("suffix prefill", tc, jc, ATOL["none"])


def test_decode_from_init_cache_matches_jax():
    """init_cache gives JAX's cache shapes (window-sized rings); decoding
    into it from row 0 with per-slot positions [B] (slot 1 two rows ahead)
    matches JAX step by step."""
    jcfg, tcfg, jp, tp = _load("gemma3-4b")
    jc = JM.init_cache(jcfg, 2, 48)
    tc = TM.init_cache(tcfg, 2, 48, device="cpu")
    assert [{g: {n: tuple(x.shape) for n, x in d.items()} for g, d in st.items()}
            for st in tc] == \
        [{g: {n: tuple(x.shape) for n, x in d.items()} for g, d in st.items()}
         for st in jc]
    rng = np.random.RandomState(8)
    for i in range(5):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([i, i + 2], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        _gap(f"init-cache decode {i} logits", tl, jl, ATOL["none"])
    _caches_close("init-cache decode", tc, jc, ATOL["none"])


def test_decode_past_linear_capacity_drops_the_write():
    """A global-layer write at pos >= S is dropped, never clamped onto row
    S-1 (JAX ``mode="drop"``); pos == S still reads rows [0, S-1]."""
    jcfg, tcfg, jp, tp = _load("gemma3-4b")
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(toks), cache_len=20)
    before = {si: {g: tc[si][g]["k"].clone() for g in tc[si]} for si in range(len(tc))}
    tok = np.array([[7], [9]], np.int32)
    jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), 20)
    tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), 20)
    _gap("pos == S logits", tl, jl, ATOL["none"])
    _caches_close("pos == S", tc, jc, ATOL["none"])
    # every global layer's linear cache (20 rows, full) is unchanged
    n = 0
    for si, st in enumerate(tcfg.stages()):
        for gi, spec in enumerate(st.group):
            if spec.mixer == "attn_global":
                torch.testing.assert_close(tc[si][str(gi)]["k"], before[si][str(gi)],
                                           rtol=0, atol=0)
                n += 1
    assert n == 1


def _both_engines(pair, prompts, max_new, **kw):
    jcfg, tcfg, params, tparams = pair
    kw = dict(dict(max_len=96, page_size=16, decode_chunk=4, max_batch=3), **kw)
    jout, _ = JEngine(jcfg, params, JEngineConfig(**kw)).generate(prompts, max_new=max_new)
    eng = Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    tout, _ = eng.generate(prompts, max_new=max_new)
    assert check_invariants(eng.pool, eng.radix, tables=eng.sched.owned) == []
    return jout, tout, eng


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_engine_greedy_matches_jax(pair, quant):
    """Greedy tokens of the paged engine equal the JAX engine's.  On reduced
    gemma3-4b the prompts run past the 32-row window, so the local layers
    window through ``start`` on the page pools; w8a8 quantizes at init."""
    rng = np.random.RandomState(7)
    V = pair[0].vocab_size
    prompts = [rng.randint(1, V, n).tolist() for n in (45, 7, 33)]
    jout, tout, eng = _both_engines(pair, prompts, 10, quant=quant,
                                    chunk_tokens=16)
    assert tout == jout
    if quant:
        assert isinstance(eng.params["stages"][0]["0"]["ffn"]["w_down"], QTensor)


def test_engine_config_is_the_only_quant_switch():
    """w8a8 is chosen by the weights (``quantize_params``) or by
    ``EngineConfig(quant=...)``; the model config has no switch that could
    disagree with the params."""
    tcfg = TC.reduce_config(TC.get_config("gemma3-4b"))
    with pytest.raises(TypeError):
        tcfg.with_(quant="w8a8")
    params = TM.init(tcfg, seed=0, device="cpu")
    for quant, want in ((None, False), ("none", False), ("w8a8", True)):
        eng = Engine(tcfg, params, EngineConfig(max_len=32, page_size=16, quant=quant),
                     device="cpu")
        assert isinstance(eng.params["stages"][0]["0"]["mixer"]["wq"], QTensor) == want
    with pytest.raises(ValueError):
        EngineConfig(quant="w4a16")


def test_tied_head_reads_the_embedding_in_place():
    """The tied bf16 head multiplies by embed [Vp, D] as the GEMM's [N, K]
    operand: the logits equal hidden @ embed.T, with no [D, Vp] copy."""
    tcfg = TC.reduce_config(TC.get_config("gemma3-4b")).with_(
        compute_dtype=torch.bfloat16)
    params = TM.init(tcfg, seed=1, device="cpu")
    h = torch.randn(2, 3, tcfg.d_model, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    got = TM.lm_logits(tcfg, params, h)
    want = torch.matmul(h.float(), params["embed"].float().T)
    assert got.dtype == torch.float32 and got.shape == (2, 3, tcfg.padded_vocab)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_whole_prefill_keeps_a_window_layers_every_row():
    """A sliding-window layer's whole prefill for the pages: reduced
    gemma3-4b (window 32) over a 40-token prompt.  ``prefill(full_kv=True)``
    keeps every row of every layer linear, as JAX's (caches within 1e-4);
    without it the local layers keep the 32-row ring.  The engine's
    whole-prefill runner asks for it, so the rows it scatters through the
    page table are the prompt's rows 0-39 in every layer (what the
    reference's ``_whole_prefill`` writes with ``full_kv=True``)."""
    from repro_torch.serving import ModelRunner
    jcfg, tcfg, jp, tp = _load("gemma3-4b")
    S = 40
    assert S > tcfg.window_size == 32
    toks = np.random.RandomState(9).randint(0, jcfg.vocab_size, (1, S)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, full_kv=True)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(toks), full_kv=True)
    _gap("full_kv prefill logits", tl, jl, ATOL["none"])
    _caches_close("full_kv prefill", tc, jc, ATOL["none"])
    assert all(tc[si][g][kv].shape[2] == S for si in range(len(tc)) for g in tc[si]
               for kv in ("k", "v"))
    _, ring = TM.prefill(tcfg, tp, torch.from_numpy(toks))
    local = [spec.mixer == "attn_local" for spec in tcfg.stages()[0].group]
    assert local[0] and ring[0]["0"]["k"].shape[2] == tcfg.window_size

    ps = 8
    runner = ModelRunner(tcfg, tp, EngineConfig(max_batch=2, max_len=64, page_size=ps,
                                                n_pages=20), "cpu")
    table = np.array([11, 3, 17, 5, 8, 1, 2, 4], np.int32)  # pages_per_seq = 8
    first, ok = runner.whole_prefill(toks[0].tolist(), table, 1, 0.0, None)
    assert ok and first == int(np.argmax(np.asarray(jl)[0, -1, :jcfg.vocab_size]))
    j = np.arange(S)
    for si, stage in enumerate(runner.caches):
        for g in stage:
            for kv in ("k", "v"):
                rows = stage[g][kv][:, table[j // ps], j % ps]  # [R, S, K, dh]
                _gap(f"scattered stage {si} layer {g} {kv}", rows, np.asarray(jc[si][g][kv])[:, 0],
                     ATOL["none"])
