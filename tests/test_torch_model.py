"""The port's configs and model against the JAX package on the same weights.

Weights come from ``repro.models.model.init``, flattened as
``repro.checkpoint`` flattens them, and cross through
``repro_torch.models.bridge``.  Logits of ``chunk_step``, ``decode_step``
and ``mixed_step`` are compared with JAX reference mode at max abs <= 1e-4
(f32; the two frameworks sum in different orders through a few layers, which
leaves differences of ~1e-6 — the bound is the repo's model-parity
contract).  The updated page pools must agree as well."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.models import model as JM
from repro.models.params import count_params as jcount
import repro_torch.configs as TC
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.models.params import count_params

NAMES = ["cgra-edge", "olmo-1b", "deepseek-67b"]
ATOL = 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax(name):
    """Full and reduced configs give the JAX package's widths, vocab
    padding, layer pattern and stages."""
    for jc, tc in ((JC.get_config(name), TC.get_config(name)),
                   (JC.reduce_config(JC.get_config(name)),
                    TC.reduce_config(TC.get_config(name)))):
        for f in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "padded_vocab",
                  "padded_heads", "norm_type", "rope_theta", "window_size",
                  "logit_softcap", "tie_embeddings"):
            assert getattr(jc, f) == getattr(tc, f), f
        assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
            [(s.mixer, s.ffn) for s in tc.layer_specs()]
        assert [(len(s.group), s.repeats) for s in jc.stages()] == \
            [(len(s.group), s.repeats) for s in tc.stages()]
        assert str(jnp.dtype(jc.compute_dtype)) == str(tc.compute_dtype)[6:]


def test_olmo_1b_param_count():
    """The full olmo-1b spec (counted, never allocated here): ~1.28 B
    parameters, the same as the JAX spec."""
    cfg = TC.get_config("olmo-1b")
    n = count_params(TM.param_specs(cfg))
    assert n == jcount(JM.param_specs(JC.get_config("olmo-1b")))
    assert 1.27e9 < n < 1.29e9
    assert cfg.padded_vocab == 50432


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    jcfg = JC.reduce_config(JC.get_config(request.param))
    tcfg = TC.reduce_config(TC.get_config(request.param))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(tcfg, _flatten(params), device="cpu")
    return jcfg, tcfg, params, tparams


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _pools_close(tc, jc):
    for ts, js in zip(tc, jc):
        for g in ts:
            for kv in ("k", "v"):
                _close(ts[g][kv], js[g][kv])


def test_chunk_decode_mixed_logits_match_jax(pair):
    """Two chunks of a prompt (the second with a radix-style offset and a
    partial buffer), then decode and mixed steps over the same pools: every
    logit and every pool row matches JAX reference mode."""
    jcfg, tcfg, params, tparams = pair
    ps, P, B, C = 8, 13, 3, 8
    jc = JM.init_paged_cache(jcfg, B, P, ps)
    tc = TM.init_paged_cache(tcfg, B, P, ps, device="cpu")
    rng = np.random.RandomState(1)
    pages = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    V = jcfg.vocab_size
    for past, n in ((0, 8), (8, 5)):
        toks = rng.randint(0, V, (1, C)).astype(np.int32)
        jl, jc = JM.chunk_step(jcfg, params, jc, jnp.asarray(toks),
                               jnp.asarray(pages[:1]), past, n)
        tl, tc = TM.chunk_step(tcfg, tparams, tc, torch.from_numpy(toks),
                               torch.from_numpy(pages[:1]), past, n)
        assert tl.dtype == torch.float32 and tl.shape == (1, 1, jcfg.padded_vocab)
        _close(tl, jl)
    # decode: slot 0 continues its prompt, slot 1 at row 0, slot 2 frozen
    # on the trash page
    dpages = pages.copy()
    dpages[2] = 0
    pos = np.array([13, 0, 0], np.int32)
    tok = rng.randint(0, V, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, params, jc, jnp.asarray(tok), jnp.asarray(pos),
                            pages=jnp.asarray(dpages))
    tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(tok),
                            torch.from_numpy(pos), pages=torch.from_numpy(dpages))
    _close(tl, jl)
    # mixed: a chunk for slot 2 plus a decode step with slot 2's row zeroed
    ctoks = rng.randint(0, V, (1, C)).astype(np.int32)
    pos = np.array([14, 1, 0], np.int32)
    jcl, jdl, jc = JM.mixed_step(jcfg, params, jc, jnp.asarray(ctoks),
                                 jnp.asarray(pages[2:]), 0, 7, jnp.asarray(tok),
                                 jnp.asarray(pos), jnp.asarray(dpages))
    tcl, tdl, tc = TM.mixed_step(tcfg, tparams, tc, torch.from_numpy(ctoks),
                                 torch.from_numpy(pages[2:]), 0, 7,
                                 torch.from_numpy(tok), torch.from_numpy(pos),
                                 torch.from_numpy(dpages))
    _close(tcl, jcl)
    _close(tdl, jdl)
    _pools_close(tc, jc)


def test_chunk_step_tensor_lengths_match_int(pair):
    """``past_len``/``chunk_len`` as [B] tensors give the int path's
    logits (last valid row gathered per slot)."""
    _, tcfg, _, tparams = pair
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (1, 8)).astype(np.int32))
    pages = torch.tensor([[1, 2]], dtype=torch.int32)
    outs = []
    for past, n in ((3, 5), (torch.tensor([3]), torch.tensor([5]))):
        tc = TM.init_paged_cache(tcfg, 1, 4, 8, device="cpu")
        outs.append(TM.chunk_step(tcfg, tparams, tc, toks, pages, past, n)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_bridge_rejects_bad_trees():
    cfg = TC.reduce_config(TC.get_config("cgra-edge"))
    flat = _flatten(JM.init(JC.reduce_config(JC.get_config("cgra-edge")),
                            jax.random.PRNGKey(1)))
    missing = dict(flat)
    missing.pop("lm_head")
    with pytest.raises(KeyError, match="lm_head"):
        bridge.params_from_numpy(cfg, missing, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        bridge.params_from_numpy(cfg, dict(flat, extra=np.zeros(1)), device="cpu")
    bad = dict(flat, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(cfg, bad, device="cpu")


def test_bridge_bf16_leaves():
    """bf16 JAX leaves (ml_dtypes on the numpy side) cross bit for bit."""
    cfg = TC.reduce_config(TC.get_config("olmo-1b")).with_(
        compute_dtype=torch.bfloat16)
    jcfg = JC.reduce_config(JC.get_config("olmo-1b")).with_(
        param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    flat = _flatten(JM.init(jcfg, jax.random.PRNGKey(2)))
    p = bridge.params_from_numpy(cfg, flat, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  np.asarray(flat["embed"], np.float32))


def test_init_is_seeded_and_follows_the_init_rules():
    cfg = TC.reduce_config(TC.get_config("olmo-1b"))
    a = TM.init(cfg, seed=3, device="cpu")
    b = TM.init(cfg, seed=3, device="cpu")
    c = TM.init(cfg, seed=4, device="cpu")
    torch.testing.assert_close(a["stages"][0]["0"]["mixer"]["wq"],
                               b["stages"][0]["0"]["mixer"]["wq"], rtol=0, atol=0)
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["stages"][0]["0"]["mixer"]["wq"]  # "scaled": std 1/sqrt(fan_in)
    fan_in = np.prod(wq.shape[:-1])
    assert abs(float(wq.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert abs(float(a["embed"].std()) - 0.02) < 0.002  # "normal"
