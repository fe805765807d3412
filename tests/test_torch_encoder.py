"""The bidirectional audio encoder (hubert-xlarge) in the port against the
JAX package on the same weights and inputs (CPU, plain kernel versions,
JAX in reference mode).

Weights come from ``repro.models.model.init`` on the reduced config (48 ->
2 layers, d_model 64, 4 heads of 16, LayerNorm, a GELU MLP of 128 with
biases, frames of width 64), flattened as ``repro.checkpoint`` flattens
them, through ``models.bridge``.  The reference initialises the MLP's and
the LayerNorms' biases to 0, so the numpy weights fed to both packages
carry biases of 0.1 x N(0, 1): only the test's inputs change, nothing in
the JAX package.  Frame embeddings are drawn with numpy from a seed.

Tolerances (compute dtype f32 throughout):
- one layer's parts (GELU MLP, LayerNorm, bidirectional self-attention):
  max abs <= 1e-5, the port's layer-parity bound;
- int8 weights and scales: bit-identical;
- the whole forward's per-frame logits, float weights and w8a8: <= 1e-4,
  the model-parity bound of ``tests/test_torch_edge.py`` (no int8
  activation of these inputs lies at a rounding boundary: every gap is
  printed with ``-s``).

The port's attention used to be causal whatever the model (it had no
``kind``); the reference's encoder attends both ways (``causal = cfg.kind
== "decoder"``).  ``test_the_causal_rule_misses_jax`` keeps that fault in
view: the old rule, still reachable as ``causal=True`` or a
``kind="decoder"`` copy of the config, misses JAX by far more than the
bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.core.quant import QTensor as JQ
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import count_params as jcount
import repro_torch.configs as TC
from repro_torch.core.quant import QTensor
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import count_params
from repro_torch.serving import Engine, EngineConfig

LAYER_ATOL, MODEL_ATOL = 1e-5, 1e-4
NAME = "hubert-xlarge"
FRAMES = 37  # no multiple of any tile
CONFIG_FIELDS = ("name", "family", "kind", "num_layers", "d_model", "num_heads",
                 "num_kv_heads", "head_dim", "d_ff", "vocab_size", "padded_vocab",
                 "norm_type", "tie_embeddings", "audio_frontend", "frontend_dim",
                 "vision_tokens", "cross_every")


def with_biases(params, seed: int = 0):
    """The JAX tree with every zero-initialised bias (the MLP's b1 / b2, the
    LayerNorms' bias) drawn as 0.1 x N(0, 1) with numpy from ``seed``."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        if key.rsplit("/", 1)[-1] in ("b1", "b2", "bias"):
            return jnp.asarray(0.1 * rng.randn(*a.shape).astype(np.float32))
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.reduce_config(JC.get_config(NAME))
    tcfg = TC.reduce_config(TC.get_config(NAME))
    params = with_biases(JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, bridge.params_from_numpy(tcfg, _flatten(params),
                                                        device="cpu")


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), TM.quantize_params(tcfg, tparams)


def _gap(name, got, want):
    gap = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    print(f"{name}: max abs gap {gap:.3e}")
    return gap


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(pair, part):
    jcfg, tcfg, params, tparams = pair
    jp = jax.tree.map(lambda a: a[0], params["stages"][0]["0"][part])
    tp = TM._unstack(tparams["stages"][0]["0"][part], 1)[0]
    return jcfg, tcfg, jp, tp


def _frames(cfg, seed, S=FRAMES, width=None):
    rng = np.random.RandomState(seed)
    return rng.randn(2, S, width or cfg.frontend_dim).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_reduce_config_match_jax(reduced):
    """The config and its reduced form equal JAX's: an encoder of
    LayerNorm layers with a GELU MLP, head dim 80 at full width, frames of
    width 1280 (64 reduced)."""
    jc, tc = JC.get_config(NAME), TC.get_config(NAME)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
        [(s.mixer, s.ffn) for s in tc.layer_specs()]
    assert tc.kind == "encoder" and JL.ffn_kind(jc) == TL.ffn_kind(tc) == "gelu_mlp"


def test_param_count_matches_jax():
    """Full specs (counted, never allocated): 0.947 B parameters as JAX's,
    the 504-entry codebook padded to 512, ``frontend_proj`` [1280, 1280]."""
    cfg = TC.get_config(NAME)
    specs = TM.param_specs(cfg)
    n = count_params(specs)
    assert n == jcount(JM.param_specs(JC.get_config(NAME)))
    assert 0.94e9 < n < 0.95e9 and cfg.padded_vocab == 512
    assert specs["frontend_proj"].shape == (1280, 1280)
    assert set(specs["stages"][0]["0"]["ffn"]) == {"w1", "b1", "w2", "b2"}


def test_gelu_mlp_matches_jax(pair):
    """The GELU MLP with nonzero biases: ``jax.nn.gelu``'s tanh form, each
    bias added in the compute dtype after the GEMM's store; within 1e-5.
    The erf form would miss by more."""
    jcfg, tcfg, jp, tp = _layer(pair, "ffn")
    x = _frames(jcfg, 1, width=jcfg.d_model)
    want = JL.ffn_forward(jcfg, jp, jnp.asarray(x))
    assert _gap("gelu_mlp", TL.ffn_forward(tcfg, tp, _t(x)), want) <= LAYER_ATOL
    erf = torch.nn.functional.gelu(TL.dense_proj(tcfg, _t(x), tp["w1"]) + tp["b1"])
    assert _gap("gelu_mlp, erf form", TL.dense_proj(tcfg, erf, tp["w2"]) + tp["b2"],
                want) > 1e-5


def test_layernorm_matches_jax(pair):
    """LayerNorm with scale and a nonzero bias, eps 1e-6, within 1e-5."""
    jcfg, tcfg, jp, tp = _layer(pair, "norm1")
    x = 3.0 + 2.0 * _frames(jcfg, 2, width=jcfg.d_model)
    assert float(np.abs(np.asarray(jp["bias"])).max()) > 0.01
    assert _gap("layernorm", TL.apply_norm(tcfg, tp, _t(x)),
                JL.apply_norm(jcfg, jp, jnp.asarray(x))) <= LAYER_ATOL


def _attn_pair(pair, seed):
    jcfg, tcfg, jp, tp = _layer(pair, "mixer")
    x = _frames(jcfg, seed, width=jcfg.d_model)
    pos = np.arange(FRAMES, dtype=np.int32)
    want = JL.attn_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), local=False)
    rows = TL.StepRows(torch.arange(FRAMES, dtype=torch.int32), None)
    return tcfg, tp, _t(x), rows, want


def test_attn_forward_is_bidirectional_as_jax(pair):
    """The encoder's self-attention (RoPE, as the reference, then both
    ways) within 1e-5 of JAX's ``attn_forward``."""
    tcfg, tp, x, rows, want = _attn_pair(pair, 3)
    got = TL.attn_forward(tcfg, tp, x, rows, local=False)[0]
    assert _gap("attn_forward encoder", got, want) <= LAYER_ATOL


def test_the_causal_rule_misses_jax(pair):
    """The rule the port had before ``kind`` (always causal) misses JAX by
    more than 1e-4, in one layer and in the whole model's logits: the
    fault the ``kind`` repair closes."""
    tcfg, tp, x, rows, want = _attn_pair(pair, 3)
    old = TL.attn_forward(tcfg, tp, x, rows, local=False, causal=True)[0]
    assert _gap("attn_forward, old causal rule", old, want) > 1e-4
    jcfg, tcfg, jparams, tparams = pair
    fr = _frames(jcfg, 4)
    jh, _, _ = JM.forward_hidden(jcfg, jparams, {"frames": jnp.asarray(fr)})
    th, _ = TM.forward_hidden(tcfg.with_(kind="decoder"), tparams, frames=_t(fr))
    assert _gap("forward logits, old causal rule", TM.lm_logits(tcfg, tparams, th),
                JM.lm_logits(jcfg, jparams, jh)) > 1e-4


def test_quantize_params_bit_identical(pair):
    """w8a8: q/k/v/o, w1, w2 and the untied head int8 equal to JAX's; the
    biases, norms and ``frontend_proj`` stay float."""
    jcfg, tcfg, params, tparams = pair
    jq = JM.quantize_params(jcfg.with_(quant="w8a8"), params)
    tq = TM.quantize_params(tcfg, tparams)
    n = 0
    for part in ("mixer", "ffn"):
        for name, jw in jq["stages"][0]["0"][part].items():
            tw = tq["stages"][0]["0"][part][name]
            assert isinstance(jw, JQ) == isinstance(tw, QTensor), name
            if isinstance(jw, JQ):
                q, s = np.asarray(jw.q), np.asarray(jw.scale)
                K = int(np.prod(q.shape[1:3 if name == "wo" else 2]))
                q = np.swapaxes(q.reshape(q.shape[0], K, -1), -1, -2)
                np.testing.assert_array_equal(tw.q.numpy(), q)
                np.testing.assert_array_equal(tw.scale.numpy(), s.reshape(s.shape[0], 1, -1))
                n += 1
    assert n == 6
    q = np.swapaxes(np.asarray(jq["lm_head"].q), 0, 1)
    np.testing.assert_array_equal(tq["lm_head"].q.numpy(), q)
    assert not isinstance(tq["frontend_proj"], QTensor)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_forward_logits_match_jax(pair, quant):
    """The cache-free forward (the reference's ``mode="train"``, what its
    ``loss_fn`` runs) over 37 frames, then ``lm_logits`` on every frame:
    hidden states and per-frame logits over the padded 512 classes within
    1e-4 of JAX's."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    fr = _frames(jcfg, 5)
    jh, _, _ = JM.forward_hidden(jcfg, jp, {"frames": jnp.asarray(fr)})
    th, none = TM.forward_hidden(tcfg, tp, frames=_t(fr))
    assert none is None
    tl = TM.lm_logits(tcfg, tp, th)
    assert tl.shape == (2, FRAMES, tcfg.padded_vocab) and tl.dtype == torch.float32
    assert _gap(f"encoder {quant} hidden", th, jh) <= MODEL_ATOL
    assert _gap(f"encoder {quant} logits", tl, JM.lm_logits(jcfg, jp, jh)) <= MODEL_ATOL


def test_encoder_has_no_prefill_decode_or_engine(pair):
    """An encoder has no causal prefill, decode or chunk step (the reference's
    ``prefill`` would run it causally: ``attn_prefill`` is causal whatever
    the kind) and no engine; the forward needs frames."""
    _, tcfg, _, tp = pair
    toks = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder"):
        TM.prefill(tcfg, tp, toks)
    caches = TM.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        TM.decode_step(tcfg, tp, caches, toks[:, :1], 8)
    pools = TM.init_paged_cache(tcfg, 1, 5, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        TM.chunk_step(tcfg, tp, pools, toks[:1], torch.tensor([[1, 2]], dtype=torch.int32),
                      0, 8)
    with pytest.raises(ValueError, match="engine"):
        Engine(tcfg, tp, EngineConfig(max_len=64, page_size=16), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        TM.forward_hidden(tcfg, tp, toks)
