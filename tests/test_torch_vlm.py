"""The cross-attention VLM (llama-3.2-vision-11b) in the port against the
JAX package on the same weights and inputs (CPU, plain kernel versions,
JAX in reference mode).

Weights come from ``repro.models.model.init`` on the reduced config (5
layers, the cross layer at index 4, d_model 64, 4 heads over 2, 16 image
tokens of width 32), flattened as ``repro.checkpoint`` flattens them,
through ``models.bridge``.  The reference initialises every cross gate to 0
(``tanh(0) = 0`` hides the whole sub-block), so the numpy weights fed to
both packages carry gates of 0.5 +- 0.1: only the test's inputs change,
nothing in the JAX package.  Tokens and patch embeddings are drawn with
numpy from a seed.

Tolerances (compute dtype f32 throughout):
- one cross-attention sub-block, at prefill and at decode: max abs <= 1e-5,
  the port's layer-parity bound (the frameworks sum in different orders);
- int8 weights and scales: bit-identical;
- whole-model logits, hidden states and caches, float weights and w8a8:
  <= 1e-4, the model-parity bound of ``tests/test_torch_edge.py``.  Under
  w8a8 a decode step's logits may pass that bound only as a witnessed
  one-step flip of the head's int8 input (``_head_flip_witness``: an f32
  rounding at an int8 rounding boundary; the head feeds no cache), with
  the hidden states still within 1e-4."""
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import count_params as jcount
import repro_torch.configs as TC
from repro_torch.core.gemm import quantize_act
from repro_torch.core.quant import QTensor
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.graph import DecodeGraph
from repro_torch.models.params import count_params
from repro_torch.serving import Engine, EngineConfig

LAYER_ATOL, MODEL_ATOL = 1e-5, 1e-4
NAME = "llama-3.2-vision-11b"
PROMPT, CACHE_LEN, STEPS = 24, 40, 4
CONFIG_FIELDS = ("name", "family", "kind", "num_layers", "d_model", "num_heads",
                 "num_kv_heads", "head_dim", "d_ff", "vocab_size", "padded_vocab",
                 "norm_type", "tie_embeddings", "cross_every", "vision_tokens",
                 "vision_dim", "audio_frontend", "frontend_dim", "rope_theta")


def cross_layer(cfg):
    """(stage, group key) of the first cross layer: the reduced config's 5
    layers factor into a stage of two attention pairs and the cross layer
    as a stage of its own."""
    for si, st in enumerate(cfg.stages()):
        for gi, spec in enumerate(st.group):
            if spec.mixer == "cross":
                return si, str(gi)
    raise AssertionError("no cross layer")


def _leaf_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def open_gates(params, seed: int = 0):
    """The JAX tree with every zero-initialised cross gate set to 0.5 +- 0.1
    (numpy, from ``seed``), so that the cross sub-blocks reach the output."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        if _leaf_key(path).endswith("/gate"):
            return jnp.asarray(0.5 + 0.1 * rng.randn(*a.shape).astype(np.float32))
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.reduce_config(JC.get_config(NAME))
    tcfg = TC.reduce_config(TC.get_config(NAME))
    params = open_gates(JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, bridge.params_from_numpy(tcfg, _flatten(params),
                                                        device="cpu")


def _variant(pair, quant):
    jcfg, tcfg, params, tparams = pair
    if quant == "none":
        return jcfg, tcfg, params, tparams
    jcfg = jcfg.with_(quant=quant)
    return jcfg, tcfg, JM.quantize_params(jcfg, params), TM.quantize_params(tcfg, tparams)


def _inputs(cfg, seed, S=PROMPT):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    img = rng.randn(2, cfg.vision_tokens, cfg.vision_dim).astype(np.float32)
    return rng, toks, img


def _gap(name, got, want, atol):
    gap = float(np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32))))
    print(f"{name}: max abs gap {gap:.3e} (bound {atol})")
    assert gap <= atol, (name, gap)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _clone(caches):
    return [{g: {n: t.clone() for n, t in d.items()} for g, d in st.items()} for st in caches]


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_reduce_config_match_jax(reduced):
    """The config and its reduced form have the JAX package's widths, the
    vision fields included, and the same layer list (cross on every 5th)."""
    jc, tc = JC.get_config(NAME), TC.get_config(NAME)
    if reduced:
        jc, tc = JC.reduce_config(jc), TC.reduce_config(tc)
    for f in CONFIG_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    assert [(s.mixer, s.ffn) for s in jc.layer_specs()] == \
        [(s.mixer, s.ffn) for s in tc.layer_specs()]
    assert [s.mixer for s in tc.layer_specs()].count("cross") == tc.num_layers // 5


def test_param_count_and_tree_match_jax(pair):
    """Full specs (counted, never allocated): 10.1 B parameters, as JAX's.
    Reduced: every leaf of the bridged tree has JAX's path and shape, the
    scalar gates included (shape ())."""
    n = count_params(TM.param_specs(TC.get_config(NAME)))
    assert n == jcount(JM.param_specs(JC.get_config(NAME)))
    assert 10.0e9 < n < 10.2e9
    _, tcfg, params, tparams = pair
    flat = _flatten(params)
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
        else:
            tflat["/".join(path)] = tuple(t.shape)
    walk(tparams, [])
    assert tflat == {k: tuple(v.shape) for k, v in flat.items()}
    si, gi = cross_layer(tcfg)
    assert (si, gi) == (1, "0")
    gate = tparams["stages"][si][gi]["mixer"]["cross"]["gate"]
    assert tuple(gate.shape) == (1,) and float(gate[0]) == pytest.approx(
        float(flat[f"stages/{si}/{gi}/mixer/cross/gate"][0]))
    assert TM._unstack(tparams["stages"][si], 1)[0][gi]["mixer"]["cross"]["gate"].shape == ()


def _cross(pair):
    jcfg, tcfg, params, tparams = pair
    si, gi = cross_layer(tcfg)
    jp = jax.tree.map(lambda a: a[0], params["stages"][si][gi]["mixer"]["cross"])
    tp = TM._unstack(tparams["stages"][si][gi]["mixer"]["cross"], 1)[0]
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S", [24, 1])
def test_cross_attn_matches_jax(pair, S):
    """One cross sub-block with its gate open: text rows over the image's
    K/V projected at prefill (S = 24 rows over T = 16), then over the cached
    (k, v) at decode (S = 1); output and K/V within 1e-5 of JAX's."""
    jcfg, tcfg, jp, tp = _cross(pair)
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    img = rng.randn(2, jcfg.vision_tokens, jcfg.d_model).astype(np.float32)
    jout, (jk, jv) = JL.cross_attn(jcfg, jp, jnp.asarray(x), jnp.asarray(img))
    tout, (tk, tv) = TL.cross_attn(tcfg, tp, _t(x), _t(img))
    assert abs(float(jp["gate"])) > 0.1
    _gap(f"cross_attn S={S}", tout, jout, LAYER_ATOL)
    _gap(f"cross_attn S={S} k", tk, jk, LAYER_ATOL)
    _gap(f"cross_attn S={S} v", tv, jv, LAYER_ATOL)
    jout2, _ = JL.cross_attn(jcfg, jp, jnp.asarray(x), None, (jk, jv))
    tout2, (tk2, _) = TL.cross_attn(tcfg, tp, _t(x), None, (tk, tv))
    assert tk2 is tk
    _gap(f"cross_attn S={S} from cached K/V", tout2, jout2, LAYER_ATOL)


def test_quantize_params_bit_identical(pair):
    """w8a8: the self and cross projections, the SwiGLU weights and the
    untied head are int8 equal to JAX's; the gate, norms, embedding and
    ``vision_proj`` stay float."""
    jcfg, tcfg, params, tparams = pair
    jq = JM.quantize_params(jcfg.with_(quant="w8a8"), params)
    tq = TM.quantize_params(tcfg, tparams)

    def packed(w, lead, n_red):
        q, s = np.asarray(w.q), np.asarray(w.scale)
        K = int(np.prod(q.shape[lead:lead + n_red]))
        q = q.reshape(*q.shape[:lead], K, -1)
        return np.swapaxes(q, -1, -2), s.reshape(*q.shape[:lead], 1, q.shape[-1])

    n = 0
    for js, ts in zip(jq["stages"], tq["stages"]):
        for g in js:
            jl, tl = js[g], ts[g]
            parts = [(jl["ffn"], tl["ffn"])]
            if "cross" in jl["mixer"]:
                parts += [(jl["mixer"]["self"], tl["mixer"]["self"]),
                          (jl["mixer"]["cross"], tl["mixer"]["cross"])]
                assert not isinstance(tl["mixer"]["cross"]["gate"], QTensor)
            else:
                parts.append((jl["mixer"], tl["mixer"]))
            for jd, td in parts:
                for name, jw in jd.items():
                    assert isinstance(jw, JQ) == isinstance(td[name], QTensor), name
                    if isinstance(jw, JQ):
                        q, s = packed(jw, 1, 2 if name == "wo" else 1)
                        np.testing.assert_array_equal(td[name].q.numpy(), q)
                        np.testing.assert_array_equal(td[name].scale.numpy(), s)
                        n += 1
    assert n == 7 * 2 + 7 + 4  # two stacked attention groups, the cross layer
    q, s = packed(jq["lm_head"], 0, 1)
    np.testing.assert_array_equal(tq["lm_head"].q.numpy(), q)
    np.testing.assert_array_equal(tq["lm_head"].scale.numpy(), s)
    assert not isinstance(tq["vision_proj"], QTensor) and "lm_head_q" not in tq


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_training_forward_matches_jax(pair, quant):
    """The cache-free forward (the reference's ``mode="train"``) over text
    and image: every position's logits within 1e-4."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    _, toks, img = _inputs(jcfg, 3)
    jh, _, _ = JM.forward_hidden(jcfg, jp, {"tokens": jnp.asarray(toks),
                                            "images": jnp.asarray(img)})
    th, none = TM.forward_hidden(tcfg, tp, _t(toks), images=_t(img))
    assert none is None
    _gap(f"forward {quant} hidden", th, jh, MODEL_ATOL)
    _gap(f"forward {quant} logits", TM.lm_logits(tcfg, tp, th), JM.lm_logits(jcfg, jp, jh),
         MODEL_ATOL)


def _head_flip_witness(what, tcfg, jp, tl, t_hidden, j_hidden):
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
    assert diff.any() and np.abs(diff).max() == 1 and near[diff != 0].max() < 1e-3
    want = j_qmatmul(JQ(jnp.asarray(tq.q.numpy()).reshape(-1, tcfg.d_model),
                        jnp.asarray(tq.scale.numpy()).reshape(-1, 1)), jp["lm_head"])
    _gap(f"{what} logits from the port's int8 row", tl, np.asarray(want).reshape(tl.shape),
         MODEL_ATOL)


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_prefill_then_decode_matches_jax(pair, quant):
    """``prefill(tokens, images, cache_len)`` then 4 decode steps over the
    slot caches: logits, hidden states and every cache leaf (self k/v and
    the image's ck/cv) within 1e-4 of JAX's; a decode step leaves ck/cv
    bit-equal.  Under w8a8 a logits gap past the bound must be a witnessed
    flip of the head's int8 input."""
    jcfg, tcfg, jp, tp = _variant(pair, quant)
    rng, toks, img = _inputs(jcfg, 4)
    jl, jc = jax.jit(lambda p, t, i: JM.prefill(jcfg, p, {"tokens": t, "images": i},
                                                cache_len=CACHE_LEN))(
        jp, jnp.asarray(toks), jnp.asarray(img))
    tl, tc = TM.prefill(tcfg, tp, _t(toks), images=_t(img), cache_len=CACHE_LEN)
    assert tl.shape == (2, 1, jcfg.padded_vocab) and tl.dtype == torch.float32
    _gap(f"{quant} prefill logits", tl, jl, MODEL_ATOL)
    si, gi = cross_layer(tcfg)
    cross = tc[si][gi]
    assert tuple(cross["ck"].shape) == (1, 2, jcfg.vision_tokens, jcfg.num_kv_heads,
                                        jcfg.head_dim)
    assert cross["k"].shape[2] == CACHE_LEN
    img_kv = (cross["ck"].clone(), cross["cv"].clone())

    @jax.jit
    def jstep(p, c, t, pos):
        hidden, _, c = JM.forward_hidden(jcfg, p, {"tokens": t}, mode="decode",
                                         caches=c, pos=pos)
        return hidden, JM.lm_logits(jcfg, p, hidden), c

    flips = 0
    for i in range(STEPS):
        tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full(2, PROMPT + i, np.int32)
        jh, jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        th, tc = TM.forward_hidden(tcfg, tp, _t(tok), mode="decode", caches=tc, pos=_t(pos))
        tl = TM.lm_logits(tcfg, tp, th)
        _gap(f"{quant} decode {i} hidden", th, jh, MODEL_ATOL)
        gap = float(np.max(np.abs(tl.numpy() - np.asarray(jl))))
        if quant == "w8a8" and gap > MODEL_ATOL:
            flips += 1
            _head_flip_witness(f"decode {i}", tcfg, jp, tl, th, jh)
        else:
            _gap(f"{quant} decode {i} logits", tl, jl, MODEL_ATOL)
    assert flips <= 1
    assert torch.equal(cross["ck"], img_kv[0]) and torch.equal(cross["cv"], img_kv[1])
    for spec, t, j in TM.cache_leaves(TM.cache_specs(tcfg, 1, 1), tc, jc):
        assert tuple(t.shape) == tuple(j.shape)
        _gap(f"{quant} cache {spec.axes}", t, j, MODEL_ATOL)
    # the port's own entry point gives the same step
    tok = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    caches = _clone(tc)
    want = TM.lm_logits(tcfg, tp, TM.forward_hidden(tcfg, tp, _t(tok), mode="decode",
                                                    caches=tc, pos=_t(np.full(2, 40)))[0])
    got, _ = TM.decode_step(tcfg, tp, caches, _t(tok), 40)
    assert torch.equal(got, want)


def test_decode_graph_eager_equals_decode_step(pair):
    """``DecodeGraph`` over the prefill's slot caches (what the card captures
    and replays): its eager step equals ``decode_step`` bit for bit, the
    image K/V leaves are among its state and stay untouched."""
    _, tcfg, _, tp = pair
    _, toks, img = _inputs(tcfg, 5)
    _, caches = TM.prefill(tcfg, tp, _t(toks), images=_t(img), cache_len=CACHE_LEN)
    twin = _clone(caches)
    si, gi = cross_layer(tcfg)
    ck = caches[si][gi]["ck"].clone()
    g = DecodeGraph(tcfg, tp, caches, 2)
    assert any(t is caches[si][gi]["ck"] for t in g.state) and len(g.state) == 2
    cur = torch.tensor([3, 7], dtype=torch.int32)
    g.load(cur, torch.tensor([PROMPT, PROMPT], dtype=torch.int32))
    lf, finite = g.run()
    want, _ = TM.decode_step(tcfg, tp, twin, cur[:, None], PROMPT)
    assert torch.equal(lf, want[:, -1, : tcfg.vocab_size]) and bool(finite.all())
    assert torch.equal(caches[si][gi]["ck"], ck)
    for (_, a, b) in TM.cache_leaves(TM.cache_specs(tcfg, 1, 1), caches, twin):
        assert torch.equal(a, b)  # both wrote the same KV row


def test_refusals(pair):
    """A cross model needs its images at prefill and in the training
    forward; it has no prefill over a cached prefix (the reference ignores
    the past there), no chunk step, and no engine path (the JAX engine's
    prefill passes tokens only)."""
    _, tcfg, _, tp = pair
    _, toks, img = _inputs(tcfg, 6)
    with pytest.raises(ValueError, match="images"):
        TM.prefill(tcfg, tp, _t(toks), cache_len=CACHE_LEN)
    with pytest.raises(ValueError, match="images"):
        TM.forward_hidden(tcfg, tp, _t(toks))
    _, past = TM.prefill(tcfg, tp, _t(toks[:, :8]), images=_t(img))
    with pytest.raises(NotImplementedError, match="cached prefix"):
        TM.prefill(tcfg, tp, _t(toks[:, 8:]), images=_t(img), past=past, past_len=8)
    caches = TM.init_paged_cache(tcfg, 1, 5, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="cross-attention"):
        TM.chunk_step(tcfg, tp, caches, torch.zeros(1, 8, dtype=torch.int32),
                      torch.tensor([[1, 2]], dtype=torch.int32), 0, 8)
    with pytest.raises(ValueError, match="engine"):
        Engine(tcfg, tp, EngineConfig(max_len=64, page_size=16), device="cpu")
