"""OLMo-1B in plain float32 PyTorch, from its published description
(Groeneveld et al., arXiv:2402.00838, and allenai/OLMo-1B-hf's config):
a pre-norm decoder with non-parametric LayerNorm (no scale, no bias), full
multi-head attention with rotary embeddings (theta 10000), a SwiGLU
feed-forward block, no biases anywhere, and a final non-parametric
LayerNorm before the output projection.

The configuration as run (``bench/configs/olmo-1b.json``) differs from the
published one where the port does, each listed in ``reduced``: an untied
output projection (``tie_word_embeddings``) and LayerNorm's epsilon.

The weights are the benchmark's, drawn from the seed in the layout of
:func:`weight_shapes` (each per-layer leaf stacked on a leading layer
axis); :func:`port_tree` hands the same tensors to the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import common as C


#: each projection's leaf and its contraction dims after the layer axis
PROJECTIONS = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1, "w_down": 1}


def dims(c: dict) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    return dict(D=D, H=H, K=c["num_key_value_heads"], dh=D // H, F=c["intermediate_size"],
                L=c["num_hidden_layers"], V=c["vocab_size"])


def decode_attention_elems(c: dict) -> tuple[int, int]:
    """(elements a decode step reads of each cached row, elements of each
    query row read and output row written), per layer: a row holds every
    kv head's key and value."""
    d = dims(c)
    return 2 * d["K"] * d["dh"], 2 * d["H"] * d["dh"]


def weight_shapes(c: dict, vocab_rows: int) -> dict:
    """name -> (shape, std): every weight, drawn as N(0, std^2)."""
    d = dims(c)
    D, H, K, dh, Fd, L = d["D"], d["H"], d["K"], d["dh"], d["F"], d["L"]
    return {
        "embed": ((vocab_rows, D), 0.02),
        "wq": ((L, D, H, dh), D ** -0.5),
        "wk": ((L, D, K, dh), D ** -0.5),
        "wv": ((L, D, K, dh), D ** -0.5),
        "wo": ((L, H, dh, D), (H * dh) ** -0.5),
        "w_gate": ((L, D, Fd), D ** -0.5),
        "w_up": ((L, D, Fd), D ** -0.5),
        "w_down": ((L, Fd, D), Fd ** -0.5),
        "lm_head": ((D, vocab_rows), 0.02),
    }


def port_tree(c: dict, w: dict) -> dict:
    """The same tensors in the program's parameter tree (one stage of
    ``num_hidden_layers`` identical layers; the norms hold no weights)."""
    layer = {"norm1": {}, "norm2": {},
             "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
             "ffn": {k: w[k] for k in ("w_gate", "w_up", "w_down")}}
    return {"embed": w["embed"], "stages": [{"0": layer}], "final_norm": {},
            "lm_head": w["lm_head"]}


def _layer(c, d, w, l, x, positions, quant):
    eps = c["layer_norm_eps"]
    S = x.shape[0]
    h = C.layer_norm(x, eps)
    q = C.linear(h, w["wq"][l].reshape(d["D"], -1), quant).view(S, d["H"], d["dh"])
    k = C.linear(h, w["wk"][l].reshape(d["D"], -1), quant).view(S, d["K"], d["dh"])
    v = C.linear(h, w["wv"][l].reshape(d["D"], -1), quant).view(S, d["K"], d["dh"])
    q, k = C.rope(q, positions, c["rope_theta"]), C.rope(k, positions, c["rope_theta"])
    o = C.causal_attention(q, k, v, d["dh"] ** -0.5)
    x = x + C.linear(o.reshape(S, -1), w["wo"][l].reshape(-1, d["D"]), quant)
    h = C.layer_norm(x, eps)
    g = C.linear(h, w["w_gate"][l], quant)
    u = C.linear(h, w["w_up"][l], quant)
    return x + C.linear(torch.nn.functional.silu(g) * u, w["w_down"][l], quant)


def hidden(c: dict, w: dict, seqs: list, quant: str | None = None) -> list:
    """Final hidden rows of each token sequence in ``seqs`` (1-D int
    tensors), layer by layer over all of them."""
    d = dims(c)
    xs = [w["embed"][s.long()].to(C.F32) for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for l in range(d["L"]):
        xs = [_layer(c, d, w, l, x, p, quant) for x, p in zip(xs, pos)]
    return [C.layer_norm(x, c["layer_norm_eps"]) for x in xs]


def logits(c: dict, w: dict, seqs: list, rows: list | None = None,
           quant: str | None = None) -> list:
    """float32 logits over the vocabulary at rows ``rows[i]`` of each
    sequence (every row for None)."""
    V = c["vocab_size"]
    head = w["lm_head"][:, :V]
    hs = hidden(c, w, seqs, quant)
    return [C.linear(h if rows is None else h[rows[i]], head, quant)
            for i, h in enumerate(hs)]


def loss(c: dict, w: dict, tokens, labels, quant: str | None = None):
    """Mean next-token cross-entropy (float32) over every position of
    ``tokens`` / ``labels`` [B, S], a row at a time; each layer is
    recomputed in the backward pass, so one layer's activations are held.
    ``w`` holds float32 leaves that may require grad."""
    d = dims(c)
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    total = torch.zeros((), dtype=C.F32, device=tokens.device)
    for b in range(B):
        x = w["embed"][tokens[b].long()].to(C.F32)
        for l in range(d["L"]):
            x = checkpoint(_layer, c, d, w, l, x, pos, quant, use_reentrant=False)
        h = C.layer_norm(x, c["layer_norm_eps"])
        logits = C.linear(h, w["lm_head"][:, :d["V"]], quant)
        total = total + F.cross_entropy(logits, labels[b].long(), reduction="sum")
    return total / (B * S)
