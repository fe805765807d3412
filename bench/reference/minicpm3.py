"""MiniCPM3-4B in plain float32 PyTorch, from its published description
(hf:openbmb/MiniCPM3-4B's config and model card): a pre-norm decoder with
RMSNorm, multi-head latent attention (MLA, as DeepSeek-V2) and a SwiGLU
feed-forward block, no biases.

MLA, per layer, for hidden rows h:

- queries through a low-rank bottleneck: ``cq = rms(h Wq_a)``, ``q = cq
  Wq_b`` split per head into ``q_nope`` (``qk_nope_head_dim``) and
  ``q_rope`` (``qk_rope_head_dim``, rotated);
- one compressed row per token: ``[c_kv | k_r] = h Wkv_a``; the latent
  ``c_kv`` (``kv_lora_rank``) is RMS-normed, ``k_r`` is rotated and shared
  by every head;
- per-head keys ``[c_kv Wk_b | k_r]`` and values ``c_kv Wv_b`` (``Wkv_b``'s
  two column blocks), causal softmax attention at scale
  ``(qk_nope + qk_rope)^-1/2``, then ``Wo``.

MiniCPM's scalings are applied as published, from the configuration's
keys: the embedding times ``scale_emb``, each residual branch times
``scale_depth / sqrt(num_hidden_layers)``, and the final hidden rows
divided by ``hidden_size / dim_model_base`` before the output projection.
The configuration as run sets them to the neutral values the port runs
(listed in ``reduced``), as it does LongRoPE's scaling (``rope_scaling``,
off) and RMSNorm's epsilon.  The rotary layout is rotate-half; the
published checkpoint's interleaved layout is the same map under a fixed
permutation of the rope columns of ``Wq_b`` and ``Wkv_a``.
"""
from __future__ import annotations

import math

import torch

from bench.reference import common as C


#: each projection's leaf and its contraction dims after the layer axis
PROJECTIONS = {"wq_a": 1, "wq_b": 1, "wkv_a": 1, "wkv_b": 1, "wo": 2, "w_gate": 1,
               "w_up": 1, "w_down": 1}
#: decode absorbs Wkv_b into the query and the latent output (attention
#: runs in the latent space, DeepSeek-V2's weight absorption): per-head
#: products, not a projection of the rows
ABSORBED_IN_DECODE = ("wkv_b",)


def dims(c: dict) -> dict:
    return dict(D=c["hidden_size"], H=c["num_attention_heads"], F=c["intermediate_size"],
                L=c["num_hidden_layers"], V=c["vocab_size"], qr=c["q_lora_rank"],
                kvr=c["kv_lora_rank"], dn=c["qk_nope_head_dim"], dr=c["qk_rope_head_dim"],
                dv=c["v_head_dim"])


def decode_attention_elems(c: dict) -> tuple[int, int]:
    """(elements a decode step reads of each cached row, elements of each
    query row read and output row written), per layer, for decode in the
    latent space: a cached row is the latent and the shared rotated key,
    read once as key and value; each head's query is the absorbed latent
    query and its rotated part, its output a latent row."""
    d = dims(c)
    return d["kvr"] + d["dr"], d["H"] * (2 * d["kvr"] + d["dr"])


def weight_shapes(c: dict, vocab_rows: int) -> dict:
    """name -> (shape, std) for a N(0, std^2) draw, or (shape, "norm") for
    a norm scale, drawn as 1 + N(0, 0.1^2)."""
    d = dims(c)
    D, H, L, qr, kvr = d["D"], d["H"], d["L"], d["qr"], d["kvr"]
    dn, dr, dv, Fd = d["dn"], d["dr"], d["dv"], d["F"]
    return {
        "embed": ((vocab_rows, D), 0.02),
        "norm1": ((L, D), "norm"),
        "wq_a": ((L, D, qr), D ** -0.5),
        "q_norm": ((L, qr), "norm"),
        "wq_b": ((L, qr, H, dn + dr), qr ** -0.5),
        "wkv_a": ((L, D, kvr + dr), D ** -0.5),
        "kv_norm": ((L, kvr), "norm"),
        "wkv_b": ((L, kvr, H, dn + dv), kvr ** -0.5),
        "wo": ((L, H, dv, D), (H * dv) ** -0.5),
        "norm2": ((L, D), "norm"),
        "w_gate": ((L, D, Fd), D ** -0.5),
        "w_up": ((L, D, Fd), D ** -0.5),
        "w_down": ((L, Fd, D), Fd ** -0.5),
        "final_norm": ((D,), "norm"),
        "lm_head": ((D, vocab_rows), 0.02),
    }


def port_tree(c: dict, w: dict) -> dict:
    """The same tensors in the program's parameter tree."""
    mixer = {k: w[k] for k in ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")}
    layer = {"norm1": {"scale": w["norm1"]}, "norm2": {"scale": w["norm2"]}, "mixer": mixer,
             "ffn": {k: w[k] for k in ("w_gate", "w_up", "w_down")}}
    return {"embed": w["embed"], "stages": [{"0": layer}],
            "final_norm": {"scale": w["final_norm"]}, "lm_head": w["lm_head"]}


def _layer(c, d, w, l, x, positions, quant):
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    S, H, dn, dr, dv, kvr = x.shape[0], d["H"], d["dn"], d["dr"], d["dv"], d["kvr"]
    res = c["scale_depth"] / math.sqrt(d["L"])
    h = C.rms_norm(x, w["norm1"][l], eps)
    cq = C.rms_norm(C.linear(h, w["wq_a"][l], quant), w["q_norm"][l], eps)
    q = C.linear(cq, w["wq_b"][l].reshape(d["qr"], -1), quant).view(S, H, dn + dr)
    q = torch.cat([q[..., :dn], C.rope(q[..., dn:], positions, theta)], -1)
    ckv = C.linear(h, w["wkv_a"][l], quant)
    latent = C.rms_norm(ckv[:, :kvr], w["kv_norm"][l], eps)
    k_r = C.rope(ckv[:, None, kvr:], positions, theta)  # [S, 1, dr]
    kv = C.linear(latent, w["wkv_b"][l].reshape(kvr, -1), quant).view(S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_r.expand(S, H, dr)], -1)
    o = C.causal_attention(q, k, kv[..., dn:], (dn + dr) ** -0.5)
    x = x + res * C.linear(o.reshape(S, -1), w["wo"][l].reshape(-1, d["D"]), quant)
    h = C.rms_norm(x, w["norm2"][l], eps)
    g = C.linear(h, w["w_gate"][l], quant)
    u = C.linear(h, w["w_up"][l], quant)
    return x + res * C.linear(torch.nn.functional.silu(g) * u, w["w_down"][l], quant)


def hidden(c: dict, w: dict, seqs: list, quant: str | None = None) -> list:
    """Final hidden rows (normed and scaled for the head) of each token
    sequence in ``seqs``, layer by layer over all of them."""
    d = dims(c)
    xs = [w["embed"][s.long()].to(C.F32) * c["scale_emb"] for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for l in range(d["L"]):
        xs = [_layer(c, d, w, l, x, p, quant) for x, p in zip(xs, pos)]
    div = d["D"] / c["dim_model_base"]
    return [C.rms_norm(x, w["final_norm"], c["rms_norm_eps"]) / div for x in xs]


def logits(c: dict, w: dict, seqs: list, rows: list | None = None,
           quant: str | None = None) -> list:
    """float32 logits over the vocabulary at rows ``rows[i]`` of each
    sequence (every row for None)."""
    head = w["lm_head"][:, :c["vocab_size"]]
    hs = hidden(c, w, seqs, quant)
    return [C.linear(h if rows is None else h[rows[i]], head, quant)
            for i, h in enumerate(hs)]
