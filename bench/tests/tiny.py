"""Configurations at reduced widths for the CPU tests: every width cut,
every mechanism kept (the same reference module, the same port family)."""
from __future__ import annotations

import copy

from bench.lib import registry

TINY = {
    "olmo": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4, vocab_size=256),
    "minicpm3": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
                     q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                     qk_rope_head_dim=8, v_head_dim=16),
}
PORT_KEYS = dict(hidden_size="d_model", intermediate_size="d_ff",
                 num_hidden_layers="num_layers", num_attention_heads="num_heads",
                 num_key_value_heads="num_kv_heads", vocab_size="vocab_size",
                 q_lora_rank="q_lora_rank", kv_lora_rank="kv_lora_rank",
                 qk_nope_head_dim="qk_nope_dim", qk_rope_head_dim="qk_rope_dim",
                 v_head_dim="v_head_dim")


def tiny_config(name: str, dtype: str = "float32") -> dict:
    """Configuration ``name`` at the widths of :data:`TINY`, in ``dtype``
    (both sides), with the port's fields to match."""
    c = copy.deepcopy(registry.config(name))
    cut = TINY[c["reference"]]
    c.update(cut)
    port = c["port"]
    for k, v in cut.items():
        port[PORT_KEYS[k]] = v
    if c["reference"] == "olmo":
        port["head_dim"] = c["hidden_size"] // c["num_attention_heads"]
    else:
        port["head_dim"] = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        c["scale_depth"] = c["num_hidden_layers"] ** 0.5
        c["dim_model_base"] = c["hidden_size"]
    port["pad_vocab_to"] = 32
    c["torch_dtype"] = port["compute_dtype"] = dtype
    return c


def tiny_mix(name: str) -> dict:
    """Mix ``name`` with its prompts, answers and clients cut to a CPU run's
    (8 clients at most; the same prefix sharing and distributions), so that
    a loaded CPU still serves every request of a short window."""
    m = copy.deepcopy(registry.traffic(name))
    m["clients"] = min(int(m["clients"]), 8)
    if m.get("shared_prefixes"):
        m["prefix_tokens"] = 16
    m["prompt_tokens"].update(median=12, min=4, max=24)
    m["output_tokens"].update(min=3, max=6)
    return m


def tiny_cell(name: str) -> dict:
    """Cell ``name``'s own keys cut for a CPU run: a short ramp and, for a
    serving cell, 8 slots of 128 rows (chunks of 32) under its engine's
    other settings."""
    cell = registry.workload(name)
    out: dict = {"ramp_s": 0.5}
    if "engine" in cell:
        eng = dict(cell["engine"], max_batch=8, max_len=128)
        if "chunk_tokens" in eng:
            eng["chunk_tokens"] = 32
        out["engine"] = eng
    return out


def tiny_job(name: str, vocab: int = 256) -> dict:
    """Training job ``name`` at a CPU run's lengths (rows of 64 tokens)."""
    j = copy.deepcopy(registry.traffic(name))
    j["seq_len"] = 64
    j["doc_tokens"].update(median=20, min=2, max=80)
    j["separator"] = vocab - 1
    return j
