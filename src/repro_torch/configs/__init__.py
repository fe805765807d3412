"""Config registry: ``get_config(name)`` + ``reduce_config`` for smoke tests.

Every configuration of the JAX package is registered (kimi-k2's full
1 T parameters fit no single card; its reduced model runs)."""
from __future__ import annotations

import torch

from repro_torch.configs import (cgra_edge, deepseek_67b, gemma3_4b, hubert_xlarge,
                                 jamba_v01_52b, kimi_k2_1t_a32b, llama32_vision_11b,
                                 mamba2_130m, minicpm3_4b, olmo_1b, qwen3_moe_30b_a3b)
from repro_torch.configs.base import (SHAPES, ArchConfig, LayerSpec, ShapeConfig, Stage,
                                      build_stages, cell_skip_reason)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (olmo_1b, deepseek_67b, cgra_edge, gemma3_4b, minicpm3_4b,
              qwen3_moe_30b_a3b, mamba2_130m, jamba_v01_52b, llama32_vision_11b,
              hubert_xlarge, kimi_k2_1t_a32b)
}

ASSIGNED = [n for n in REGISTRY if n != "cgra-edge"]


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def parse_sets(sets) -> dict:
    """``--set key=value`` flags (the dry run's and the train launcher's) as
    config overrides, as the reference's dry run reads them: an integer,
    ``True`` / ``False``, else the string."""
    overrides = {}
    for kv in sets:
        k, v = kv.split("=", 1)
        overrides[k] = (v if not v.lstrip("-").isdigit() else int(v)) \
            if v not in ("True", "False") else v == "True"
    return overrides


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink an arch to smoke-test size with the same widths as
    ``repro.configs.reduce_config`` (layer pattern and GQA kept)."""
    if cfg.ssm_every:
        layers = cfg.ssm_every
    elif cfg.cross_every:
        layers = cfg.cross_every
    elif cfg.local_global_pattern:
        layers = cfg.local_global_pattern + 1
    elif cfg.num_experts and cfg.moe_every > 1:
        layers = cfg.moe_every * 2
    else:
        layers = 2
    kw = dict(
        num_layers=layers,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        compute_dtype=torch.float32,
        pad_heads_to=1,
        pad_vocab_to=32,
        fsdp=False,
        remat_policy="none",
    )
    if cfg.num_heads:
        kw.update(num_heads=4, head_dim=16)
        kw.update(num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4)
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                  v_head_dim=16, head_dim=16)
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.window_size:
        kw.update(window_size=32)
    if cfg.vision_tokens:
        kw.update(vision_tokens=16, vision_dim=32)
    if cfg.frontend_dim:
        kw.update(frontend_dim=64)
    return cfg.with_(**kw).with_(name=cfg.name + "-smoke")


__all__ = ["ArchConfig", "LayerSpec", "Stage", "ShapeConfig", "SHAPES", "build_stages",
           "cell_skip_reason", "REGISTRY", "ASSIGNED", "get_config", "reduce_config"]
