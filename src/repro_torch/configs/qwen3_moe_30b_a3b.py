"""qwen3-moe-30b-a3b — 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_every=1,
    use_qk_norm=True,
)
