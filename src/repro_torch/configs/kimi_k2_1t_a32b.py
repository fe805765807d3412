"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8).

[arXiv:2501.kimi2; unverified, paper-table] 61L d_model=7168 64H (GQA kv=8)
expert d_ff=2048 vocab=163840, MoE 384e top-8, every layer MoE.  Its layer
is the unsharded capacity-routed ``moe_forward`` (no ``moe_shard_map``);
the full model (1.042 T parameters) fits no single card.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163_840,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    moe_every=1,
)
