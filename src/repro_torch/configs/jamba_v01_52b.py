"""jamba-v0.1-52b — hybrid Mamba + attention (1:7) with MoE every other layer.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2.  The SSM block uses the Mamba-2 SSD formulation (Jamba
v0.1 shipped Mamba-1), as the JAX package's config does.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_every=2,
    ssm_every=8,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
)
