"""mamba2-130m — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; unverified] 24L d_model=768 vocab=50280 ssm_state=128.
d_inner = 2 x 768 = 1536, headdim 64 -> 24 SSD heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
)
