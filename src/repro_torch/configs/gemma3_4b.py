"""gemma3-4b — dense, 5:1 local:global sliding-window GQA with qk-norm.

[hf:google/gemma-3-1b-pt; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, 5 local (window 1024) per 1 global layer,
head_dim 256 (8 x 256 = 2048, o-proj back to d_model), GeGLU FFN, tied
embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    local_global_pattern=5,
    window_size=1024,
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    tie_embeddings=True,
)
