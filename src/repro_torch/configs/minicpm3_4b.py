"""minicpm3-4b — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA ranks follow the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73_448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)
