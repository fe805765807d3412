"""deepseek-67b — dense llama-arch GQA.

[arXiv:2401.02954; hf] 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
Carried so the reduced (GQA) form is covered; the full size is not served.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
)
