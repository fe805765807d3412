"""cgra-edge — the paper's own deployment target: a tiny f32 transformer
(BERT-tiny class) whose GEMMs run through the block-GEMM path."""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="cgra-edge",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=30_522,
    compute_dtype=torch.float32,
    fsdp=False,
)
