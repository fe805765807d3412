"""llama-3.2-vision-11b — decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256; every 5th layer carries an image
cross-attention sub-block.  The vision tower is a stub, as in the JAX
package: callers pass precomputed patch embeddings (1601 tokens of width
1280, the ViT-H/14 at 560 px convention), which the backbone projects to
d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    cross_every=5,
    vision_tokens=1601,
    vision_dim=1280,
)
