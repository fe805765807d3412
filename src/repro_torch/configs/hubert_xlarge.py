"""hubert-xlarge — encoder-only audio transformer (wav2vec2 arch).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (the masked-prediction target codebook).  The CNN waveform
frontend is a stub, as in the JAX package: callers pass precomputed frame
embeddings (B, T, 1280).  Encoder-only: self-attention is bidirectional
and there is no autoregressive decode.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    kind="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    norm_type="layernorm",
    audio_frontend=True,
    frontend_dim=1280,
)
