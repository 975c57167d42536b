"""whisper-medium — encoder-decoder audio model, conv frontend STUB
[arXiv:2212.04356; unverified].

Per the assignment the modality frontend is a stub: ``input_specs()``
supplies precomputed (post-conv) frame embeddings for the encoder.
24 encoder + 24 decoder layers, MHA (kv=16 = heads).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,               # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    gated_ffn=False,           # classic GELU MLP
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-medium-smoke", n_layers=2, encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
