"""granite-34b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    gated_ffn=False,           # GPT-BigCode-style 2-matrix FFN
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-34b-smoke", n_layers=4, d_model=128, n_heads=8, n_kv_heads=1,
    head_dim=16, d_ff=256, vocab_size=512)
