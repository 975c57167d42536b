"""qwen3-1.7b — dense GQA with qk-norm [hf:Qwen/Qwen3-1.7B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-1.7b-smoke", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
    head_dim=16, d_ff=256, vocab_size=512)
