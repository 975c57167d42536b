"""smollm-360m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-360M]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="smollm-360m-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=256)
