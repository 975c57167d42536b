"""internlm2-20b — dense GQA [arXiv:2403.17297]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="internlm2-20b-smoke", n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
    head_dim=16, d_ff=256, vocab_size=512)
