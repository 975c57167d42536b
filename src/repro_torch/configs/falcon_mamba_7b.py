"""falcon-mamba-7b — attention-free Mamba-1 stack [arXiv:2410.05355;
unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                 # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_inner_mult=2,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="falcon-mamba-7b-smoke", n_layers=4, d_model=64, vocab_size=256,
    ssm_state=8)
