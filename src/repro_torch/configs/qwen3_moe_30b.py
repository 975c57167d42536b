"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, GQA, qk-norm
[hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=6144,                 # unused: every FFN is MoE (moe_every=1)
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_every=1,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-30b-a3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, n_experts=8,
    experts_per_token=2, moe_d_ff=32, moe_group_size=64)
