"""llama4-maverick-400b-a17b — MoE 128e top-1, alternating dense/MoE layers,
shared expert, early fusion [hf:meta-llama/Llama-4-Maverick; unverified].

The assignment gives 48L d_model=5120 40H (kv=8) d_ff=8192, 128 experts
top-1.  Matching the published ~400B-total/17B-active budget requires the
real model's interleaved MoE (every 2nd layer routed, plus one shared
expert per MoE layer); dense layers use the same d_ff.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    n_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_every=2,               # alternating dense / MoE
    moe_offset=1,
    shared_expert=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, n_experts=8,
    experts_per_token=1, moe_d_ff=128, moe_group_size=64)
