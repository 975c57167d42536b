"""jamba-1.5-large-398b — hybrid Mamba+attention 7:1 interleave with
16-expert top-2 MoE on alternating layers [arXiv:2403.19887].

Layer period = 8: one attention layer per 8 (position 4, as in the
published Jamba block), Mamba elsewhere; MoE FFN every 2nd layer.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    d_inner_mult=2,
    conv_width=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="jamba-1.5-large-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, n_experts=4,
    experts_per_token=2, moe_d_ff=128, ssm_state=8, moe_group_size=64)
