"""internvl2-76b — InternViT frontend (STUB) + Llama3-70B-class LM backbone
[arXiv:2404.16821; unverified].

Per the assignment, only the transformer BACKBONE is modeled; the vision
frontend is a stub — ``input_specs()`` supplies precomputed patch
embeddings which are early-fused (concatenated) with token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    vision_patches=256,
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-76b-smoke", n_layers=4, d_model=128, n_heads=8,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512, vision_patches=16)
