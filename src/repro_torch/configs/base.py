"""Model/arch configuration system.

Each assigned architecture gets one module in ``repro/configs/`` exporting
``CONFIG`` (exact published numbers) and ``SMOKE_CONFIG`` (same family,
reduced).  ``repro.configs.registry`` maps ``--arch <id>`` to them.

Families:
  dense  — decoder-only transformer (GQA / MQA / qk-norm variants)
  moe    — decoder-only with routed expert FFNs (periodic or every layer)
  vlm    — dense decoder with early-fusion patch embeddings (stub frontend)
  hybrid — Mamba/attention interleave with periodic MoE (Jamba)
  audio  — encoder-decoder with conv-frontend stub (Whisper)
  ssm    — attention-free Mamba-1 stack
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # None -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    gated_ffn: bool = True            # SwiGLU (3 mats) vs classic MLP (2 mats)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width (0 -> d_ff)
    moe_every: int = 1                # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    shared_expert: bool = False       # llama4-style shared expert alongside routed
    capacity_factor: float = 1.25
    moe_group_size: int = 1024        # tokens per routing group

    # --- hybrid / ssm ---
    attn_every: int = 0               # 0 -> all attention; k -> attention at i%k==attn_offset
    attn_offset: int = 0
    ssm_state: int = 0
    d_inner_mult: int = 2
    dt_rank: int = 0                  # 0 -> d_model // 16
    conv_width: int = 4

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0           # >0 -> enc-dec; n_layers = decoder layers

    # --- vlm ---
    vision_patches: int = 0           # early-fusion patch embeds per sample (stub)

    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""          # "" = model dtype; "int8" = quantized
                                      # KV cache with per-token-head scales

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank if self.dt_rank else max(self.d_model // 16, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k cells run."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Sequence mixer of layer i: 'attn' or 'mamba'."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """FFN of layer i: 'dense' | 'moe' | 'none'."""
        if self.family == "ssm":
            return "none"                      # mamba block subsumes the FFN
        if self.n_experts and i % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def scan_period(self) -> int:
        """Smallest layer period with a homogeneous parameter structure —
        the unit we stack and ``lax.scan`` over (DESIGN.md §5)."""
        p = 1
        if self.family == "hybrid":
            p = self.attn_every
        if self.n_experts:
            import math
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by period {p}")
        return p

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        c = self
        d, hd = c.d_model, c.hd
        n = c.vocab_size * d                               # embed
        if not c.tie_embeddings:
            n += d * c.vocab_size                          # lm_head
        def attn_params():
            return d * (c.n_heads * hd) + 2 * d * (c.n_kv_heads * hd) \
                + (c.n_heads * hd) * d
        n_ffn_mats = 3 if c.gated_ffn else 2
        def dense_ffn():
            return n_ffn_mats * d * c.d_ff
        def moe_ffn():
            f = c.moe_d_ff or c.d_ff
            p = c.n_experts * n_ffn_mats * d * f + d * c.n_experts
            if c.shared_expert:
                p += n_ffn_mats * d * (c.d_ff or f)
            return p
        def mamba_block():
            di, s, dtr = c.d_inner, c.ssm_state, c.dtr
            return (d * 2 * di            # in_proj (x, z)
                    + di * c.conv_width   # depthwise conv
                    + di * (dtr + 2 * s)  # x_proj
                    + dtr * di + di       # dt_proj
                    + di * s + di         # A_log, D
                    + di * d)             # out_proj
        layers = list(range(c.n_layers))
        for i in layers:
            n += mamba_block() if self.layer_kind(i) == "mamba" else attn_params()
            fk = self.ffn_kind(i)
            if fk == "dense":
                n += dense_ffn()
            elif fk == "moe":
                n += moe_ffn()
            n += 2 * d                                     # 2 norms / layer
        if c.encoder_layers:
            for _ in range(c.encoder_layers):
                n += attn_params() + dense_ffn() + 2 * d
            n += c.n_layers * (attn_params() + d)          # decoder cross-attn + norm
        n += d                                             # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed k of E)."""
        if not self.n_experts:
            return self.param_count()
        c = self
        f = c.moe_d_ff or c.d_ff
        n_ffn_mats = 3 if c.gated_ffn else 2
        inactive_frac = (c.n_experts - c.experts_per_token) * n_ffn_mats * c.d_model * f
        n_moe_layers = sum(1 for i in range(c.n_layers) if self.ffn_kind(i) == "moe")
        return self.param_count() - n_moe_layers * inactive_frac


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(config: ModelConfig) -> Tuple[str, ...]:
    """Shape cells that run for this arch (skips recorded in DESIGN.md)."""
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not config.supports_long_context:
            continue                   # quadratic attention @ 524k: skip
        out.append(name)
    return tuple(out)
