"""Decoder-only LM; the port so far covers the attention-free ssm family
(a stack of Mamba-1 blocks, e.g. falcon-mamba-7b).

Where the reference stacks layers per scan period and iterates them with
``lax.scan``, the port holds one :class:`MambaBlock` per layer in an
``nn.ModuleList`` and loops over them in Python; the reference's
``shard`` annotations and remat policies have no counterpart without a
mesh.  Three modes share one code path:

  train    — full-sequence causal forward, no cache;
  prefill  — train-like forward that also emits the SSM cache;
  decode   — single-token step against that cache.

Configurations with attention or MoE layers (the dense, moe, vlm,
hybrid and audio families) raise ``NotImplementedError``: they are
ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import rms_norm
from .mamba import MambaCache, mamba_mixer

MODES = ("train", "prefill", "decode")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is a Mamba block with no FFN."""
    kinds = {(cfg.layer_kind(i), cfg.ffn_kind(i))
             for i in range(cfg.n_layers)}
    if cfg.family == "audio" or cfg.vision_patches or kinds != {
            ("mamba", "none")}:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port runs the ssm family only; "
            "attention, MoE, vision and audio layers are ROADMAP queue 1 "
            "item 7")


# ----------------------------------------------------------------------
# Parameter specification: leaf name -> (shape, logical axes, fan_in axis)
# ----------------------------------------------------------------------

def _mamba_specs(cfg: ModelConfig) -> Dict[str, Tuple]:
    d, di, s, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    return {
        "ln1": ((d,), ("embed_act",), None),
        "in_proj": ((d, 2 * di), ("embed", "inner"), 0),
        "conv_w": ((di, cfg.conv_width), ("inner", None), None),
        "conv_b": ((di,), ("inner",), None),
        "x_proj": ((di, dtr + 2 * s), ("inner", None), 0),
        "dt_proj_w": ((dtr, di), (None, "inner"), 0),
        "dt_proj_b": ((di,), ("inner",), None),
        "A_log": ((di, s), ("inner", "state"), None),
        "D": ((di,), ("inner",), None),
        "out_proj": ((di, d), ("inner", "embed"), 0),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    """Spec tree of (shape, logical_axes, fan_in_axis), with one entry of
    ``blocks`` per layer."""
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict = {
        "embed": ((v, d), ("vocab", "embed"), 1),
        "final_norm": ((d,), ("embed_act",), None),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), ("embed", "vocab"), 0)
    tree["blocks"] = [_mamba_specs(cfg) for _ in range(cfg.n_layers)]
    return tree


# ----------------------------------------------------------------------
# Cache
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device) -> Dict:
    """Per-layer cache; ``index`` is the fill pointer.  A Mamba layer's
    cache does not grow with the sequence."""
    blocks = [{
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    } for _ in range(cfg.n_layers)]
    return {"blocks": blocks,
            "index": torch.zeros((batch,), dtype=torch.int32,
                                 device=device)}


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def _frozen(t: torch.Tensor) -> nn.Parameter:
    # serving only: no autograd graph (the scan kernel has no backward yet)
    return nn.Parameter(t, requires_grad=False)


class MambaBlock(nn.Module):
    """One residual Mamba sublayer: ``h + mixer(rms_norm(h))``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor]
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            self.register_parameter(name, _frozen(t))

    def forward(self, h: torch.Tensor, cache_in: Optional[Dict], mode: str
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        x = rms_norm(h, self.ln1, cfg.norm_eps)
        cache = None
        if mode == "decode":
            cache = MambaCache(conv=cache_in["conv"], ssm=cache_in["ssm"])
        out, new_cache = mamba_mixer(
            x, self._parameters, ssm_state=cfg.ssm_state,
            conv_width=cfg.conv_width, dt_rank=cfg.dtr, cache=cache,
            return_cache=(mode == "prefill"))
        nc = None
        if new_cache is not None:
            nc = {"conv": new_cache.conv, "ssm": new_cache.ssm}
        return h + out, nc


class Transformer(nn.Module):
    """The LM's parameters and forward pass (``params`` of the reference's
    functional API)."""

    def __init__(self, cfg: ModelConfig, params: Dict) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = _frozen(params["lm_head"]) \
            if "lm_head" in params else None
        self.blocks = nn.ModuleList(MambaBlock(cfg, p)
                                    for p in params["blocks"])

    def forward(self, tokens: torch.Tensor, *, cache: Optional[Dict] = None,
                mode: str = "train") -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens int[B, S] -> (logits [B, S, V], new_cache or None)."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}, expected one of {MODES}")
        if mode == "decode" and cache is None:
            raise ValueError("decode needs a cache")
        cfg = self.cfg
        b, s = tokens.shape
        h = self.embed[tokens]
        caches_in: List = cache["blocks"] if mode == "decode" \
            else [None] * len(self.blocks)
        caches_out = []
        for block, cin in zip(self.blocks, caches_in):
            h, nc = block(h, cin, mode)
            caches_out.append(nc)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        logits = h @ (self.embed.t() if self.lm_head is None
                      else self.lm_head)

        new_cache = None
        if mode == "prefill":
            new_cache = {"blocks": caches_out,
                         "index": torch.full((b,), s, dtype=torch.int32,
                                             device=tokens.device)}
        elif mode == "decode":
            new_cache = {"blocks": caches_out, "index": cache["index"] + 1}
        return logits, new_cache
