"""Transformer building blocks.  The port so far needs only RMSNorm (the
Mamba stack); RoPE, attention and the MLP arrive with the dense family.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s type, then
    scaled by ``w``."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w
