"""Transformer building blocks: RMSNorm, RoPE, GQA attention (chunked over
queries, with a position-based mask), gated/classic MLP.

The reference's attention is plain jnp (no Pallas kernel), so the port's
is plain tensor ops in the same formulation: scores in float32 per query
chunk, softmax, probabilities cast to ``v``'s type.  It does not call
``scaled_dot_product_attention``, whose fused paths accumulate
differently and take no position mask.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s type, then
    scaled by ``w``."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding on non-interleaved halves.  x: [..., S, H, D];
    positions: [..., S]; angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_one_q_chunk(q_c, k, v, q_pos_c, kv_pos, scale, causal):
    """q_c: [B, Cq, KV, G, D]; k/v: [B, S, KV, D] -> [B, Cq, KV, G, D].
    Scores are float32 (the reference's ``preferred_element_type``)."""
    s = torch.einsum("bqkgd,bskd->bqkgs", q_c.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = kv_pos[:, None, :] <= q_pos_c[:, :, None]         # [B, Cq, S]
        s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype), v)


def attention(
    q: torch.Tensor,                 # [B, Sq, H, D]
    k: torch.Tensor,                 # [B, Skv, KV, D]
    v: torch.Tensor,                 # [B, Skv, KV, D]
    q_positions: torch.Tensor,       # [B, Sq] int
    kv_positions: torch.Tensor,      # [B, Skv] int (cache layout order)
    causal: bool = True,
    q_chunk: int = 512,
) -> torch.Tensor:
    """GQA attention, chunked over the query axis: each chunk of
    ``q_chunk`` queries attends to the full K/V, so scores are [B, Cq, H,
    Skv], never [Sq, Skv].  Masking is by position, so it holds for
    prefill (q_pos == kv_pos) and for a decode cache alike.  ``Sq`` above
    ``q_chunk`` must be a multiple of it (``ValueError``)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = d ** -0.5
    qg = q.reshape(b, sq, kv, g, d)

    if sq <= q_chunk:
        out = _attn_one_q_chunk(qg, k, v, q_positions, kv_positions, scale,
                                causal)
        return out.reshape(b, sq, h, d)

    if sq % q_chunk:
        raise ValueError(f"Sq={sq} not divisible by q_chunk={q_chunk}")
    outs = [_attn_one_q_chunk(qg[:, i:i + q_chunk], k, v,
                              q_positions[:, i:i + q_chunk], kv_positions,
                              scale, causal)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(b, sq, h, d)


def mlp(x, w_in, w_gate, w_out, gated: bool = True):
    """SwiGLU (gated) or classic MLP with the tanh-approximate GELU (the
    default of ``jax.nn.gelu``).  x: [..., d]."""
    h = x @ w_in
    if gated:
        h = F.silu(x @ w_gate) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ w_out
