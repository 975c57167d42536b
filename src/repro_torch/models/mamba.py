"""Mamba-1 block (selective SSM) — attention-free sequence mixer.

Train and prefill run the selective scan through ``kernels.ops`` (the
CUDA kernel for CUDA tensors, its plain version on the CPU); decode is
a single-step state update in plain tensor ops (O(1) per token), as in
the reference.  Weights keep the reference's layouts: ``in_proj [d,
2*di]``, ``conv_w [di, cw]``, ``x_proj [di, dtr + 2*S]``, ``dt_proj_w
[dtr, di]``, ``A_log [di, S]``, ``out_proj [di, d]``.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding import local_shard, shard, weight_for


class MambaCache(NamedTuple):
    conv: torch.Tensor      # [B, cw-1, di]   last conv inputs
    ssm: torch.Tensor       # [B, di, S]      SSM hidden state (f32)


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """u: [B, T, di]; w: [di, cw]; left-padded causal depthwise conv,
    written as the reference's sum of shifted products (no cuDNN, so no
    TF32 on the card).  DTensors (the dry-run) convolve on each device's
    shards: batch rows and channels are independent, so ``u`` keeps its
    batch and channel shards, is gathered along the sequence, and ``w``
    and ``b`` follow the channels."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(u, DTensor):
        mesh = u.device_mesh
        up = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                   else Replicate() for p in u.placements)
        cp = tuple(Shard(0) if p == Shard(2) else Replicate() for p in up)

        out = _causal_depthwise_conv(local_shard(u, mesh, up),
                                     local_shard(w, mesh, cp),
                                     local_shard(b, mesh, cp))
        return DTensor.from_local(out, mesh, up, run_check=False)
    cw = w.shape[1]
    out = u * w[:, -1]
    for i in range(1, cw):
        shifted = F.pad(u, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[:, -1 - i]
    return out + b


def _dt_product(dt_r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dt_r @ w`` (``dt_r [..., dtr]``, ``w [dtr, di]``).  DTensors (the
    dry-run) multiply on each device's shards, as the depthwise conv does:
    ``dt_r`` keeps its batch shards and is gathered (summed, where it is a
    partial sum) along the rest, ``w`` keeps its channel shards on the
    mesh dims that do not shard the batch, and the product is sharded
    like both.  DTensor's own placement of this product needs a
    redistribution that some torch versions do not have."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dt_r, DTensor):
        return dt_r @ w
    mesh = dt_r.device_mesh
    wpl = w.placements if isinstance(w, DTensor) else \
        (Replicate(),) * mesh.ndim
    xp = tuple(Shard(0) if p == Shard(0) else Replicate()
               for p in dt_r.placements)
    wp = tuple(Shard(1) if p == Shard(1) and x != Shard(0) else Replicate()
               for p, x in zip(wpl, xp))
    out = tuple(x if x == Shard(0) else
                Shard(dt_r.ndim - 1) if p == Shard(1) else Replicate()
                for x, p in zip(xp, wp))
    prod = local_shard(dt_r, mesh, xp) @ local_shard(w, mesh, wp)
    return DTensor.from_local(prod, mesh, out, run_check=False)


def mamba_mixer(
    x: torch.Tensor,                    # [B, T, d] (post-norm)
    p: Mapping[str, torch.Tensor],
    *,
    ssm_state: int,
    conv_width: int,
    dt_rank: int,
    cache: Optional[MambaCache] = None,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    t = x.shape[1]
    in_proj = shard(p["in_proj"], "embed", "inner")
    u, z = (x @ weight_for(x, in_proj)).chunk(2, dim=-1)  # [B, T, di]
    split = [dt_rank, ssm_state, ssm_state]
    A = -torch.exp(p["A_log"].to(torch.float32))         # [di, S]

    if cache is not None and t == 1:
        # ---- decode: O(1) per-token update --------------------------
        conv_in = torch.cat([cache.conv, u], dim=1)      # [B, cw, di]
        u1 = torch.einsum("bcd,dc->bd", conv_in, p["conv_w"]) + p["conv_b"]
        u1 = F.silu(u1)                                  # [B, di]
        dt_r, B_s, C_s = torch.split(u1 @ p["x_proj"], split, dim=-1)
        dt = F.softplus(_dt_product(dt_r, p["dt_proj_w"]) + p["dt_proj_b"])
        dt = dt.to(torch.float32)[..., None]             # [B, di, 1]
        uf = u1.to(torch.float32)
        h = torch.exp(dt * A) * cache.ssm \
            + dt * B_s.to(torch.float32)[:, None, :] * uf[..., None]
        y = torch.einsum("bds,bs->bd", h, C_s.to(torch.float32)) \
            + p["D"] * uf
        y = y.to(x.dtype)[:, None, :]                    # [B, 1, di]
        new_cache = MambaCache(conv=conv_in[:, 1:, :], ssm=h)
    else:
        # ---- train / prefill: the selective-scan kernel --------------
        u1 = F.silu(_causal_depthwise_conv(u, p["conv_w"], p["conv_b"]))
        dt_r, B_s, C_s = torch.split(u1 @ weight_for(u1, p["x_proj"]),
                                     split, dim=-1)
        dt = F.softplus(_dt_product(dt_r, p["dt_proj_w"]) + p["dt_proj_b"])
        y, h_last = ops.selective_scan(u1, dt, A, B_s.contiguous(),
                                       C_s.contiguous(), p["D"])
        y = y.to(x.dtype)
        new_cache = None
        if return_cache:
            cw = conv_width
            # a copy: a view would keep the whole [B, T, 2*di] alive
            tail = u[:, -(cw - 1):, :].contiguous() if t >= cw - 1 \
                else F.pad(u, (0, 0, cw - 1 - t, 0))
            new_cache = MambaCache(conv=tail, ssm=h_last)

    g = y * F.silu(z)
    out = g @ weight_for(g, shard(p["out_proj"], "inner", "embed"))
    return out, new_cache
