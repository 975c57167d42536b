"""Transformer building blocks: RMSNorm, RoPE, GQA attention (chunked over
queries, with a position-based mask), gated/classic MLP.

The reference's attention is plain jnp (no Pallas kernel), so the port's
is plain tensor ops in the same formulation: scores in float32 per query
chunk, softmax, probabilities cast to ``v``'s type.  It does not call
``scaled_dot_product_attention``, whose fused paths accumulate
differently and take no position mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import local_shard, shard, weight_for

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
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _attention_sharded(q, k, v, q_positions, kv_positions,
                                  causal, q_chunk)
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


def _attention_sharded(q, k, v, q_positions, kv_positions, causal,
                       q_chunk):
    """``attention`` of DTensors on each device's shards, as a sharded
    compiler partitions it: batch rows, query positions and query heads
    are independent, so ``q``'s batch (dim 0), query (dim 1) and head
    (dim 2) shardings are kept, and a mesh dim on which ``q`` is
    replicated or partial splits the heads where they divide.  ``k`` and
    ``v`` follow the batch and are gathered along their sequence; they
    follow the heads where their KV heads split as the query heads do,
    else each device takes the KV heads of its own query heads (a shard
    of query heads that is a whole number of KV groups, or lies in one).
    Positions follow the rows.  The output is placed as the computation:
    batch, query and head shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    heads, kvh = q.shape[2], k.shape[2]
    group = heads // kvh
    dims = [p.dim if isinstance(p, Shard) and p.dim in (0, 1, 2) else None
            for p in q.placements]

    def head_shards(dims):
        return math.prod(mesh.size(j) for j, d in enumerate(dims) if d == 2)

    def fits(n):          # n shards of the query heads, each in KV groups
        per = heads // n
        return heads % n == 0 and (per % group == 0 or group % per == 0)
    for m, dim in enumerate(dims):
        if dim == 2 and not fits(head_shards(dims)):
            dims[m] = None
    for m, dim in enumerate(dims):
        if dim is None and fits(head_shards(dims) * mesh.size(m)):
            dims[m] = 2
    n = head_shards(dims)
    kv_split = kvh % n == 0
    qp = [Shard(d) if d is not None else Replicate() for d in dims]
    kp = [Shard(d) if d == 0 or (d == 2 and kv_split) else Replicate()
          for d in dims]
    qpos = [Shard(p.dim) if isinstance(p, Shard) and p.dim < 2
            else Replicate() for p in qp]
    kpos = [Shard(0) if isinstance(p, Shard) and p.dim == 0
            else Replicate() for p in kp]

    local = lambda t, placements: local_shard(t, mesh, placements)
    k_loc, v_loc = local(k, kp), local(v, kp)
    if not kv_split:
        # this device's rank among the head shards (mesh order, the
        # first mesh dim outermost), and the KV heads of its query heads
        coord, r = mesh.get_coordinate(), 0
        for j, d in enumerate(dims):
            if d == 2:
                r = r * mesh.size(j) + coord[j]
        per = heads // n
        lo, hi = r * per // group, ((r + 1) * per - 1) // group + 1
        k_loc, v_loc = k_loc[:, :, lo:hi], v_loc[:, :, lo:hi]
    out = attention(local(q, qp), k_loc, v_loc, local(q_positions, qpos),
                    local(kv_positions, kpos), causal, q_chunk)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: the rows of ``table`` [V, ...] at ``idx``.  With
    DTensors (the dry-run) the lookup runs on each device's shards
    (:class:`_Lookup`): the table is gathered whole, as a sharded
    compiler gathers a sharded embedding, ``idx`` keeps its batch
    shards, and the table's gradient is reduced back to its shards."""
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor) or isinstance(idx, DTensor):
        return _Lookup.apply(table, idx)
    return table[idx]


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = (table if isinstance(table, DTensor) else idx).device_mesh
        rep = (Replicate(),) * mesh.ndim
        if not isinstance(table, DTensor):
            table = DTensor.from_local(table, mesh, rep, run_check=False)
        place = tuple(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate() for p in getattr(idx, "placements",
                                                        rep))
        ctx.mesh, ctx.place, ctx.table = mesh, place, (
            table.placements, table.shape, table.dtype)
        local_idx = local_shard(idx, mesh, place)
        ctx.save_for_backward(local_idx)
        rows = local_shard(table, mesh, rep)[local_idx]
        return DTensor.from_local(rows, mesh, place, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        (local_idx,) = ctx.saved_tensors
        placements, shape, dtype = ctx.table
        g = grad.redistribute(ctx.mesh, ctx.place).to_local()
        full = torch.zeros(shape, dtype=dtype, device=g.device)
        full.index_put_((local_idx,), g.to(dtype), accumulate=True)
        part = tuple(Partial() if p != Replicate() else Replicate()
                     for p in ctx.place)
        gt = DTensor.from_local(full, ctx.mesh, part, run_check=False)
        return gt.redistribute(ctx.mesh, placements), None


def mlp(x, w_in, w_gate, w_out, gated: bool = True):
    """SwiGLU (gated) or classic MLP with the tanh-approximate GELU (the
    default of ``jax.nn.gelu``).  x: [..., d]."""
    h = x @ weight_for(x, w_in)
    if gated:
        h = F.silu(x @ weight_for(x, w_gate)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = shard(h, "batch", "seq", "mlp")
    return h @ weight_for(h, w_out)
