"""Mixture-of-Experts FFN: sort-based grouped dispatch.

Tokens are processed in fixed-size routing groups; within a group the
(token, expert) slots are sorted by expert id (stable, so an expert's
slots come in token order), truncated to a per-expert capacity, gathered
into an ``[E, C, d]`` buffer, pushed through batched expert products and
combined back weighted by the gate probabilities, as in the reference's
``models/moe.py``.  The reference's MoE is plain jnp with no Pallas
kernel, so this is plain tensor ops: the expert products are batched
products over the experts (``torch.bmm``), the sort and the gathers are
torch ops.

The combine adds each token's contributions in ascending expert id, each
add rounded to the activations' type: the order of the reference's
scatter-add, and deterministic on the card (no atomics), so a bf16
forward gives the same bits run after run.

Under sharding rules (the dry-run's DTensors) the routing, the dispatch
gather and the combine run on each device's own routing groups
(:func:`_per_group`): top-k, the sorts and ``searchsorted`` have no
DTensor sharding strategy, and they never mix groups.  The expert
products run on the ``[E, G·C, d]`` buffer, which holds the groups'
capacity slots side by side; it is annotated as ``[E, G, C, d]``,
``("experts", "groups", "cap", None)``: the reference's ``("experts",
"cap", None)`` per group, with the group axis that the reference's
``vmap`` leaves to the partitioner kept on the groups' shard.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import local_shard, shard, splittable, weight_for
from .layers import mlp


class MoEParams(NamedTuple):
    router: torch.Tensor          # [d, E]
    w_in: torch.Tensor            # [E, d, f]
    w_gate: torch.Tensor          # [E, d, f] (unused when not gated)
    w_out: torch.Tensor           # [E, f, d]
    shared_w_in: Optional[torch.Tensor] = None     # [d, f_s]
    shared_w_gate: Optional[torch.Tensor] = None
    shared_w_out: Optional[torch.Tensor] = None


def capacity_for(group_size: int, k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(group_size * k / n_experts * cf))
    return max(c, 4)


def group_size_for(tot: int, group_size: int) -> int:
    """Tokens per routing group for ``tot`` tokens: ``group_size``, or
    fewer, halved until it divides ``tot`` (the reference's loop: 2000
    tokens in groups of 1024 give groups of 16)."""
    tg = min(group_size, tot)
    if tot % tg:
        while tot % tg:
            tg //= 2
        tg = max(tg, 1)
    return tg


def route(x: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] -> (gates f32 [..., k], expert ids int64 [..., k]):
    float32 logits, softmax, top-k, gates renormalised by
    ``max(sum, 1e-9)``."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i


def _expert_ffn(xe, p: MoEParams, gated: bool):
    """xe [E, T, d] -> [E, T, d] through each expert's FFN."""
    h = torch.bmm(xe, weight_for(xe, p.w_in))
    if gated:
        h = F.silu(torch.bmm(xe, weight_for(xe, p.w_gate))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, weight_for(h, p.w_out))


def _per_group(fn, xg, *grouped, shared=()):
    """``fn(xg, *grouped, *shared)``, where ``xg``, ``grouped`` and every
    output lead with the routing-group axis, on each device's own groups
    when ``xg`` is a DTensor: ``xg`` and ``grouped`` are placed as ``xg``
    is on its group axis and replicated on the other mesh dims, ``shared``
    is replicated, ``fn`` runs on the local shards, and each output is a
    DTensor placed as ``xg``.  Plain tensors run ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(xg, DTensor):
        return fn(xg, *grouped, *shared)
    mesh = xg.device_mesh
    place = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                  else Replicate() for pl in xg.placements)

    rep = (Replicate(),) * mesh.ndim
    outs = fn(local_shard(xg, mesh, place),
              *(local_shard(a, mesh, place) for a in grouped),
              *(local_shard(a, mesh, rep) for a in shared))
    wrap = lambda t: DTensor.from_local(t, mesh, place, run_check=False)
    if isinstance(outs, tuple):
        return tuple(wrap(t) for t in outs)
    return wrap(outs)


def _dispatch(xg: torch.Tensor, router: torch.Tensor, k: int, cap: int):
    """Route each group's tokens and gather its expert buffer: (xe [G,
    E, C, d], disp_gate [G, E*C], by_slot [G, Tg, k] (each token's k
    slots by ascending expert id, E*C for a dropped one))."""
    g, tg, d = xg.shape
    e = router.shape[1]
    dev, n = xg.device, tg * k
    top_p, top_i = route(xg, router, k)                      # [G, Tg, k]
    eid = top_i.reshape(g, n)
    gate = top_p.reshape(g, n).to(xg.dtype)

    order = torch.argsort(eid, dim=-1, stable=True)          # [G, n]
    s_eid = torch.gather(eid, 1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    seg_start = torch.searchsorted(s_eid, experts, side="left")
    pos = torch.arange(n, device=dev) - torch.gather(seg_start, 1, s_eid)
    # dropped slots go to the trash index E*C; empty slots point at the
    # pad row tg
    dest = torch.where(pos < cap, s_eid * cap + pos,
                       torch.full_like(pos, e * cap))
    disp_tok = torch.full((g, e * cap + 1), tg, dtype=torch.int64,
                          device=dev).scatter_(1, dest, order // k)
    disp_gate = torch.zeros((g, e * cap + 1), dtype=xg.dtype,
                            device=dev).scatter_(
                                1, dest, torch.gather(gate, 1, order))
    disp_tok, disp_gate = disp_tok[:, :-1], disp_gate[:, :-1]

    x_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)  # [G, Tg+1, d]
    rows = disp_tok + torch.arange(g, device=dev)[:, None] * (tg + 1)
    xe = x_pad.reshape(g * (tg + 1), d)[rows.reshape(-1)]    # [G*E*C, d]
    # the combine's order: each token's k slots by ascending expert id;
    # a dropped slot reads the zero row E*C
    by_slot = torch.empty_like(dest).scatter_(1, order, dest)
    by_slot = by_slot.reshape(g, tg, k)
    by_slot = torch.gather(by_slot, 2, torch.argsort(top_i, dim=-1))
    return xe.reshape(g, e, cap, d), disp_gate, by_slot


def _combine(ye: torch.Tensor, disp_gate: torch.Tensor,
             by_slot: torch.Tensor) -> torch.Tensor:
    """ye [G, E, C, d] -> [G, Tg, d]: each token's slots weighted by
    their gates, added in ``by_slot``'s order."""
    g, e, cap, d = ye.shape
    tg, k = by_slot.shape[1:]
    dev = ye.device
    contrib = ye.reshape(g, e * cap, d) * disp_gate[..., None]
    contrib = torch.cat([contrib, contrib.new_zeros((g, 1, d))], dim=1)
    flat = (by_slot + torch.arange(g, device=dev)[:, None, None]
            * (e * cap + 1)).reshape(-1)
    picked = contrib.reshape(g * (e * cap + 1), d)[flat].reshape(g, tg, k, d)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]
    return out


def _grouped_moe(xg: torch.Tensor, p: MoEParams, k: int, cap: int,
                 gated: bool) -> torch.Tensor:
    """xg: [G, Tg, d], G routing groups -> [G, Tg, d]."""
    g, _tg, d = xg.shape
    e = p.router.shape[1]
    xe, disp_gate, by_slot = _per_group(
        lambda x, r: _dispatch(x, r, k, cap), xg, shared=(p.router,))
    xe = shard(xe.transpose(0, 1), "experts", "groups", "cap", None)
    ye = _expert_ffn(xe.reshape(e, g * cap, d), p, gated)    # [E, G*C, d]
    # the view splits G*C: its shards must divide G, as for the input
    ye = shard(splittable(ye, 1, g).reshape(e, g, cap, d), "experts",
               "groups", "cap", None)
    ye = ye.transpose(0, 1)                                  # [G, E, C, d]
    return _per_group(_combine, ye, disp_gate, by_slot)


def _groupable(x: torch.Tensor, g: int) -> torch.Tensor:
    """``x`` [B, S, d], placed so that its rows can be viewed as ``g``
    routing groups: a DTensor keeps its batch shards while their count
    divides ``g`` (in mesh order) and is gathered along the rest of the
    batch and the sequence; a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh, n, place = x.device_mesh, 1, []
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard):
            keep = p.dim == 0 and g % (n * mesh.size(m)) == 0
            n *= mesh.size(m) if keep else 1
            p = p if keep else Replicate()
        place.append(p)
    return x.redistribute(mesh, place)


def moe_ffn(x: torch.Tensor, p: MoEParams, *, k: int, n_experts: int,
            group_size: int, capacity_factor: float,
            gated: bool = True) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d] routed-expert FFN (+ optional shared)."""
    b, s, d = x.shape
    tot = b * s
    tg = group_size_for(tot, group_size)
    cap = capacity_for(tg, k, n_experts, capacity_factor)
    xg = shard(_groupable(x, tot // tg).reshape(tot // tg, tg, d),
               "groups", None, None)
    y = _grouped_moe(xg, p, k, cap, gated)
    y = y.reshape(b, s, d)
    if p.shared_w_in is not None:
        y = y + mlp(x, p.shared_w_in, p.shared_w_gate, p.shared_w_out, gated)
    return y


def moe_ffn_ref(x: torch.Tensor, p: MoEParams, *, k: int,
                gated: bool = True) -> torch.Tensor:
    """Naive per-token oracle (no capacity drops) for tests: every expert
    on every token, weighted by the routed gates, summed in float32."""
    b, s, d = x.shape
    e = p.router.shape[1]
    xt = x.reshape(-1, d)
    top_p, top_i = route(xt, p.router, k)

    def expert(i):
        h = xt @ p.w_in[i]
        if gated:
            h = F.silu(xt @ p.w_gate[i]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ p.w_out[i]
    ye = torch.stack([expert(i) for i in range(e)], dim=1)   # [T, E, d]
    w = torch.zeros((xt.shape[0], e), dtype=torch.float32,
                    device=x.device).scatter_(1, top_i, top_p)
    out = torch.einsum("ted,te->td", ye.to(torch.float32), w).to(x.dtype)
    if p.shared_w_in is not None:
        out = out + mlp(xt, p.shared_w_in, p.shared_w_gate, p.shared_w_out,
                        gated)
    return out.reshape(b, s, d)
