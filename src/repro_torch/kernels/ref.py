"""Plain PyTorch versions of the CUDA kernels (the ``ref.py`` contract).

These are the semantic ground truth of the port's kernel layer: the
wrappers run them for tensors on the CPU, the tests hold them equal to
the JAX reference, and ``chip_smoke.py`` holds each CUDA kernel equal to
them on the card.  Arithmetic is pinned to the host's numpy float32
reconcile (``core/dispatchers/vectorized.py``): subtract as integers,
convert, divide correctly rounded, and sum over resource types in
r = 0..R-1 order — so Best-Fit ties break identically everywhere.
The selective scan is float32 and is held within a tolerance instead:
the kernel orders its sums differently.
"""
from __future__ import annotations

import torch


def _load_score(avail: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """score[n] = sum_r (cap - avail) / max(cap, 1), float32, in r order."""
    used = (capacity - avail).to(torch.float32)
    cap = torch.clamp(capacity, min=1).to(torch.float32)
    frac = used / cap
    score = frac[:, 0].clone()
    for r in range(1, frac.shape[1]):
        score = score + frac[:, r]
    return score


# ----------------------------------------------------------------------
# alloc_score: per-node fit mask + load score for one job request
# ----------------------------------------------------------------------
def alloc_score_ref(avail: torch.Tensor, capacity: torch.Tensor,
                    req: torch.Tensor):
    """avail/capacity: int32[N, R]; req: int32[R].

    Returns (fit int32[N], score f32[N]) where fit[n] = 1 iff node n can
    host one rank of the job, and score[n] = fraction-in-use summed over
    resource types (Best-Fit's busiest-first key, paper §3).
    """
    fit = (avail >= req[None, :]).all(dim=1).to(torch.int32)
    return fit, _load_score(avail, capacity)


# ----------------------------------------------------------------------
# alloc_score_batch: queue×node fit mask + load score in one shot
# ----------------------------------------------------------------------
def alloc_score_batch_ref(avail: torch.Tensor, capacity: torch.Tensor,
                          req: torch.Tensor):
    """avail/capacity: int32[N, R]; req: int32[J, R].

    Returns (fit int32[J, N], score f32[J, N]); the score is node n's
    load for every j, materialized [J, N] as the kernel writes it.
    """
    fit = (avail[None, :, :] >= req[:, None, :]).all(dim=2).to(torch.int32)
    score = _load_score(avail, capacity)
    return fit, score[None, :].expand(fit.shape).contiguous()


def pack_bits(fit: torch.Tensor) -> torch.Tensor:
    """fit [J, N] (0/1) -> int32[J, ceil(N/32)]: bit ``n % 32`` of word
    ``n // 32`` is ``fit[j, n]``, the tail bits past N are 0; the words
    are uint32 bit patterns held in int32."""
    j, n = fit.shape
    w = -(-n // 32)
    padded = torch.zeros((j, w * 32), dtype=torch.int64, device=fit.device)
    padded[:, :n] = fit.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=fit.device)
    words = (padded.view(j, w, 32) << shifts).sum(dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32[..., W] -> int32[..., n]."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    fit = (bits[..., None] >> shifts) & 1
    return fit.reshape(*bits.shape[:-1], -1)[..., :n].to(torch.int32)


def alloc_score_packed_ref(avail: torch.Tensor, capacity: torch.Tensor,
                           req: torch.Tensor):
    """The CUDA kernel's output layout: ``alloc_score_batch_ref``'s fit
    mask run through :func:`pack_bits`, and the score once per node.

    Returns (fit_bits int32[J, ceil(N/32)], score f32[N]).
    """
    fit, _ = alloc_score_batch_ref(avail, capacity, req)
    return pack_bits(fit), _load_score(avail, capacity)


# ----------------------------------------------------------------------
# ebf_shadow: fit-count per release-prefix for EASY backfilling
# ----------------------------------------------------------------------
def ebf_shadow_ref(avail: torch.Tensor, deltas: torch.Tensor,
                   req: torch.Tensor):
    """avail: int32[N, R]; deltas: int32[M, N, R] (release deltas grouped
    by distinct estimated release time, ascending); req: int32[R].

    Returns fits int32[M]: the number of nodes that satisfy ``req`` after
    applying release prefixes 0..m.
    """
    cum = avail[None, :, :] + torch.cumsum(deltas, dim=0, dtype=torch.int32)
    fit = (cum >= req[None, None, :]).all(dim=2)
    return fit.sum(dim=1, dtype=torch.int32)


def ebf_shadow_sparse_ref(avail: torch.Tensor, node_ptr: torch.Tensor,
                          entry_m: torch.Tensor, entry_vec: torch.Tensor,
                          req: torch.Tensor, m: int):
    """The CUDA kernel's input layout: releases grouped by node (entries
    ``node_ptr[n] .. node_ptr[n+1]-1`` of node n, each a group index
    ``entry_m`` and a vector ``entry_vec [nnz, R]``), densified into
    ``deltas [m, N, R]`` and passed to :func:`ebf_shadow_ref`.  As in the
    kernel, malformed releases (pointers not rising from 0 to nnz, a group
    outside ``[0, m)`` or falling within a node) give counts of -1."""
    n, r = avail.shape
    nnz = entry_m.shape[0]
    counts = (node_ptr[1:] - node_ptr[:-1]).to(torch.int64)
    ok = (node_ptr[0] == 0 and node_ptr[-1] == nnz
          and not bool((counts < 0).any()))
    if ok:
        node = torch.repeat_interleave(torch.arange(n, device=avail.device),
                                       counts)
        falls = (entry_m[1:] < entry_m[:-1]) & (node[1:] == node[:-1])
        ok = nnz == 0 or (bool(entry_m.min() >= 0) and bool(entry_m.max() < m)
                          and not bool(falls.any()))
    if not ok:
        return torch.full((m,), -1, dtype=torch.int32, device=avail.device)
    deltas = torch.zeros((m, n, r), dtype=torch.int32, device=avail.device)
    deltas.index_put_((entry_m.to(torch.int64), node), entry_vec,
                      accumulate=True)
    return ebf_shadow_ref(avail, deltas, req)


# ----------------------------------------------------------------------
# selective_scan: Mamba-1 diagonal SSM recurrence
# ----------------------------------------------------------------------
def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """Sequential selective scan, computed in float32.

    u, delta: [Bt, L, Di]; A: [Di, S]; B, C: [Bt, L, S]; D: [Di].
    Returns (y f32[Bt, L, Di], h_last f32[Bt, Di, S]).

    Recurrence (ZOH discretization, diagonal A):
        dA_t = exp(delta_t[:, None] * A)            [Di, S]
        dB_t = delta_t[:, None] * B_t[None, :]      [Di, S]
        h_t  = dA_t * h_{t-1} + dB_t * u_t[:, None]
        y_t  = (h_t @ C_t) + D * u_t
    """
    u, delta, A, B, C, D = (x.to(torch.float32)
                            for x in (u, delta, A, B, C, D))
    bt, length, di = u.shape
    h = torch.zeros((bt, di, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(length):
        d_t = delta[:, t, :, None]                       # [Bt, Di, 1]
        h = torch.exp(d_t * A) * h + d_t * B[:, t, None, :] * u[:, t, :, None]
        ys.append((h * C[:, t, None, :]).sum(-1) + D * u[:, t])
    return torch.stack(ys, dim=1), h


def selective_scan_bwd_ref(u: torch.Tensor, delta: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: torch.Tensor, gy: torch.Tensor,
                           gh: torch.Tensor):
    """The selective scan's backward, computed in float32 by the explicit
    reverse recurrence (not autograd).

    ``gy`` [Bt, L, Di] and ``gh`` [Bt, Di, S] are the cotangents of ``y``
    and ``h_last``.  Returns (du, ddelta, dA, dB, dC, dD), each in its
    input's dtype.  With ``a_t = exp(delta_t A)`` and ``G_t`` the
    gradient of ``h_t``:
        G_{L-1} = gh + C_{L-1} gy_{L-1},  G_t = a_{t+1} G_{t+1} + C_t gy_t
        du_t     = D gy_t + delta_t sum_s G_t B_t
        ddelta_t = sum_s G_t (h_{t-1} a_t A + B_t u_t)
        dB_t     = sum_d G_t delta_t u_t,   dC_t = sum_d gy_t h_t
        dA = sum_{b,t} G_t h_{t-1} a_t delta_t,   dD = sum_{b,t} gy_t u_t
    """
    inputs = (u, delta, A, B, C, D)
    u, delta, A, B, C, D, gy, gh = (x.to(torch.float32) for x in
                                    (*inputs, gy, gh))
    bt, length, di = u.shape
    h = torch.zeros((bt, di, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    hs = []                                   # h_{t-1}, then h_{L-1}
    for t in range(length):
        hs.append(h)
        d_t = delta[:, t, :, None]
        h = torch.exp(d_t * A) * h + d_t * B[:, t, None, :] * u[:, t, :, None]
    hs.append(h)
    da = torch.exp(delta[..., None] * A)      # [Bt, L, Di, S]
    g = gh
    gs = [None] * length
    for t in reversed(range(length)):
        g = g + C[:, t, None, :] * gy[:, t, :, None]
        gs[t] = g
        g = da[:, t] * g
    G = torch.stack(gs, dim=1)                # [Bt, L, Di, S]
    h_prev = torch.stack(hs[:-1], dim=1)
    h_cur = torch.stack(hs[1:], dim=1)
    du = D * gy + delta * (G * B[:, :, None, :]).sum(-1)
    ddelta = (G * (h_prev * da * A + B[:, :, None, :] * u[..., None])).sum(-1)
    dB = (G * (delta * u)[..., None]).sum(2)
    dC = (gy[..., None] * h_cur).sum(2)
    dA = (G * h_prev * da * delta[..., None]).sum((0, 1))
    dD = (gy * u).sum((0, 1))
    return tuple(gr.to(x.dtype) for gr, x in
                 zip((du, ddelta, dA, dB, dC, dD), inputs))
