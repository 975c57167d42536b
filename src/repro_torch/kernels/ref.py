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
