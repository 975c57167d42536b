"""Plain PyTorch versions of the CUDA kernels (the ``ref.py`` contract).

These are the semantic ground truth of the port's kernel layer: the
wrappers run them for tensors on the CPU, the tests hold them equal to
the JAX reference, and ``chip_smoke.py`` holds each CUDA kernel equal to
them on the card.  Arithmetic is pinned to the host's numpy float32
reconcile (``core/dispatchers/vectorized.py``): subtract as integers,
convert, divide correctly rounded, and sum over resource types in
r = 0..R-1 order — so Best-Fit ties break identically everywhere.
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
