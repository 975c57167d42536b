"""Fit mask + Best-Fit load score, per-job and batched (CUDA).

This is the inner loop of the paper's allocators (FF/BF, §3): decide for
every node whether a job's per-node request fits and how loaded the node
is.  The kernel (``csrc/alloc_score.cu``) scores the whole queue against
every node in one launch; the per-job entry point is the same kernel
launched with J = 1, counted under its own name.

* :func:`alloc_score` — ONE job (``req [R]``) -> ``fit/score [N]``; the
  legacy per-job path, launched once per probed job.
* :func:`alloc_score_batch` — the WHOLE queue (``req [J, R]``) ->
  ``fit/score [J, N]``, one launch per dispatch event.

Both take int32 tensors, ``avail``/``capacity`` as ``[N, R]``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from . import build, counters, ref


def _launch(avail, capacity, req2, name: str):
    """Launch ``alloc_score_batch_launch`` for ``req2 [J, R]``."""
    j, r = req2.shape
    n = avail.shape[0]
    fit = torch.empty((j, n), dtype=torch.int32, device=avail.device)
    score = torch.empty((j, n), dtype=torch.float32, device=avail.device)
    if j == 0 or n == 0:
        return fit, score
    lib = build.library("alloc_score")
    dev = build.device_index(avail.device)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.alloc_score_batch_launch(
        req2.data_ptr(), avail.data_ptr(), capacity.data_ptr(),
        fit.data_ptr(), score.data_ptr(), j, n, r, dev, stream), name)
    counters.record_device(name)
    return fit, score


def _check(avail, capacity, req, req_ndim: int) -> None:
    dev = avail.device
    build.check_input(avail, "avail", 2, dev)
    build.check_input(capacity, "capacity", 2, dev)
    build.check_input(req, "req", req_ndim, dev)
    if capacity.shape != avail.shape:
        raise ValueError(f"capacity {tuple(capacity.shape)} != avail "
                         f"{tuple(avail.shape)}")
    if avail.shape[1] < 1 or req.shape[-1] != avail.shape[1]:
        raise ValueError(f"req {tuple(req.shape)} does not match "
                         f"avail {tuple(avail.shape)}")


def alloc_score(avail: torch.Tensor, capacity: torch.Tensor,
                req: torch.Tensor):
    """(fit int32[N], score f32[N]) for one job request."""
    _check(avail, capacity, req, 1)
    if not build.launch_target(avail.device):
        return ref.alloc_score_ref(avail, capacity, req)
    fit, score = _launch(avail, capacity, req.view(1, -1), "alloc_score")
    return fit[0], score[0]


def alloc_score_batch(avail: torch.Tensor, capacity: torch.Tensor,
                      req: torch.Tensor):
    """(fit int32[J, N], score f32[J, N]) for the whole queue in ONE
    launch."""
    _check(avail, capacity, req, 2)
    if not build.launch_target(avail.device):
        return ref.alloc_score_batch_ref(avail, capacity, req)
    return _launch(avail, capacity, req, "alloc_score_batch")
