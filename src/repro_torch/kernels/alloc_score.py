"""Fit mask + Best-Fit load score, per-job and batched (CUDA).

This is the inner loop of the paper's allocators (FF/BF, §3): decide for
every node whether a job's per-node request fits and how loaded the node
is.  The kernel (``csrc/alloc_score.cu``) scores the whole queue against
every node in one launch; the per-job entry point is the same kernel
launched with J = 1, counted under its own name.

The fit travels as bits and the score once per node, since it does not
depend on the job: ``fit_bits`` int32[J, W] with W = ceil(N/32), bit
``n % 32`` of word ``n // 32`` set iff request j fits node n, tail bits 0
(uint32 patterns held in int32), and ``score`` f32[N].  Both are views of
one int32 buffer [J*W + N] (:func:`packed`), so a caller copies them to
the host in one transfer.

* :func:`alloc_score` — ONE job (``req [R]``) -> ``(fit_bits [W],
  score [N])``; the legacy per-job path, launched once per probed job.
* :func:`alloc_score_batch` — the WHOLE queue (``req [J, R]``) ->
  ``(fit_bits [J, W], score [N])``, one launch per dispatch event.

Both take int32 tensors, ``avail``/``capacity`` as ``[N, R]``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version ``ref.alloc_score_packed_ref``.
"""
from __future__ import annotations

import torch

from . import build, counters, ref

#: largest resource-type count the kernel keeps in registers
MAX_R = 8


def words(n: int) -> int:
    """W: 32-bit words per fit row of N nodes."""
    return -(-n // 32)


def _check(avail, capacity, req, rank: int) -> None:
    dev = avail.device
    build.check_input(avail, "avail", 2, dev)
    build.check_input(capacity, "capacity", 2, dev)
    build.check_input(req, "req", rank, dev)
    if capacity.shape != avail.shape:
        raise ValueError(f"capacity {tuple(capacity.shape)} != avail "
                         f"{tuple(avail.shape)}")
    if avail.shape[1] < 1 or req.shape[-1] != avail.shape[1]:
        raise ValueError(f"req {tuple(req.shape)} does not match "
                         f"avail {tuple(avail.shape)}")


def packed(avail: torch.Tensor, capacity: torch.Tensor, req: torch.Tensor,
           batch: bool) -> torch.Tensor:
    """int32[J*W + N]: the fit words of ``req [J, R]`` (``batch``, counted
    as ``alloc_score_batch``) or ``req [R]`` (J = 1, counted as
    ``alloc_score``), then the score's float32 bits.  :func:`split` cuts
    it apart."""
    _check(avail, capacity, req, 2 if batch else 1)
    name = "alloc_score_batch" if batch else "alloc_score"
    req2 = req if batch else req.view(1, -1)
    j, (n, r) = req2.shape[0], avail.shape
    if not build.launch_target(avail.device):
        bits, score = ref.alloc_score_packed_ref(avail, capacity, req2)
        return torch.cat([bits.reshape(-1), score.view(torch.int32)])
    if r > MAX_R:
        raise ValueError(f"alloc_score kernel takes R <= {MAX_R}, got {r}")
    out = torch.empty((j * words(n) + n,), dtype=torch.int32,
                      device=avail.device)
    if n == 0:
        return out
    lib = build.library("alloc_score")
    dev = build.device_index(avail.device)
    stream = torch.cuda.current_stream(dev).cuda_stream
    score = out[j * words(n):]
    build.check(lib.alloc_score_launch(
        req2.data_ptr(), avail.data_ptr(), capacity.data_ptr(),
        out.data_ptr(), score.data_ptr(), j, n, r, dev, stream), name)
    counters.record_device(name)
    return out


def split(out: torch.Tensor, j: int, n: int):
    """(fit_bits int32[J, W], score f32[N]): views of :func:`packed`'s
    buffer."""
    cut = j * words(n)
    return out[:cut].view(j, words(n)), out[cut:].view(torch.float32)


def alloc_score(avail: torch.Tensor, capacity: torch.Tensor,
                req: torch.Tensor):
    """(fit_bits int32[W], score f32[N]) for one job request."""
    bits, score = split(packed(avail, capacity, req, False), 1,
                        avail.shape[0])
    return bits[0], score


def alloc_score_batch(avail: torch.Tensor, capacity: torch.Tensor,
                      req: torch.Tensor):
    """(fit_bits int32[J, W], score f32[N]) for the whole queue in ONE
    launch."""
    return split(packed(avail, capacity, req, True), req.shape[0],
                 avail.shape[0])
