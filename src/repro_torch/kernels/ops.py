"""Public wrappers of the kernel layer, each on an explicit device.

The host simulator keeps its state in numpy.  Its wrappers (numpy in,
numpy out) cast their int64 inputs to int32 into one host buffer, copy it
to ``device`` in one transfer, run the kernel wrapper there (the CUDA
kernel on a CUDA device, the plain PyTorch version on the CPU) and copy
its one output buffer back, which synchronises once per call.
``selective_scan`` serves the models: tensors in, tensors out, on the
inputs' device, with no copy.  Nothing falls back: a CUDA device without
a working kernel raises.

Launch accounting (see ``counters.py``): every wrapper below counts as
ONE launch per call, on any device.  ``DispatchPlan.stats`` snapshots
the total to show that the batched path is O(1) launches per dispatch
event.  Unlike the JAX reference, the job axis is not padded to a power
of two: that bucket only bounded recompiles, and a CUDA launch takes any
J.  Nor does ``selective_scan`` route irregular shapes to its plain
version: the kernel takes any sequence length and channel count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import alloc_score as _alloc
from . import ebf_shadow as _ebf
from . import selective_scan as _scan
from .counters import launch_count, launch_stats, record as _record

__all__ = ["resolve_device", "alloc_score", "alloc_score_batch", "fit_row",
           "ebf_shadow_fits", "selective_scan", "launch_count",
           "launch_stats"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device with no CUDA device present
    raises instead of running on the CPU.  Pass ``"cpu"`` for the plain
    versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs its kernels on the GPU; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    return dev


def _put(device, *arrays):
    """Cast host arrays to int32, pack them into one buffer, copy it to
    ``device`` in ONE transfer, and return views of it shaped as the
    arrays."""
    arrays = [np.asarray(a) for a in arrays]
    buf = np.empty(sum(a.size for a in arrays), dtype=np.int32)
    off = 0
    for a in arrays:
        buf[off:off + a.size] = a.reshape(-1)
        off += a.size
    dev = torch.from_numpy(buf).to(device)
    views, off = [], 0
    for a in arrays:
        views.append(dev[off:off + a.size].view(a.shape))
        off += a.size
    return views


def fit_row(bits_row: np.ndarray, n: int) -> np.ndarray:
    """bool[N]: one row of ``alloc_score_batch``'s fit words unpacked."""
    return np.unpackbits(bits_row.astype("<u4", copy=False).view(np.uint8),
                         bitorder="little", count=n).view(bool)


def _alloc_host(avail, capacity, req, device):
    """The alloc_score kernel on ``device``: one copy in, one copy out;
    (fit_bits uint32[J, W], score f32[N]) on the host."""
    batch = np.ndim(req) == 2
    out = _alloc.packed(*_put(device, avail, capacity, req), batch).cpu()
    j = np.shape(req)[0] if batch else 1
    bits, score = _alloc.split(out, j, np.shape(avail)[0])
    return bits.numpy().view(np.uint32), score.numpy()


def alloc_score(avail, capacity, req, device):
    """(fit bool[N], score f32[N]) for one job request (FF/BF inner
    loop)."""
    _record("alloc_score")
    bits, score = _alloc_host(avail, capacity, req, device)
    return fit_row(bits[0], score.shape[0]), score


def alloc_score_batch(avail, capacity, req, device):
    """(fit_bits uint32[J, W], score f32[N]) for the whole queue in ONE
    launch (``DispatchContext.req`` × availability — the batched dispatch
    path's only kernel); W = ceil(N/32), bit ``n % 32`` of word ``n // 32``
    is request j's fit on node n (:func:`fit_row` unpacks a row)."""
    _record("alloc_score_batch")
    return _alloc_host(avail, capacity, req, device)


def ebf_shadow_fits(avail, rel, req, device):
    """fits int32[M]: fitting-node count per release-group prefix (EBF
    shadow), for releases ``rel`` grouped by node
    (``ebf_shadow.SparseReleases``); one copy in, one copy out.  Raises
    on malformed releases, which the kernel marks with counts of -1."""
    _record("ebf_shadow")
    r = np.shape(avail)[1]
    a, q, ptr, em, ev = _put(device, avail, req, rel.node_ptr, rel.entry_m,
                             np.reshape(rel.entry_vec, (-1, r)))
    fits = _ebf.ebf_shadow(a, ptr, em, ev, q,
                           rel.times.shape[0]).cpu().numpy()
    if np.any(fits < 0):
        raise ValueError("malformed sparse releases")
    return fits


def selective_scan(u, delta, A, B, C, D):
    """Mamba-1 selective scan: (y f32[Bt, L, Di], h_last f32[Bt, Di, S])
    on the inputs' device."""
    _record("selective_scan")
    return _scan.selective_scan(u, delta, A, B, C, D)
