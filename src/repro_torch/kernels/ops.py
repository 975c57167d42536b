"""Public wrappers of the kernel layer, each on an explicit device.

The host simulator keeps its state in numpy.  Its wrappers (numpy in,
numpy out) cast their int64 inputs to int32 on the host, copy them to
``device``, run the kernel wrapper there (the CUDA kernel on a CUDA
device, the plain PyTorch version on the CPU) and copy the result back,
which synchronises once per call.  ``selective_scan`` serves the models:
tensors in, tensors out, on the inputs' device, with no copy.  Nothing
falls back: a CUDA device without a working kernel raises.

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

__all__ = ["resolve_device", "alloc_score", "alloc_score_batch",
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


def _put(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def alloc_score(avail, capacity, req, device):
    """(fit int32[N], score f32[N]) for one job request (FF/BF inner loop)."""
    _record("alloc_score")
    fit, score = _alloc.alloc_score(_put(avail, device),
                                    _put(capacity, device), _put(req, device))
    return fit.cpu().numpy(), score.cpu().numpy()


def alloc_score_batch(avail, capacity, req, device):
    """(fit int32[J, N], score f32[J, N]) for the whole queue in ONE
    launch (``DispatchContext.req`` × availability — the batched dispatch
    path's only kernel)."""
    _record("alloc_score_batch")
    fit, score = _alloc.alloc_score_batch(_put(avail, device),
                                          _put(capacity, device),
                                          _put(req, device))
    return fit.cpu().numpy(), score.cpu().numpy()


def ebf_shadow_fits(avail, deltas, req, device):
    """fits int32[M]: fitting-node count per release prefix (EBF shadow)."""
    _record("ebf_shadow")
    return _ebf.ebf_shadow(_put(avail, device), _put(deltas, device),
                           _put(req, device)).cpu().numpy()


def selective_scan(u, delta, A, B, C, D):
    """Mamba-1 selective scan: (y f32[Bt, L, Di], h_last f32[Bt, Di, S])
    on the inputs' device."""
    _record("selective_scan")
    return _scan.selective_scan(u, delta, A, B, C, D)
