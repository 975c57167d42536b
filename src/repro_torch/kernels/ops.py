"""Public wrappers of the kernel layer: numpy in, numpy out, on a device.

The host simulator keeps its state in numpy.  Each wrapper casts its
int64 inputs to int32 on the host, copies them to ``device``, runs the
kernel wrapper there (the CUDA kernel on a CUDA device, the plain
PyTorch version on the CPU) and copies the result back, which
synchronises once per call.  Nothing falls back: a CUDA device without a
working kernel raises.

Launch accounting (see ``counters.py``): every wrapper below counts as
ONE launch per call, on any device.  ``DispatchPlan.stats`` snapshots
the total to show that the batched path is O(1) launches per dispatch
event.  Unlike the JAX reference, the job axis is not padded to a power
of two: that bucket only bounded recompiles, and a CUDA launch takes any
J.
"""
from __future__ import annotations

import numpy as np
import torch

from . import alloc_score as _alloc
from . import ebf_shadow as _ebf
from .counters import launch_count, launch_stats, record as _record

__all__ = ["resolve_device", "alloc_score", "alloc_score_batch",
           "ebf_shadow_fits", "launch_count", "launch_stats"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no CUDA device present that raises
    instead of running on the CPU.  Pass ``"cpu"`` for the plain
    versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the vectorized dispatchers run their "
                "kernels on the GPU; pass device='cpu' to run the plain "
                "PyTorch versions instead")
        return torch.device("cuda")
    return torch.device(device)


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
