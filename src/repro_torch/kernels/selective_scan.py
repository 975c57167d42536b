"""Mamba-1 selective scan (CUDA kernel wrapper).

The recurrence ``h = exp(delta * A) * h + delta * B * u``, ``y = h . C +
D * u`` over the sequence, for the prefill and training forward of the
Mamba mixer (``models/mamba.py``).  The kernel (``csrc/selective_scan.cu``)
keeps one channel's state in registers for the whole sequence; the plain
version is ``ref.selective_scan_ref``.
"""
from __future__ import annotations

import torch

from . import build, counters, ref

#: largest SSM state size the kernel keeps in registers
MAX_S = 16

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """(y f32[Bt, L, Di], h_last f32[Bt, Di, S]) of the selective scan.

    ``u, delta [Bt, L, Di]``, ``A [Di, S]``, ``B, C [Bt, L, S]``,
    ``D [Di]``, any float type (computed in float32), any ``L >= 1`` and
    ``Di >= 1``.  A CUDA tensor launches the kernel (``S <= MAX_S``) or
    raises; a CPU tensor runs the plain version.
    """
    dev = u.device
    for t, name, ndim in ((u, "u", 3), (delta, "delta", 3), (A, "A", 2),
                          (B, "B", 3), (C, "C", 3), (D, "D", 1)):
        build.check_input(t, name, ndim, dev, _FLOATS)
    u, delta, A, B, C, D = (t.to(torch.float32)
                            for t in (u, delta, A, B, C, D))
    bt, length, di = u.shape
    s = A.shape[1]
    if (tuple(delta.shape) != (bt, length, di) or A.shape[0] != di
            or tuple(B.shape) != (bt, length, s)
            or tuple(C.shape) != (bt, length, s) or tuple(D.shape) != (di,)):
        raise ValueError(
            f"shapes u {tuple(u.shape)}, delta {tuple(delta.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"D {tuple(D.shape)}")
    if min(bt, length, di, s) < 1:
        raise ValueError(f"empty scan: Bt {bt}, L {length}, Di {di}, S {s}")
    if not build.launch_target(dev):
        return ref.selective_scan_ref(u, delta, A, B, C, D)
    if s > MAX_S:
        raise ValueError(f"selective_scan kernel takes S <= {MAX_S}, got {s}")
    if bt > 65535:
        raise ValueError(f"selective_scan kernel takes Bt <= 65535, got {bt}")
    y = torch.empty((bt, length, di), dtype=torch.float32, device=dev)
    h_last = torch.empty((bt, di, s), dtype=torch.float32, device=dev)
    lib = build.library("selective_scan")
    index = build.device_index(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.selective_scan_launch(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        bt, length, di, s, index, stream), "selective_scan")
    counters.record_device("selective_scan")
    return y, h_last
