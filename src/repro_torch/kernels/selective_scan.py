"""Mamba-1 selective scan (CUDA kernel wrapper).

The recurrence ``h = exp(delta * A) * h + delta * B * u``, ``y = h . C +
D * u`` over the sequence, for the prefill and training forward of the
Mamba mixer (``models/mamba.py``).  The kernel (``csrc/selective_scan.cu``)
splits each channel's states over four lanes, stages the inputs in shared
memory and reads ``u``, ``delta``, ``B`` and ``C`` in the caller's float
type; the plain version is ``ref.selective_scan_ref``.  The kernel has no
backward: on the card, gradients come from the plain version's VJP,
recomputed on the saved inputs (:class:`_ScanWithPlainGrad`), as the
reference pairs its Pallas forward with its oracle's VJP.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build, counters, ref

#: largest SSM state size the kernel keeps in registers
MAX_S = 16

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
#: element types the kernel reads natively -> code across the ABI
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """(y f32[Bt, L, Di], h_last f32[Bt, Di, S]) of the selective scan.

    ``u, delta [Bt, L, Di]``, ``A [Di, S]``, ``B, C [Bt, L, S]``,
    ``D [Di]``, any float type (computed in float32), any ``L >= 1`` and
    ``Di >= 1``.  A CUDA tensor launches the kernel (``S <= MAX_S``) or
    raises: ``u``, ``delta``, ``B`` and ``C`` are read as they are when
    they share one type, else all four are cast to float32; ``A`` and
    ``D`` are cast to float32.  A CPU tensor runs the plain version.
    """
    dev = u.device
    for t, name, ndim in ((u, "u", 3), (delta, "delta", 3), (A, "A", 2),
                          (B, "B", 3), (C, "C", 3), (D, "D", 1)):
        build.check_input(t, name, ndim, dev, _FLOATS)
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
    return _ScanWithPlainGrad.apply(u, delta, A, B, C, D)


class _ScanWithPlainGrad(torch.autograd.Function):
    """The kernel forward and, for the backward, the VJP of the plain
    version recomputed under autograd on the saved inputs (the
    reference's ``ops._scan_with_ref_grad``)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        ctx.save_for_backward(u, delta, A, B, C, D)
        return _launch(u, delta, A, B, C, D)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        saved = [x.detach().requires_grad_(need)
                 for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [x for x in saved if x.requires_grad]
        with torch.enable_grad():
            y, h_last = ref.selective_scan_ref(*saved)
            grads = iter(torch.autograd.grad((y, h_last), wrt,
                                             (grad_y, grad_h)))
        return tuple(next(grads) if x.requires_grad else None
                     for x in saved)


def _launch(u, delta, A, B, C, D):
    """Launch the kernel on checked CUDA inputs: (y, h_last)."""
    bt, length, di = u.shape
    s = A.shape[1]
    dev = u.device
    if len({u.dtype, delta.dtype, B.dtype, C.dtype}) > 1:
        u, delta, B, C = (t.to(torch.float32) for t in (u, delta, B, C))
    A, D = A.to(torch.float32), D.to(torch.float32)
    y = torch.empty((bt, length, di), dtype=torch.float32, device=dev)
    h_last = torch.empty((bt, di, s), dtype=torch.float32, device=dev)
    lib = build.library("selective_scan")
    index = build.device_index(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.selective_scan_launch(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        bt, length, di, s, DTYPE_CODES[u.dtype], index, stream),
        "selective_scan")
    counters.record_device("selective_scan")
    return y, h_last


def kernel_attributes(dtype: torch.dtype, aligned: bool,
                      device=None) -> Dict[str, int]:
    """What the kernel instantiation for ``dtype`` (``aligned``: pointers
    and row pitch multiples of 16 bytes) uses on the card: registers per
    thread, static and dynamic shared memory per block, threads per block
    and resident blocks and warps per SM (the occupancy calculator's)."""
    dev = torch.device("cuda" if device is None else device)
    out = (ctypes.c_int * 5)()
    build.check(build.library("selective_scan").selective_scan_attributes(
        DTYPE_CODES[dtype], int(aligned), build.device_index(dev),
        ctypes.addressof(out)), "selective_scan_attributes")
    regs, smem_static, smem_dynamic, threads, blocks = out
    return {"registers": regs, "smem_static_bytes": smem_static,
            "smem_dynamic_bytes": smem_dynamic, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}
