"""Mamba-1 selective scan (CUDA kernel wrappers, forward and backward).

The recurrence ``h = exp(delta * A) * h + delta * B * u``, ``y = h . C +
D * u`` over the sequence, for the prefill and training forward of the
Mamba mixer (``models/mamba.py``).  The forward kernel
(``csrc/selective_scan.cu``) splits each channel's states over four
lanes, stages the inputs in shared memory and reads ``u``, ``delta``,
``B`` and ``C`` in the caller's float type; its plain version is
``ref.selective_scan_ref``.  On the card the gradient is the backward
kernel's (``csrc/selective_scan_bwd.cu``, :class:`_ScanWithKernelGrad`):
the reverse recurrence over the saved inputs, the forward's states
recomputed from checkpoints at chunk starts, each chunk's inputs staged
in shared memory ahead of use; its plain version is
``ref.selective_scan_bwd_ref``.  On the CPU autograd differentiates the
plain forward.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build, counters, ref

#: largest SSM state size the kernel keeps in registers; the wrapper
#: scans larger states in chunks of at most this many
MAX_S = 16
#: largest batch of one launch (the grid's y extent); the wrapper loops
#: over batch chunks of at most this many rows (rows are independent)
MAX_BT = 65535

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
#: element types the kernel reads natively -> code across the ABI
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """(y f32[Bt, L, Di], h_last f32[Bt, Di, S]) of the selective scan.

    ``u, delta [Bt, L, Di]``, ``A [Di, S]``, ``B, C [Bt, L, S]``,
    ``D [Di]``, any float type (computed in float32), any ``L >= 1`` and
    ``Di >= 1``.  A CUDA tensor launches the kernel (one launch per
    chunk of at most ``MAX_BT`` batch rows and ``MAX_S`` states) or raises:
    ``u``, ``delta``, ``B`` and ``C`` are read as they are when they
    share one type, else all four are cast to float32; ``A`` and ``D``
    are cast to float32.  Its gradient launches the backward kernel,
    once per forward launch, or raises.  A CPU tensor runs the plain
    version.
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
        return split_states(u, delta, A, B, C, D)
    if bt <= MAX_BT:
        return _ScanWithKernelGrad.apply(u, delta, A, B, C, D)
    parts = [_ScanWithKernelGrad.apply(u[i:i + MAX_BT], delta[i:i + MAX_BT],
                                       A, B[i:i + MAX_BT], C[i:i + MAX_BT],
                                       D)
             for i in range(0, bt, MAX_BT)]
    return (torch.cat([y for y, _ in parts]),
            torch.cat([h for _, h in parts]))


def split_states(u, delta, A, B, C, D):
    """The scan of ``S > MAX_S`` states as scans of chunks of at most
    ``MAX_S`` states: the states evolve independently and meet only in
    ``y``'s sum over them, so the chunks' ``y`` are added in float32 (in
    chunk order), ``D * u`` enters with the first chunk alone, and
    ``h_last`` is the chunks' states side by side."""
    s = A.shape[1]
    zero = torch.zeros_like(D)
    y, hs = None, []
    for lo in range(0, s, MAX_S):
        part = slice(lo, lo + MAX_S)
        y_c, h_c = selective_scan(
            u, delta, A[:, part].contiguous(), B[..., part].contiguous(),
            C[..., part].contiguous(), D if lo == 0 else zero)
        y = y_c if y is None else y + y_c
        hs.append(h_c)
    return y, torch.cat(hs, dim=-1)


class _ScanWithKernelGrad(torch.autograd.Function):
    """The forward kernel and, for the backward, the backward kernel on
    the saved inputs (the reference's ``ops._scan_with_ref_grad`` runs
    its oracle's VJP there).  Gradients the graph does not ask for come
    back as None."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        ctx.save_for_backward(u, delta, A, B, C, D)
        return _launch(u, delta, A, B, C, D)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        grads = selective_scan_bwd(*ctx.saved_tensors, grad_y, grad_h)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


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


def selective_scan_bwd(u, delta, A, B, C, D, gy, gh):
    """(du, ddelta, dA, dB, dC, dD) of the selective scan, each in its
    input's dtype, from the scan's inputs and the cotangents ``gy``
    [Bt, L, Di] of ``y`` and ``gh`` [Bt, Di, S] of ``h_last`` (zeros where
    it is unused).  A CUDA tensor launches the backward kernel (at most
    ``MAX_BT`` rows and ``MAX_S`` states: ``selective_scan``'s gradient
    splits larger scans as its forward does) or raises; a CPU tensor
    runs the plain version."""
    bt, length, di = u.shape
    s = A.shape[1]
    if tuple(gy.shape) != (bt, length, di) or tuple(gh.shape) != (bt, di, s):
        raise ValueError(f"cotangents gy {tuple(gy.shape)}, gh "
                         f"{tuple(gh.shape)} of a scan of u "
                         f"{tuple(u.shape)}, S {s}")
    if not build.launch_target(u.device):
        return ref.selective_scan_bwd_ref(u, delta, A, B, C, D, gy, gh)
    for t, name, ndim in ((u, "u", 3), (delta, "delta", 3), (A, "A", 2),
                          (B, "B", 3), (C, "C", 3), (D, "D", 1)):
        build.check_input(t, name, ndim, u.device, _FLOATS)
    if s > MAX_S or bt > MAX_BT:
        raise ValueError(f"one backward launch takes Bt <= {MAX_BT} and "
                         f"S <= {MAX_S}, got Bt {bt}, S {s}")
    grads = _launch_bwd(u, delta, A, B, C, D, gy, gh)
    return tuple(g.to(x.dtype) for g, x in
                 zip(grads, (u, delta, A, B, C, D)))


def _launch_bwd(u, delta, A, B, C, D, gy, gh):
    """Launch the backward kernel on checked CUDA inputs: (du, ddelta,
    dA, dB, dC, dD), du, ddelta, dB and dC in the kernel's element type,
    dA and dD in float32."""
    bt, length, di = u.shape
    s = A.shape[1]
    dev = u.device
    if len({u.dtype, delta.dtype, B.dtype, C.dtype}) > 1:
        u, delta, B, C = (t.to(torch.float32) for t in (u, delta, B, C))
    A, D = A.to(torch.float32), D.to(torch.float32)
    gy = gy.to(torch.float32).contiguous()
    gh = gh.to(torch.float32).contiguous()
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty((di, s), dtype=torch.float32, device=dev)
    dD = torch.empty((di,), dtype=torch.float32, device=dev)
    lib = build.library("selective_scan_bwd")
    n = lib.selective_scan_bwd_scratch_floats(bt, length, di, s)
    scratch = torch.empty((n,), dtype=torch.float32, device=dev)
    index = build.device_index(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.selective_scan_bwd_launch(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), gy.data_ptr(), gh.data_ptr(),
        du.data_ptr(), ddelta.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dD.data_ptr(), scratch.data_ptr(), n, bt, length,
        di, s, DTYPE_CODES[u.dtype], index, stream), "selective_scan_bwd")
    counters.record_device("selective_scan_bwd")
    return du, ddelta, dA, dB, dC, dD


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


def bwd_kernel_attributes(dtype: torch.dtype, device=None,
                          aligned: bool = True) -> Dict[str, int]:
    """What the backward's walk kernel for ``dtype`` (``aligned``: the rows
    of ``u``, ``delta`` and ``gy`` start at multiples of 16 bytes, as at
    the model's widths) uses on the card: registers per thread, static and
    dynamic shared memory per block, threads per block, resident blocks
    and warps per SM (the occupancy calculator's) and channels per block
    (a launch's grid is ``ceil(Di / channels) x Bt`` blocks)."""
    dev = torch.device("cuda" if device is None else device)
    out = (ctypes.c_int * 6)()
    build.check(
        build.library("selective_scan_bwd").selective_scan_bwd_attributes(
            DTYPE_CODES[dtype], int(aligned), build.device_index(dev),
            ctypes.addressof(out)), "selective_scan_bwd_attributes")
    regs, smem_static, smem_dynamic, threads, blocks, channels = out
    return {"registers": regs, "smem_static_bytes": smem_static,
            "smem_dynamic_bytes": smem_dynamic, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "channels_per_block": channels}
