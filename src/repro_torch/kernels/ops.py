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

The dry-run (``launch/dryrun.py``) traces the models on ``meta`` tensors
and enters :func:`scan_trace` to choose what the scan stands for there,
the reference's ``REPRO_KERNELS=ref|stub`` without an environment
switch: ``"ref"`` traces the plain version's recurrence (one step,
counted ``L`` times through :func:`trace_repeat`, as the reference's
cost model counts its loop), ``"stub"`` one streaming pass, the kernel's
HBM traffic (:func:`_scan_stub_ops`).  Both take only ``meta`` tensors:
their numbers are not the scan's.  Outside ``scan_trace`` a ``meta``
tensor has no kernel and raises.  A DTensor scan runs on each device's
shards (:func:`_scan_sharded`).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from . import alloc_score as _alloc
from . import ebf_shadow as _ebf
from . import selective_scan as _scan
from .counters import launch_count, launch_stats, record as _record

__all__ = ["resolve_device", "alloc_score", "alloc_score_batch", "fit_row",
           "ebf_shadow_fits", "selective_scan", "scan_trace", "trace_repeat",
           "launch_count", "launch_stats"]

#: what the scan stands for in the dry-run's trace (``scan_trace``)
SCAN_TRACE_MODES = ("ref", "stub")


class _Trace(threading.local):
    scan = None          # None outside the dry-run; else "ref" | "stub"
    repeat = 1           # times each traced op counts (trace_repeat)


_TRACE = _Trace()


@contextlib.contextmanager
def scan_trace(mode: str):
    """Within this context ``selective_scan`` takes ``meta`` tensors and
    traces ``mode``: ``"ref"`` (the plain version) or ``"stub"`` (one
    streaming pass).  Only the dry-run enters it."""
    if mode not in SCAN_TRACE_MODES:
        raise ValueError(f"scan mode {mode!r}, expected one of "
                         f"{SCAN_TRACE_MODES}")
    prev = _TRACE.scan
    _TRACE.scan = mode
    try:
        yield
    finally:
        _TRACE.scan = prev


@contextlib.contextmanager
def _repeated(n: int):
    prev = _TRACE.repeat
    _TRACE.repeat = prev * n
    try:
        yield
    finally:
        _TRACE.repeat = prev


def trace_repeat() -> int:
    """How many times an op traced now stands for (a cost model
    multiplies its count by this): ``L`` inside the ``"ref"`` scan's one
    traced step, else 1."""
    return _TRACE.repeat


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
    return _scan_any(u, delta, A, B, C, D)


def _scan_any(u, delta, A, B, C, D):
    from torch.distributed.tensor import DTensor
    if isinstance(u, DTensor):
        return _scan_sharded(u, delta, A, B, C, D)
    mode = _TRACE.scan
    if mode is None:
        return _scan.selective_scan(u, delta, A, B, C, D)
    for t in (u, delta, A, B, C, D):
        if t.device.type != "meta":
            raise ValueError(f"scan mode {mode!r} takes meta tensors, got "
                             f"one on {t.device}: its numbers are not the "
                             "scan's")
    if mode == "stub":
        return _StubScan.apply(u, delta, A, B, C, D)
    return _RefScan.apply(u, delta, A, B, C, D)


def _scan_sharded(u, delta, A, B, C, D):
    """The scan of DTensors on each device's shards.  Batch rows and
    channels are independent, so ``u``/``delta`` keep a batch (dim 0) or
    channel (dim 2) sharding and are gathered along the sequence; ``B``
    and ``C`` follow the batch sharding, ``A`` and ``D`` the channels;
    ``y`` is placed as ``u``, ``h_last`` [Bt, Di, S] on the same mesh
    dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..sharding import local_shard
    mesh = u.device_mesh
    up = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
               else Replicate() for p in u.placements)

    def on(dim, to):
        return tuple(Shard(to) if isinstance(p, Shard) and p.dim == dim
                     else Replicate() for p in up)

    local = lambda t, placements: local_shard(t, mesh, placements)
    y, h = _scan_any(local(u, up), local(delta, up), local(A, on(2, 0)),
                     local(B, on(0, 0)), local(C, on(0, 0)),
                     local(D, on(2, 0)))
    hp = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
               for p in up)
    return (DTensor.from_local(y, mesh, up, run_check=False),
            DTensor.from_local(h, mesh, hp, run_check=False))


@functools.lru_cache(maxsize=None)
def _scan_stub_ops():
    """The stub's two ops, registered on first use: ``scan_stub(u,
    delta, B, C) -> (y, h_last)`` reads the four streams and writes
    ``y`` and the last state once, the selective-scan kernel's HBM
    traffic (the state stays on chip between steps);
    ``scan_stub_bwd(gy, u, delta, B, C) -> (du, ddelta, dB, dC)`` is one
    such pass back.  Their only implementation is the fake one: they
    exist for the dry-run's trace on ``meta`` tensors, compute nothing,
    and count no FLOPs."""

    @torch.library.custom_op("repro_torch::scan_stub", mutates_args=())
    def scan_stub(u: torch.Tensor, delta: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        raise ValueError("scan_stub runs only on meta tensors")

    @scan_stub.register_fake
    def _(u, delta, B, C):
        bt, length, di = u.shape
        return (u.new_empty((bt, length, di), dtype=torch.float32),
                u.new_empty((bt, di, B.shape[-1]), dtype=torch.float32))

    @torch.library.custom_op("repro_torch::scan_stub_bwd", mutates_args=())
    def scan_stub_bwd(gy: torch.Tensor, u: torch.Tensor,
                      delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
        raise ValueError("scan_stub_bwd runs only on meta tensors")

    @scan_stub_bwd.register_fake
    def _(gy, u, delta, B, C):
        return (torch.empty_like(u), torch.empty_like(delta),
                torch.empty_like(B), torch.empty_like(C))

    return (torch.ops.repro_torch.scan_stub.default,
            torch.ops.repro_torch.scan_stub_bwd.default)


class _StubScan(torch.autograd.Function):
    """The stub with its one backward pass; ``A`` and ``D`` get zero
    gradients (the kernel's traffic has no term for them)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        ctx.save_for_backward(u, delta, A, B, C, D)
        return _scan_stub_ops()[0](u, delta, B, C)

    @staticmethod
    def backward(ctx, gy, gh):
        u, delta, A, B, C, D = ctx.saved_tensors
        if gy is None:
            gy = u.new_zeros(u.shape, dtype=torch.float32)
        du, dd, dB, dC = _scan_stub_ops()[1](gy, u, delta, B, C)
        return du, dd, torch.zeros_like(A), dB, dC, torch.zeros_like(D)


def _ref_step(h, u_t, d_t, B_t, C_t, A, D):
    """One step of ``ref.selective_scan_ref``'s loop: (h, y_t)."""
    d_t = d_t[..., None]
    h = torch.exp(d_t * A) * h + d_t * B_t[:, None, :] * u_t[..., None]
    return h, (h * C_t[:, None, :]).sum(-1) + D * u_t


class _RefScan(torch.autograd.Function):
    """The plain version's recurrence, traced as one step counted ``L``
    times (forward, and in the backward the step's recomputation and its
    VJP), around the inputs' float32 casts and the stacking of ``y``."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D):
        ctx.save_for_backward(u, delta, A, B, C, D)
        u, delta, A, B, C, D = (x.to(torch.float32)
                                for x in (u, delta, A, B, C, D))
        bt, length, di = u.shape
        h = torch.zeros((bt, di, A.shape[1]), dtype=torch.float32,
                        device=u.device)
        with _repeated(length):
            h, y_t = _ref_step(h, u[:, 0], delta[:, 0], B[:, 0], C[:, 0],
                               A, D)
        return torch.stack([y_t] * length, dim=1), h

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        u, delta, A, B, C, D = (x.to(torch.float32) for x in saved)
        bt, length, di = u.shape
        if gy is None:
            gy = u.new_zeros(u.shape)
        if gh is None:
            gh = u.new_zeros((bt, di, A.shape[1]))
        with torch.enable_grad(), _repeated(length):
            ins = [t.detach().requires_grad_()
                   for t in (gh, u[:, 0], delta[:, 0], B[:, 0], C[:, 0],
                             A, D)]
            h, y_t = _ref_step(*ins)
            g = torch.autograd.grad((h, y_t), ins, (gh, gy[:, 0]))
        stack = lambda x: torch.stack([x] * length, dim=1)
        grads = (stack(g[1]), stack(g[2]), g[5], stack(g[3]), stack(g[4]),
                 g[6])
        return tuple(gr.to(x.dtype) for gr, x in zip(grads, saved))
