"""Cost model of the dry-run: per-device FLOPs, bytes and collectives of
a traced step.

The reference walks the optimized HLO text of a compiled step.  The port
has no HLO: its dry-run runs the step eagerly on ``meta`` DTensors, and
:class:`CostMode`, a ``TorchDispatchMode``, counts every op that DTensor
issues on the local shards (it declines the DTensor-level op, so
DTensor runs its sharding propagation and redistributions first and the
mode sees the per-device ops and collectives).  Every count is per
device, from rank 0's shards.  Eager tracing runs every layer, so no
trip-count correction is needed; an op traced inside
``kernels.ops.trace_repeat`` (the plain scan's one traced step) counts
that many times, as the reference multiplies a ``while`` body by its
trip count.  Into the reference's :class:`CostTotals` go:

  * matmul FLOPs (``mm``/``addmm``/``bmm``/``baddbmm``: 2 · prod(output)
    · contraction) and convolution FLOPs, as the reference's
    ``_dot_flops`` / ``_conv_flops``;
  * elementwise FLOPs, one per output element of each op the reference
    counts (add, multiply, subtract, divide, exp, tanh, rsqrt, sqrt,
    power, maximum, minimum, log, negate, compare, select), with the
    composite aten ops (softmax, SiLU, GELU, softplus and their
    backwards) counted as the elementwise ops they stand for
    (:data:`ELEMENTWISE`);
  * bytes accessed: operand and output bytes of every op but views,
    aliases and allocations.  Nothing is fused, so this is an
    upper-bound proxy, in the sense of the reference's caveat (its
    fusions are the CPU backend's, not the target's): bytes transfer
    least, FLOPs and collective bytes directly;
  * collective bytes by kind (all-gather / all-reduce / reduce-scatter /
    all-to-all), the output payload of each functional collective
    DTensor issues, with the reference's ring-model link factors
    (:func:`_collective_link_factor`) for the group's size.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.ops import trace_repeat

@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_link_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_count: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def total_collective_link_bytes(self) -> float:
        return sum(self.collective_link_bytes.values())


def _collective_link_factor(kind: str, n: int) -> float:
    """Ring-model per-chip link traffic as a fraction of payload bytes."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0  # collective-permute


_aten = torch.ops.aten


def _packets(*names):
    """The aten overload packets of ``names`` that this torch has."""
    return {getattr(_aten, n) for n in names if hasattr(_aten, n)}


def _flops_table(groups):
    return {op: n for names, n in groups for op in _packets(*names)}


#: FLOPs per output element of the elementwise ops, by overload packet:
#: the reference's elementwise HLO ops, one each, and the composite ones
#: as the HLO ops they lower to (softmax: subtract, exp, divide; its
#: backward: multiply, subtract, multiply; SiLU: one multiply, the
#: logistic uncounted; tanh-GELU: six multiplies, two adds, a tanh)
ELEMENTWISE = _flops_table([
    (("add", "sub", "rsub", "mul", "div", "exp", "tanh", "rsqrt", "sqrt",
      "pow", "maximum", "minimum", "log", "neg", "eq", "ne", "lt", "le",
      "gt", "ge", "where", "masked_fill", "clamp_min", "clamp_max",
      "reciprocal", "silu", "mean", "threshold_backward", "add_", "mul_",
      "div_", "sub_"), 1),
    (("clamp", "logsumexp"), 2),
    (("_softmax", "_log_softmax", "_softmax_backward_data",
      "_log_softmax_backward_data", "tanh_backward", "sigmoid_backward"), 3),
    (("softplus", "softplus_backward"), 4),
    (("silu_backward",), 5),
    (("gelu",), 9),
    (("gelu_backward",), 14),
])

#: ops that move no bytes: views, aliases, allocations, metadata
_NO_BYTES = _packets(
    "view", "_unsafe_view", "reshape", "expand", "transpose", "permute", "t",
    "slice", "select", "unsqueeze", "squeeze", "alias", "detach",
    "as_strided", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "empty", "empty_like", "new_empty", "empty_strided",
    "new_empty_strided", "lift_fresh", "_reshape_alias", "view_as",
    "diagonal", "unfold", "is_same_size")

_MATMULS = _packets("mm", "addmm", "bmm", "baddbmm")

#: allocations: a storage counts from the op that first writes it (DTensor
#: also allocates its outputs' global-shaped shells this way, which hold
#: no data on any device)
_ALLOCS = _packets("empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(packet, args, out) -> float:
    """2 · prod(output) · contraction of a (batched) product."""
    if packet in (_aten.mm, _aten.bmm):
        a = args[0]
    else:                       # addmm / baddbmm: (bias, a, b)
        a = args[1]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out) -> float:
    """2 · prod(output) · prod(kernel dims), as the reference counts a
    convolution."""
    w = args[1]
    return 2.0 * out.numel() * max(math.prod(w.shape), 1)


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _collective(packet_name: str, args):
    """(kind, group size) of a functional collective, or None."""
    if packet_name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
        return "all-gather", int(args[1])
    if packet_name in ("reduce_scatter_tensor",):
        return "reduce-scatter", int(args[2])
    if packet_name in ("all_reduce", "all_reduce_"):
        return "all-reduce", _group_size(args[2])
    if packet_name == "all_to_all_single":
        return "all-to-all", _group_size(args[3])
    if packet_name == "shard_dim_alltoall":
        return "all-to-all", _group_size(args[3])
    return None


#: operand indices whose bytes an op counts, where not all of them: the
#: scan stub reads its four streams (u, delta, B, C), its backward those
#: and ``gy``
_BYTES_ARGS = {"repro_torch::scan_stub": (0, 1, 2, 3),
               "repro_torch::scan_stub_bwd": (0, 1, 2, 3, 4)}


class CostMode(TorchDispatchMode):
    """Counts the local ops of a traced step into ``self.totals``, and
    hands every output tensor to ``on_output`` (a memory tracker)."""

    def __init__(self, on_output=None) -> None:
        super().__init__()
        self.totals = CostTotals()
        self.on_output = on_output

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops on fake tensors of the
        # global shapes to learn their outputs: no device runs those
        if not any(issubclass(t, FakeTensor) for t in types):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        tot = self.totals
        mult = trace_repeat()
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional"):
            coll = _collective(packet.__name__, args)
            if coll is not None:
                kind, n = coll
                payload = sum(_nbytes(t) for t in _tensors(out))
                tot.collective_bytes[kind] += payload * mult
                tot.collective_link_bytes[kind] += (
                    payload * _collective_link_factor(kind, n) * mult)
                tot.collective_count[kind] += mult
            return
        outs = list(_tensors(out))
        if self.on_output is not None and packet not in _ALLOCS:
            for t in outs:
                self.on_output(t)
        if packet in _MATMULS:
            tot.flops += _matmul_flops(packet, args, outs[0]) * mult
        elif packet == _aten.convolution:
            tot.flops += _conv_flops(args, outs[0]) * mult
        elif packet in ELEMENTWISE and outs:
            tot.flops += ELEMENTWISE[packet] * outs[0].numel() * mult
        if packet in _NO_BYTES:
            return
        name = f"{ns}::{packet.__name__}"
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if name in _BYTES_ARGS:
            ins = [args[i] for i in _BYTES_ARGS[name]]
        tot.bytes += (sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs)) * mult


@contextlib.contextmanager
def counting(on_output=None):
    """``with counting() as totals:`` counts the ops run inside into
    ``totals`` (a :class:`CostTotals`); ``on_output`` sees each op's
    output tensors.  A redistribution between two
    shardings of one dim is counted as the all-to-all it is: DTensor's
    CPU meshes stand in an all-gather for it (their backends have none),
    so the context routes it to DTensor's own all-to-all op, which runs
    on ``meta`` tensors without a backend."""
    mode = CostMode(on_output)
    with _alltoall_as_such(), mode:
        yield mode.totals


@contextlib.contextmanager
def _alltoall_as_such():
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:              # another torch layout: counted as gathers
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol
        if hasattr(funcol, "_resolve_group_name"):
            name = funcol._resolve_group_name((mesh, mesh_dim))
        else:
            name = funcol._group_or_group_name(
                funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, name)
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig
