"""Vectorized dispatch engine on the CUDA kernels — the device twin of the
numpy allocators/schedulers (DESIGN.md §2).

Semantics are bit-identical to ``allocators.py`` / ``schedulers.py`` (the
tests assert trace-for-trace equality of dispatching decisions); only the
inner loops run as kernels through ``repro_torch.kernels.ops``:

* FF/BF node selection  -> ``alloc_score_batch`` kernel: the WHOLE queue
  scored against all nodes in ONE launch (``req [J, R]`` × ``avail
  [N, R]`` -> fit/score ``[J, N]``), followed by a host-side greedy
  commit (:class:`BatchProbe`) that reproduces the sequential FF/BF
  decisions exactly.  Kernel launches per dispatch event drop from
  O(queue) to O(1).
* EBF shadow time       -> ``ebf_shadow`` kernel (release prefix scan)

The legacy per-job path (one ``alloc_score`` launch per queued job) is
kept behind ``VectorizedAllocator(batched=False)`` for A/B benchmarking.

Every engine runs on an explicit ``device``: ``None`` means the card and
raises when there is none; ``"cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...kernels import ops
from ...kernels.ebf_shadow import shadow_from_releases
from .base import AllocatorBase
from .context import DispatchContext
from .schedulers import EasyBackfilling


class BatchProbe:
    """One-launch queue×node scorer with host-side reconciliation.

    Built once per dispatch event from the frozen context: a single
    ``alloc_score_batch`` launch yields ``fit [J, N]`` / ``score [J, N]``
    against the event's *base* availability.  As the greedy commit
    consumes nodes (or EBF shadows/reservations add them back), callers
    probe with the *current* availability; only the nodes whose rows
    differ from the base are re-evaluated — in numpy, on the host, with
    the kernel's exact float32 arithmetic — so no further launches are
    needed and the sequential trace is reproduced bit-for-bit.
    """

    def __init__(self, ctx: DispatchContext, policy: str, device) -> None:
        self.policy = policy
        self.base = ctx.avail
        self.req = ctx.req
        self.n_nodes = ctx.n_nodes
        self.capacity = ctx.capacity
        fit, score = ops.alloc_score_batch(ctx.avail, ctx.capacity, ctx.req,
                                           device)
        self.fit0 = fit.astype(bool)                     # [J, N]
        self.score0 = score                              # [J, N] float32

    # ------------------------------------------------------------------
    def find(self, qi: int, avail: np.ndarray) -> Optional[np.ndarray]:
        """``find_nodes`` semantics for queue index ``qi`` against an
        arbitrary availability matrix — zero kernel launches."""
        changed = np.nonzero(np.any(avail != self.base, axis=1))[0]
        fit = self.fit0[qi]
        if changed.size:
            fit = fit.copy()
            fit[changed] = np.all(
                avail[changed] >= self.req[qi][None, :], axis=1)
        need = int(self.n_nodes[qi])
        if int(fit.sum()) < need:
            return None
        if self.policy == "FF":
            return np.nonzero(fit)[0][:need]
        score = self.score0[qi]
        if changed.size:
            score = score.copy()
            cap = np.maximum(self.capacity[changed], 1).astype(np.float32)
            used = (self.capacity[changed] - avail[changed]).astype(np.float32)
            score[changed] = (used / cap).sum(axis=1, dtype=np.float32)
        order = np.argsort(-score, kind="stable")
        fitting = order[fit[order]]
        return fitting[:need]


class VectorizedAllocator(AllocatorBase):
    """First-Fit or Best-Fit backed by the alloc-score kernels.

    ``batched=True`` (default): ``allocate_batch`` runs ONE
    ``alloc_score_batch`` launch per dispatch event and commits greedily
    on the host.  ``batched=False`` keeps the legacy behaviour — one
    ``alloc_score`` launch per queued job — for benchmarks comparing the
    two paths.  ``device=None`` means the card (and raises without one).
    """

    def __init__(self, policy: str = "FF", batched: bool = True,
                 device=None) -> None:
        if policy not in ("FF", "BF"):
            raise ValueError(policy)
        self.policy = policy
        self.batched = batched
        self.device = ops.resolve_device(device)
        self.name = f"v{policy}"

    # -- per-job path (legacy; one kernel launch per call) --------------
    def find_nodes(self, request_vec, n_nodes, avail, capacity) -> Optional[np.ndarray]:
        fit, score = ops.alloc_score(avail, capacity, request_vec,
                                     self.device)
        fit = fit.astype(bool)
        if int(fit.sum()) < n_nodes:
            return None
        if self.policy == "FF":
            return np.nonzero(fit)[0][:n_nodes]
        order = np.argsort(-score, kind="stable")
        fitting = order[fit[order]]
        return fitting[:n_nodes]

    # -- batched path (one launch per event) -----------------------------
    def batch_probe(self, ctx: DispatchContext) -> BatchProbe:
        return BatchProbe(ctx, self.policy, self.device)

    def allocate_batch(
        self,
        ctx: DispatchContext,
        order: Sequence[int],
        avail: Optional[np.ndarray] = None,
        blocking: bool = True,
    ) -> List[Tuple[int, Optional[List[int]]]]:
        if not self.batched or ctx.n_queued == 0:
            return super().allocate_batch(ctx, order, avail, blocking)
        if avail is None:
            avail = ctx.avail.copy()
        probe = self.batch_probe(ctx)
        out: List[Tuple[int, Optional[List[int]]]] = []
        for qi in order:
            nodes = probe.find(int(qi), avail)
            if nodes is None:
                out.append((int(qi), None))
                if blocking:
                    break
            else:
                avail[nodes] -= ctx.req[qi][None, :]
                out.append((int(qi), [int(n) for n in nodes]))
        return out


class VectorizedEasyBackfilling(EasyBackfilling):
    """EBF whose queue×node probes share ONE ``alloc_score_batch`` launch
    (greedy head, shadow reservation and backfill phases all reconcile
    against it) and whose shadow-time prefix scan runs in the
    ``ebf_shadow`` kernel — O(1) launches per event regardless of queue
    depth.  It takes a :class:`VectorizedAllocator` and runs the shadow
    scan on that allocator's device."""

    name = "vEBF"

    def __init__(self, allocator: VectorizedAllocator) -> None:
        if not isinstance(allocator, VectorizedAllocator):
            raise TypeError("VectorizedEasyBackfilling needs a "
                            "VectorizedAllocator, got "
                            f"{type(allocator).__name__}")
        super().__init__(allocator)
        self.device = allocator.device

    def _make_finder(self, ctx: DispatchContext):
        alloc = self.allocator
        if alloc.batched and ctx.n_queued > 0:
            return alloc.batch_probe(ctx).find
        return super()._make_finder(ctx)

    def _shadow(self, avail, head_vec, n_nodes, releases):
        # grouping + prefix-scan driver in kernels/ebf_shadow.py
        return shadow_from_releases(avail, head_vec, n_nodes, releases,
                                    self.device)
