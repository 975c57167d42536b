"""Resource manager — synthetic system resources backed by a dense matrix.

The paper defines the synthetic system via a JSON config with two parts
(Fig. 7): ``groups`` (per-node resource-type quantities) and the number of
nodes per group.  We keep that schema verbatim::

    {
      "groups": {"compute": {"core": 4, "mem": 1024}},
      "nodes":  {"compute": 120}
    }

Internally availability lives in an ``int64[N_nodes, R_types]`` matrix so
that the dispatch inner loops (fit masks, load scores) are vectorized —
this is the device adaptation described in DESIGN.md §2.  The same
matrix is what the CUDA ``alloc_score`` kernels consume.

Array-native core (DESIGN.md §4): the event manager drives allocation
through the row primitives (:meth:`commit_allocation`,
:meth:`release_rows`) — a completion batch is ONE scatter-add, with no
per-job bookkeeping dict on the hot path.  The legacy per-``Job``
``allocate``/``release`` pair remains for direct callers.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .job import Job


class ResourceManager:
    """Tracks per-node availability; allocates at T_st, releases at T_c."""

    def __init__(self, config: Dict) -> None:
        groups = config["groups"]
        counts = config["nodes"]
        rtypes: List[str] = sorted({rt for g in groups.values() for rt in g})
        self.resource_types: List[str] = rtypes
        # O(1) resource-type -> column lookups (never list.index per job)
        self.rt_index: Dict[str, int] = {rt: i for i, rt in enumerate(rtypes)}
        node_caps: List[List[int]] = []
        node_group: List[str] = []
        for gname in sorted(groups):
            cap = [int(groups[gname].get(rt, 0)) for rt in rtypes]
            for _ in range(int(counts.get(gname, 0))):
                node_caps.append(cap)
                node_group.append(gname)
        if not node_caps:
            raise ValueError("system config defines zero nodes")
        self.capacity = np.asarray(node_caps, dtype=np.int64)        # [N, R]
        self.available = self.capacity.copy()                        # [N, R]
        self.node_group = node_group
        self.n_nodes = self.capacity.shape[0]
        self._allocations: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._n_live = 0          # live allocations (row path + legacy)
        self._group_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "ResourceManager":
        with open(path) as fh:
            return cls(json.load(fh))

    # ------------------------------------------------------------------
    def request_vector(self, job: Job) -> np.ndarray:
        """Per-node request of ``job`` as a dense vector over resource types.

        Always a fresh array the caller may keep or scratch on: bound
        jobs copy their pre-filled table row (rows recycle, so handing
        out a live view would alias a future occupant); detached jobs
        rebuild the vector from the request dict."""
        table = job._table
        if table is not None and table.resource_types == tuple(self.resource_types):
            return table.req[job._row].copy()
        vec = np.zeros(len(self.resource_types), dtype=np.int64)
        rt_index = self.rt_index
        for rt, qty in job.requested_resources.items():
            col = rt_index.get(rt)
            if col is None:
                raise KeyError(f"job {job.id} requests unknown resource {rt!r}")
            vec[col] = int(qty)
        return vec

    def fits_system(self, job: Job) -> bool:
        """Whether the job could EVER run (capacity check, not availability)."""
        vec = self.request_vector(job)
        ok = np.all(self.capacity >= vec[None, :], axis=1)
        return int(ok.sum()) >= job.requested_nodes

    def unfit_rows(self, table, rows, assume_static_capacity: bool = False
                   ) -> np.ndarray:
        """Subset of ``rows`` that can NEVER run on this system (batched
        capacity check over table rows — one numpy expression).

        With ``assume_static_capacity`` the check runs against a cached
        per-group capacity summary (groups, not nodes, on the broadcast
        axis) — only valid while nothing mutates ``capacity`` (no
        failure-injection hooks)."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return rows
        req = table.req[rows]                                    # [J, R]
        if assume_static_capacity:
            if self._group_cache is None:
                ucaps, counts = np.unique(self.capacity, axis=0,
                                          return_counts=True)
                self._group_cache = (ucaps, counts)
            ucaps, counts = self._group_cache
            ok = (ucaps[None, :, :] >= req[:, None, :]).all(axis=2)  # [J, G]
            n_fit = ok @ counts
        else:
            ok = (self.capacity[None, :, :] >= req[:, None, :]).all(axis=2)
            n_fit = ok.sum(axis=1)
        return rows[n_fit < table.requested_nodes[rows]]

    # ------------------------------------------------------------------
    # row-path primitives (the event manager's hot path)
    def commit_allocation(self, job_id: str, idx: np.ndarray,
                          vec: np.ndarray, n_nodes: int) -> None:
        """Subtract ``vec`` from nodes ``idx``; validates like the legacy
        ``allocate`` (count, duplicates, over-allocation)."""
        k = idx.shape[0]
        if k != n_nodes:
            raise ValueError(
                f"job {job_id}: got {k} nodes, needs {n_nodes}")
        if k > 1 and len({int(n) for n in idx}) != k:
            raise ValueError(f"job {job_id}: duplicate nodes in allocation")
        slab = self.available[idx]
        if np.any(slab < vec[None, :]):
            raise RuntimeError(f"job {job_id}: over-allocation attempt")
        self.available[idx] = slab - vec[None, :]
        self._n_live += 1

    def release_allocation(self, idx: np.ndarray, vec: np.ndarray) -> None:
        """Give back one allocation (failure re-queue path)."""
        if idx.size:
            self.available[idx] += vec[None, :]
            assert np.all(self.available[idx] <= self.capacity[idx]), \
                "release overflow"
        self._n_live -= 1

    def release_rows(self, table, rows: Sequence[int]) -> None:
        """Vectorized completion release: give back the allocations of a
        whole completion batch as one scatter-add."""
        assigned = table._assigned
        if len(rows) == 1:
            row = rows[0]
            idx = assigned.get(row)
            if idx is not None and idx.size:
                self.available[idx] += table.req[row][None, :]
            self._n_live -= 1
            return
        parts = []
        counts = []
        for row in rows:
            idx = assigned.get(row)
            if idx is None:
                counts.append(0)
                continue
            parts.append(idx)
            counts.append(idx.shape[0])
        self._n_live -= len(rows)
        if not parts:
            return
        all_idx = np.concatenate(parts)
        vecs = np.repeat(table.req[np.asarray(rows, dtype=np.int64)],
                         counts, axis=0)
        np.add.at(self.available, all_idx, vecs)
        assert np.all(self.available[all_idx] <= self.capacity[all_idx]), \
            "release overflow"

    # ------------------------------------------------------------------
    # legacy per-Job entry points (direct callers, detached jobs)
    def allocate(self, job: Job, nodes: Sequence[int]) -> None:
        if job.id in self._allocations:
            raise RuntimeError(f"job {job.id} already allocated")
        idx = np.asarray(nodes, dtype=np.int64)
        vec = self.request_vector(job)
        self.commit_allocation(job.id, idx, vec, job.requested_nodes)
        self._allocations[job.id] = (idx, vec)

    def release(self, job: Job) -> None:
        entry = self._allocations.pop(job.id, None)
        if entry is None:
            # row-path allocation (started via the event manager): the
            # assignment lives in the job's table row
            nodes = job.assigned_nodes
            if not nodes:
                raise KeyError(f"job {job.id} holds no allocation")
            idx = np.asarray(nodes, dtype=np.int64)
            vec = self.request_vector(job)
        else:
            idx, vec = entry
        self.release_allocation(idx, vec)

    # ------------------------------------------------------------------
    def fit_mask(self, request_vec: np.ndarray) -> np.ndarray:
        """bool[N]: nodes whose *current* availability satisfies the request."""
        return np.all(self.available >= request_vec[None, :], axis=1)

    def load_score(self) -> np.ndarray:
        """float[N]: fraction of capacity in use, summed over resource types
        (Best-Fit prefers high scores — busiest first, paper §3)."""
        cap = np.maximum(self.capacity, 1)
        used = (self.capacity - self.available) / cap
        return used.sum(axis=1)

    def utilization(self) -> Dict[str, float]:
        cap = self.capacity.sum(axis=0)
        used = cap - self.available.sum(axis=0)
        return {
            rt: (float(used[i]) / float(cap[i]) if cap[i] else 0.0)
            for i, rt in enumerate(self.resource_types)
        }

    def snapshot(self) -> Dict[str, object]:
        return {
            "nodes": self.n_nodes,
            "resource_types": list(self.resource_types),
            "utilization": self.utilization(),
            "running_allocations": self._n_live,
        }
