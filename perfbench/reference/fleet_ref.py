"""The plain reference: AccaSim's event-driven simulation in NumPy.

One simulation of a job stream on a system under one of the paper's
Table-2 dispatchers, {FIFO, SJF, LJF, EBF} x {FF, BF}, with AccaSim's
semantics (arXiv:1806.06728, section 3), written from them and from
nothing of the program under test:

* Events.  The next event time is the earliest of the next submission
  and the next completion.  At an event, every completion due releases
  its nodes first, then every submission due enters the queue (in order
  of submission time, ties in stream order) or, when the system could
  never hold it (fewer nodes whose capacity covers the per-node request
  than the job asks for), is rejected.  A dispatch round follows when
  the queue is not empty.  A job submitted at ``s`` is queued at ``s``,
  and runs ``duration`` seconds from its start.
* Priorities.  FIFO and EBF take the queue in submission order; SJF by
  (walltime estimate, queue time, submission order), LJF by (minus the
  estimate, queue time, submission order).  The estimate is the job's
  expected duration, at least 1.
* Blocking (FIFO, SJF, LJF).  Jobs start in priority order until the
  first one that does not fit; nothing jumps the queue.
* EASY backfilling (EBF).  Queue-head jobs start while they fit.  For
  the first blocked job (the head), the shadow time is the earliest
  estimated release instant (a running job releases at ``max(start +
  estimate, now + 1)``; releases at one instant count together) at
  which the head fits; its nodes are reserved there, from the
  availability at that instant.  A later job, in submission order,
  starts now if it fits now and either ends by its estimate before the
  shadow time, or fits within what the reservation leaves spare (the
  minimum of the availability now and the spare availability at the
  shadow time, which it then uses up).
* Allocation.  FF takes the first ``need`` fitting nodes by node id; BF
  the first ``need`` fitting nodes ordered busiest first, by the load
  ``sum_r (capacity - free) / max(capacity, 1)``, ties by node id.

Nodes are numbered by group name, then in order within a group;
resource types are sorted by name.  ``broken`` names one guarantee to
break, for the benchmark's control: ``"reservation"`` lets EBF backfill
any job that fits now (the head's reservation is not kept);
``"bf_ties"`` breaks BF's load ties by the highest node id.

Run as a script to time it: ``python3 perfbench/reference/fleet_ref.py``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

SCHEDULERS = ("FIFO", "SJF", "LJF", "EBF")
ALLOCATORS = ("FF", "BF")
INF = np.iinfo(np.int64).max // 4


def system_capacity(system: Dict) -> Tuple[np.ndarray, List[str]]:
    """``(capacity int64[N, R], resource types)`` of an AccaSim system
    config ``{"groups": {name: {type: amount}}, "nodes": {name: count}}``."""
    groups, counts = system["groups"], system["nodes"]
    rts = sorted({rt for g in groups.values() for rt in g})
    rows = []
    for name in sorted(groups):
        cap = [int(groups[name].get(rt, 0)) for rt in rts]
        rows += [cap] * int(counts.get(name, 0))
    return np.asarray(rows, dtype=np.int64).reshape(-1, len(rts)), rts


class _Sim:
    def __init__(self, submit, duration, expected, need, req, capacity,
                 sched: str, alloc: str, broken: Optional[str]):
        if sched not in SCHEDULERS or alloc not in ALLOCATORS:
            raise ValueError(f"unknown dispatcher {sched}-{alloc}")
        self.submit = np.asarray(submit, dtype=np.int64)
        self.duration = np.maximum(np.asarray(duration, dtype=np.int64), 0)
        self.est = np.maximum(np.asarray(expected, dtype=np.int64), 1)
        self.need = np.asarray(need, dtype=np.int64)
        self.req = np.asarray(req, dtype=np.int64)
        self.cap = np.asarray(capacity, dtype=np.int64)
        self.cap1 = np.maximum(self.cap, 1).astype(np.float64)
        self.sched, self.alloc, self.broken = sched, alloc, broken
        j = self.submit.shape[0]
        self.n_nodes = self.cap.shape[0]
        # submission order: by time, ties in stream order
        self.order = np.argsort(self.submit, kind="stable")
        rank = np.empty(j, dtype=np.int64)
        rank[self.order] = np.arange(j)
        if sched == "SJF":
            pri = np.lexsort((rank, self.submit, self.est))
        elif sched == "LJF":
            pri = np.lexsort((rank, self.submit, -self.est))
        else:
            pri = self.order
        self.pri_jobs = pri                     # position -> job
        self.pos = np.empty(j, dtype=np.int64)  # job -> position
        self.pos[pri] = np.arange(j)
        # distinct per-node requests: fit counts once per distinct row
        self.ureq, self.uid = np.unique(self.req, axis=0, return_inverse=True)
        self.uid = self.uid.reshape(-1)
        ever = self._counts(self.cap)
        self.unfit = ever[self.uid] < self.need
        kmax = int(self.need.max()) if j else 1
        self.assigned = np.full((j, max(kmax, 1)), -1, dtype=np.int64)
        self.start = np.full(j, -1, dtype=np.int64)
        self.state = np.zeros(j, dtype=np.int8)  # 0 pending 1 queued 2 run
        # 3 completed 4 rejected

    # ------------------------------------------------------------------
    def _counts(self, pool: np.ndarray) -> np.ndarray:
        """Nodes of ``pool`` that hold each distinct request."""
        ok = pool[None, :, 0] >= self.ureq[:, 0, None]
        for r in range(1, pool.shape[1]):
            ok &= pool[None, :, r] >= self.ureq[:, r, None]
        return np.count_nonzero(ok, axis=1)

    def _find(self, j: int, pool: np.ndarray) -> Optional[np.ndarray]:
        fit = (pool >= self.req[j][None, :]).all(axis=1)
        need = int(self.need[j])
        if int(fit.sum()) < need:
            return None
        if self.alloc == "FF":
            return np.flatnonzero(fit)[:need]
        load = ((self.cap - pool) / self.cap1).sum(axis=1)
        if self.broken == "bf_ties":
            order = self.n_nodes - 1 - np.argsort(-load[::-1], kind="stable")
        else:
            order = np.argsort(-load, kind="stable")
        return order[fit[order]][:need]

    def _start(self, j: int, nodes: np.ndarray, t: int, avail) -> None:
        avail[nodes] -= self.req[j][None, :]
        self.assigned[j, :nodes.shape[0]] = nodes
        self.start[j] = t
        self.state[j] = 2
        self.queued[self.pos[j]] = False
        heapq.heappush(self.heap, (t + int(self.duration[j]), j))

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        j_total = self.submit.shape[0]
        avail = self.cap.copy()
        self.queued = np.zeros(j_total, dtype=bool)   # by priority position
        self.heap: List[Tuple[int, int]] = []
        ptr = n_events = 0
        now = 0
        n_rejected = n_completed = 0
        while ptr < j_total or self.heap or self.queued.any():
            t_sub = int(self.submit[self.order[ptr]]) if ptr < j_total \
                else INF
            t_end = self.heap[0][0] if self.heap else INF
            t = min(t_sub, t_end)
            if t >= INF:                      # queued jobs that never fit
                left = self.pri_jobs[self.queued]
                self.state[left] = 4
                n_rejected += left.shape[0]
                self.queued[:] = False
                break
            while self.heap and self.heap[0][0] <= t:
                _, j = heapq.heappop(self.heap)
                nodes = self.assigned[j, :self.need[j]]
                avail[nodes] += self.req[j][None, :]
                self.state[j] = 3
                n_completed += 1
            while ptr < j_total and self.submit[self.order[ptr]] <= t:
                j = int(self.order[ptr])
                ptr += 1
                if self.unfit[j]:
                    self.state[j] = 4
                    n_rejected += 1
                else:
                    self.state[j] = 1
                    self.queued[self.pos[j]] = True
            if self.queued.any():
                if self.sched == "EBF":
                    self._easy(t, avail)
                else:
                    self._blocking(t, avail)
            n_events += 1
            now = t
        return {"events": n_events, "submitted": int(ptr),
                "completed": n_completed, "rejected": n_rejected,
                "sim_end_time": int(now)}

    def _blocking(self, t: int, avail: np.ndarray) -> None:
        for j in self.pri_jobs[np.flatnonzero(self.queued)]:
            nodes = self._find(int(j), avail)
            if nodes is None:
                return
            self._start(int(j), nodes, t, avail)

    def _easy(self, t: int, avail: np.ndarray) -> None:
        queue = self.pri_jobs[np.flatnonzero(self.queued)]
        i = 0
        while i < queue.shape[0]:
            nodes = self._find(int(queue[i]), avail)
            if nodes is None:
                break
            self._start(int(queue[i]), nodes, t, avail)
            i += 1
        if i >= queue.shape[0]:
            return
        head = int(queue[i])
        found = self._shadow(head, t, avail)
        if found is None:
            return
        shadow_t, shadow_avail = found
        extra = shadow_avail.copy()
        extra[self._find(head, shadow_avail)] -= self.req[head][None, :]
        cands = queue[i + 1:]
        before = t + self.est[cands] <= shadow_t
        if self.broken == "reservation":
            before[:] = True
        k = 0
        while k < cands.shape[0]:
            pool_b = np.minimum(avail, extra)
            cnt_a, cnt_b = self._counts(avail), self._counts(pool_b)
            u = self.uid[cands[k:]]
            cnt = np.where(before[k:], cnt_a[u], cnt_b[u])
            ok = np.flatnonzero(cnt >= self.need[cands[k:]])
            if ok.shape[0] == 0:
                return
            k += int(ok[0])
            j = int(cands[k])
            pool = avail if before[k] else pool_b
            nodes = self._find(j, pool)
            if not before[k]:
                extra[nodes] -= self.req[j][None, :]
            self._start(j, nodes, t, avail)
            k += 1

    def _shadow(self, head: int, t: int, avail: np.ndarray):
        """Earliest estimated release instant at which the head fits, and
        the availability then; None if it never does."""
        hreq, need = self.req[head], int(self.need[head])
        run = np.flatnonzero(self.state == 2)
        if run.shape[0] == 0:
            return None
        rel = np.maximum(self.start[run] + self.est[run], t + 1)
        a = self.assigned[run]
        held = a >= 0
        node_e = a[held]
        time_e = np.broadcast_to(rel[:, None], a.shape)[held]
        vec_e = np.repeat(self.req[run], held.sum(axis=1), axis=0)
        # per node, in release order: free resources after each release
        o = np.argsort((node_e << 40) | time_e, kind="stable")
        node_e, time_e, vec_e = node_e[o], time_e[o], vec_e[o]
        csum = np.cumsum(vec_e, axis=0)
        starts = np.flatnonzero(np.r_[True, node_e[1:] != node_e[:-1]])
        before_node = np.zeros((starts.shape[0], csum.shape[1]), np.int64)
        before_node[1:] = csum[starts[1:] - 1]
        seg = np.diff(np.r_[starts, node_e.shape[0]])
        free_e = avail[node_e] + csum - np.repeat(before_node, seg, axis=0)
        ok = (free_e >= hreq[None, :]).all(axis=1)
        fit_t = np.full(self.n_nodes, INF, dtype=np.int64)
        np.minimum.at(fit_t, node_e[ok], time_e[ok])
        fit_t[(avail >= hreq[None, :]).all(axis=1)] = -1
        if int((fit_t < INF).sum()) < need:
            return None
        shadow_t = int(np.partition(fit_t, need - 1)[need - 1])
        cur = avail.copy()
        due = time_e <= shadow_t
        np.add.at(cur, node_e[due], vec_e[due])
        return shadow_t, cur

    # ------------------------------------------------------------------
    def trace(self) -> Dict[str, List]:
        """``{job id: [start, [nodes], state]}`` (ids are stream rows)."""
        out = {}
        for j in range(self.submit.shape[0]):
            if self.state[j] == 3:
                out[str(j)] = [int(self.start[j]),
                               self.assigned[j, :self.need[j]].tolist(),
                               "COMPLETED"]
            else:
                out[str(j)] = [None, [], "REJECTED"]
        return out


def simulate(stream: Dict[str, np.ndarray], system: Dict, policy: str,
             broken: Optional[str] = None) -> Dict:
    """Run one simulation to its end.

    ``stream`` holds int64 columns ``submit``, ``duration``,
    ``expected``, ``nodes`` and ``req`` (a dict: resource type -> per
    node request); ``policy`` is ``"<SCHED>-<ALLOC>"``.  Returns the
    summary counts (``events``, ``submitted``, ``completed``,
    ``rejected``, ``sim_end_time``) and ``trace``.
    """
    cap, rts = system_capacity(system)
    req = np.stack([np.asarray(stream["req"].get(rt, np.zeros_like(
        stream["submit"])), dtype=np.int64) for rt in rts], axis=1)
    sched, alloc = policy.split("-")
    sim = _Sim(stream["submit"], stream["duration"], stream["expected"],
               stream["nodes"], req, cap, sched, alloc, broken)
    out = sim.run()
    out["trace"] = sim.trace()
    return out


def simulate_star(args) -> Dict:
    """``simulate(*args)``, for a process pool's ``map``."""
    return simulate(*args)


if __name__ == "__main__":
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import json

    from perfbench.streams import job_stream

    root = Path(__file__).resolve().parents[1]
    for cfg_name, traffic_name in (("seth", "seth_stream"),
                                   ("ricc", "ricc_flood")):
        cfg = json.loads((root / "configs" / f"{cfg_name}.json").read_text())
        traffic = json.loads(
            (root / "traffic" / f"{traffic_name}.json").read_text())
        st = job_stream.generate(traffic, 1, cfg["jobs_per_sim"])
        cols = {"submit": st.submit, "duration": st.duration,
                "expected": st.expected, "nodes": st.nodes, "req": st.req}
        for pol in ("FIFO-FF", "SJF-BF", "EBF-FF", "EBF-BF"):
            t0 = time.perf_counter()
            out = simulate(cols, cfg["system"], pol)
            print(cfg_name, pol, out["events"], out["sim_end_time"],
                  f"{time.perf_counter() - t0:.2f} s")
