"""FleetRunner — whole dispatcher×seed grids in one device launch.

Batching model: each grid point (scheduler code × workload/seed) becomes
one :class:`~repro_torch.fleet.state.SimState`; all states are padded to
a common shape (rows, assignment width, failure events, telemetry
samples), stacked along a leading sim axis into one int32 tensor per
field, and advanced by ONE launch of the ``fleet_engine`` kernel, one
thread block per sim.  With more than one device (every visible card by
default, or an explicit ``devices=`` list) the sim batch is split into
contiguous parts, one launch per device, all in flight together — sims
are independent, so nothing is exchanged between devices.

Mixed grids are first split by dispatch *cost class* (EBF vs plain
blocking schedulers) into separate launches, as the reference does for
its vmapped lanes; a block per sim needs no lockstep, so here the split
only keeps the launches comparable (``run(group_by_cost=False)`` keeps
the single mixed launch, which stays decision-identical and
test-pinned).

The result object re-materializes the host contract: per-sim summaries
with the host ``Simulator.summary`` keys, per-job output records
(``Job.to_record`` schema), golden-trace dicts, and the two JSONL
streams (``{name}-output.jsonl`` / ``{name}-bench.jsonl``) that the
existing metrics/plots pipeline consumes — device wall time is amortized
uniformly over events for the per-event ``dispatch_s`` field, since the
device loop has no per-event host clock.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build
from ..utils import rss_mb
from ..kernels.ops import resolve_device
from .engine import ALLOC_NAMES, SCHED_EBF, SCHED_NAMES, advance, stack, unstack
from .state import COMPLETED, REJECTED, SimMeta, SimState, UNSET_I

try:  # fast JSON if available (mirrors core.simulator)
    import orjson as _json

    def _dumps(obj) -> bytes:
        return _json.dumps(obj)
except Exception:  # pragma: no cover
    def _dumps(obj) -> bytes:
        return json.dumps(obj).encode()


@dataclass
class FleetSim:
    """One grid point: a named, ready-to-run simulation."""

    name: str
    state: SimState
    meta: SimMeta
    sched_id: int
    alloc_id: int = 0
    seed: Optional[int] = None


@dataclass
class FleetResult:
    """Unstacked per-sim final states + host-contract accessors."""

    sims: List[FleetSim]
    finals: List[SimState]
    wall_time_s: float            # total batched device wall time
    compile_time_s: float         # first build/load of the kernel library
    use_kernel: bool
    n_devices: int = 1
    cache_hit: bool = False       # every launch's shape was seen before
    # per-launch telemetry when run() split the grid by dispatch cost
    # class: [{"cost_class", "n_sims", "wall_time_s", ...}, ...]
    launches: List[Dict] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.sims)

    # ------------------------------------------------------------------
    def summary(self, i: int) -> Dict[str, object]:
        """Host ``Simulator.summary``-schema summary for sim ``i``;
        wall/cpu/dispatch seconds are the batched run amortized per sim."""
        f, sim = self.finals[i], self.sims[i]
        n_events = int(f.n_events)
        n_rounds = int(f.n_rounds)
        per_sim = self.wall_time_s / max(len(self.sims), 1)
        launches = n_rounds if self.use_kernel else 0
        rss = rss_mb()
        out = {
            "dispatcher": f"{SCHED_NAMES[sim.sched_id]}-"
                          f"{ALLOC_NAMES[sim.alloc_id]}",
            "events": n_events,
            "submitted": int(f.n_submitted),
            "completed": int(f.n_completed),
            "rejected": int(f.n_rejected),
            "cpu_time_s": per_sim,
            "wall_time_s": per_sim,
            "dispatch_time_s": per_sim,
            "kernel_launches": launches,
            "kernel_launches_per_event": (launches / n_rounds
                                          if n_rounds else 0.0),
            "sim_end_time": int(f.now),
            "mem_avg_mb": rss,
            "mem_max_mb": rss,
            "engine": "fleet",
        }
        if int(f.n_fail) > 0:
            out["failures"] = {
                "requeued_jobs": int(f.n_requeued),
                "lost_work_s": int(f.lost_work_s),
                "node_downtime_s": int(f.node_downtime_s),
            }
        tele = self.telemetry(i)
        if tele is not None:
            out["telemetry"] = {
                "stride": tele.stride,
                "n_samples": tele.n_samples,
                "phase_counters": dict(tele.phase_counters),
            }
        if sim.seed is not None:
            out["seed"] = sim.seed
        return out

    # ------------------------------------------------------------------
    def telemetry(self, i: int):
        """Decode sim ``i``'s device-resident telemetry buffers into the
        engine-neutral :class:`~repro.telemetry.TelemetryTrace`, or None
        when the lane ran without telemetry (S=0 or stride 0).

        ``fail_drain_trips`` is the failure-cursor delta between the
        initial and final states (the cursor advances exactly once per
        drain-loop trip, matching ``EventManager.n_fail_drain_trips``)."""
        f, sim = self.finals[i], self.sims[i]
        cap_s = int(f.tele_buf.shape[0])
        stride = int(f.tele_stride)
        if cap_s == 0 or stride <= 0:
            return None
        from ..telemetry import TelemetryTrace

        n = int(f.tele_n)
        samples = np.asarray(f.tele_buf)[:n].astype(np.int64)
        n_events = int(f.n_events)
        expected = -(-n_events // stride)
        if n_events and (n_events - 1) % stride:
            expected += 1             # the conditional end-of-sim sample
        counters = {
            "dispatch_trips": int(f.ct_disp_trips),
            "shadow_trips": int(f.ct_shadow_trips),
            "backfill_admits": int(f.ct_backfill),
            "misfit_skips": int(f.ct_misfit),
            "fail_drain_trips": int(f.fptr) - int(sim.state.fptr),
        }
        cap = np.asarray(f.capacity).sum(axis=0)
        rts = sim.meta.resource_types
        return TelemetryTrace(
            engine="fleet", name=sim.name, stride=stride,
            resource_types=tuple(rts), samples=samples,
            phase_counters=counters,
            capacity={rt: int(cap[c]) for c, rt in enumerate(rts)},
            truncated=expected > cap_s)

    # ------------------------------------------------------------------
    def records(self, i: int) -> List[Dict[str, object]]:
        """Per-job output records for sim ``i`` (``Job.to_record``
        schema), in row order."""
        f, meta = self.finals[i], self.sims[i].meta
        state = np.asarray(f.state)
        start = np.asarray(f.start)
        end = np.asarray(f.end)
        duration = np.asarray(f.duration)
        submit = np.asarray(f.submit)
        n_need = np.asarray(f.n_need)
        req = np.asarray(f.req)
        assigned = np.asarray(f.assigned)
        rts = meta.resource_types
        out = []
        for row, jid in enumerate(meta.ids):
            if jid is None:
                continue
            st = int(state[row])
            started = st == COMPLETED and start[row] != UNSET_I
            t0 = int(start[row]) if started else None
            waiting = (t0 - int(submit[row])) if started else None
            run = max(int(duration[row]), 1)
            out.append({
                "id": jid,
                "user": int(meta.user[row]),
                "submit": int(submit[row]),
                "start": t0,
                "end": int(end[row]) if started else None,
                "duration": int(duration[row]),
                "expected_duration": int(meta.expected[row]),
                "nodes": int(n_need[row]),
                "resources": {rt: int(req[row, c])
                              for c, rt in enumerate(rts) if req[row, c]},
                "assigned": ([int(x) for x in assigned[row, :n_need[row]]]
                             if started else []),
                "waiting": waiting,
                "slowdown": ((waiting + run) / run) if started else None,
                "state": ("COMPLETED" if st == COMPLETED else
                          "REJECTED" if st == REJECTED else f"STATE{st}"),
            })
        return out

    def trace(self, i: int) -> Dict[str, List]:
        """Golden-fixture format: ``{id: [start, [assigned], state]}``."""
        return {r["id"] if isinstance(r["id"], str) else str(r["id"]):
                [r["start"], r["assigned"], r["state"]]
                for r in self.records(i)}

    # ------------------------------------------------------------------
    def write_outputs(self, output_dir: str, i: int) -> Tuple[str, str]:
        """Write ``{name}-output.jsonl`` and ``{name}-bench.jsonl`` for
        sim ``i`` — byte-compatible with the host simulator's streams, so
        metrics/plots consume them unchanged."""
        os.makedirs(output_dir, exist_ok=True)
        name = self.sims[i].name
        out_path = os.path.join(output_dir, f"{name}-output.jsonl")
        bench_path = os.path.join(output_dir, f"{name}-bench.jsonl")
        with open(out_path, "wb") as fh:
            for rec in self.records(i):
                fh.write(_dumps(rec) + b"\n")

        f = self.finals[i]
        n_events = int(f.n_events)
        summ = self.summary(i)
        dispatch_amort = summ["dispatch_time_s"] / max(n_events, 1)
        log_t = np.asarray(f.log_t)[:n_events]
        log_q = np.asarray(f.log_queue)[:n_events]
        log_r = np.asarray(f.log_running)[:n_events]
        rss = rss_mb()
        with open(bench_path, "wb") as fh:
            for e in range(n_events):
                fh.write(_dumps({
                    "t": int(log_t[e]),
                    "queue": int(log_q[e]),
                    "running": int(log_r[e]),
                    "dispatch_s": dispatch_amort,
                    "kernel_launches": 1 if (self.use_kernel and log_q[e] >= 0)
                                       else 0,
                    "rss_mb": rss,
                }) + b"\n")
            fh.write(_dumps({"summary": summ}) + b"\n")
        self.write_telemetry(output_dir, i)
        return out_path, bench_path

    def write_telemetry(self, output_dir: str, i: int) -> Optional[str]:
        """Write sim ``i``'s ``{name}-telemetry.jsonl`` (the same
        structured-trace stream the host simulator emits); no-op (None)
        for telemetry-free lanes."""
        tele = self.telemetry(i)
        if tele is None:
            return None
        os.makedirs(output_dir, exist_ok=True)
        return tele.write_jsonl(os.path.join(
            output_dir, f"{self.sims[i].name}-telemetry.jsonl"))


# padding buckets: row capacity rounds up to a multiple of _BUCKET_ROWS,
# assignment width to the next power of two — so grids of similar size
# share one compiled executable instead of recompiling per exact shape
_BUCKET_ROWS = 64


def _bucket_rows(m: int) -> int:
    return max(_BUCKET_ROWS, -(-m // _BUCKET_ROWS) * _BUCKET_ROWS)


def _bucket_width(k: int) -> int:
    w = 1
    while w < k:
        w *= 2
    return w


class FleetRunner:
    """Launches a batch of :class:`FleetSim` grid points.

    Parameters
    ----------
    use_kernel:
        AND each dispatch round's fit bits of the whole queue (the
        ``alloc_score`` kernel's device code, inside the fleet kernel)
        into the allocator probes, the BatchProbe pattern.
    device:
        Where the sims run.  None means the card (every visible CUDA
        device, the batch split across them) and raises without one;
        ``"cpu"`` runs the plain PyTorch version.
    devices:
        An explicit list of devices to split the batch across (all of
        one type), in place of ``device``.

    Sims are padded to *bucketed* shapes (rows to a multiple of 64,
    width to a power of two, failure events to a multiple of 16,
    telemetry sample capacity to a multiple of 64 — 0 stays 0 in both
    cases, which selects the kernel built without that machinery;
    padding is inert, pinned by tests).  The kernel library is built (or
    loaded) once per process; ``compile_time_s`` is the time that took
    in the launch that did it, and ``cache_hit`` says whether every
    launch's ``(batch, M, K, F, S, N, R, flags, devices)`` was seen
    before in this process.
    """

    _seen: set = set()

    def __init__(self, use_kernel: bool = False, device=None,
                 devices: Optional[Sequence] = None) -> None:
        self.use_kernel = use_kernel
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
            if not devs or len({d.type for d in devs}) != 1:
                raise ValueError(f"devices must be one type: {devices}")
        else:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                devs = [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            else:
                devs = [dev]
        self.devices = devs

    # ------------------------------------------------------------------
    @staticmethod
    def build(name: str, workload: Iterable, sys_config: Dict,
              sched_id: int, alloc_id: int = 0, job_factory=None,
              seed: Optional[int] = None, failures=None,
              quarantine_s: int = 0, ckpt_every_s: int = 0,
              telemetry_stride: int = 0,
              telemetry_samples: Optional[int] = None) -> FleetSim:
        """Materialize one grid point from a workload.  ``failures`` /
        ``quarantine_s`` / ``ckpt_every_s`` install a device-resident
        FAIL/REPAIR schedule (``Simulator(failures=...)`` semantics).
        ``telemetry_stride`` > 0 allocates device-resident telemetry
        buffers (DESIGN.md §10) decoded by ``FleetResult.telemetry``."""
        state, meta = SimState.from_workload(
            workload, sys_config, job_factory=job_factory,
            sched_id=sched_id, alloc_id=alloc_id, failures=failures,
            quarantine_s=quarantine_s, ckpt_every_s=ckpt_every_s,
            telemetry_stride=telemetry_stride,
            telemetry_samples=telemetry_samples)
        return FleetSim(name=name, state=state, meta=meta,
                        sched_id=sched_id, alloc_id=alloc_id, seed=seed)

    # ------------------------------------------------------------------
    def run(self, sims: Sequence[FleetSim],
            group_by_cost: bool = True) -> FleetResult:
        """Advance every sim to completion in batched device launches.

        ``group_by_cost`` (default on) launches EBF lanes and plain
        blocking lanes separately; each lane's trajectory is independent
        of its batch either way (pinned by tests).  Homogeneous batches
        always take the single-launch path; ``wall_time_s`` /
        ``compile_time_s`` sum over launches and ``cache_hit`` reports
        whether *every* launch's shape was seen before.
        """
        if not sims:
            raise ValueError("empty fleet")
        shapes = {s.state.avail.shape for s in sims}
        if len(shapes) != 1:
            raise ValueError(f"sims target different systems: {shapes}")
        heavy = [i for i, s in enumerate(sims) if s.sched_id == SCHED_EBF]
        light = [i for i, s in enumerate(sims) if s.sched_id != SCHED_EBF]
        groups = ([light, heavy] if group_by_cost and light and heavy
                  else [list(range(len(sims)))])
        finals: List[Optional[SimState]] = [None] * len(sims)
        wall = compile_time = 0.0
        cache_hit = True
        n_dev = 1
        launches: List[Dict] = []
        for idx in groups:
            part, w, c, hit, nd = self._launch([sims[i] for i in idx])
            for j, i in enumerate(idx):
                finals[i] = part[j]
            wall += w
            compile_time += c
            cache_hit &= hit
            n_dev = max(n_dev, nd)
            classes = {"ebf" if sims[i].sched_id == SCHED_EBF else "blocking"
                       for i in idx}
            launches.append({
                "cost_class": classes.pop() if len(classes) == 1 else "mixed",
                "n_sims": len(idx),
                "events": sum(int(part[j].n_events) for j in range(len(idx))),
                "wall_time_s": round(w, 6),
                "compile_time_s": round(c, 6),
                "cache_hit": hit,
            })
        return FleetResult(sims=list(sims), finals=finals,
                           wall_time_s=wall, compile_time_s=compile_time,
                           use_kernel=self.use_kernel, n_devices=n_dev,
                           cache_hit=cache_hit, launches=launches)

    # ------------------------------------------------------------------
    def _launch(self, sims: Sequence[FleetSim]):
        """One padded/stacked launch of a homogeneous-cost batch, split
        across the devices; returns ``(finals, wall_s, compile_s,
        cache_hit, n_devices)``."""
        m = _bucket_rows(max(s.state.n_rows for s in sims))
        k = _bucket_width(max(s.state.assigned.shape[1] for s in sims))
        # failure schedules pad like jobs: bucket to a multiple of 16;
        # fev == 0 (no sim in the batch has a schedule) selects the
        # failure-free kernel
        fev = max(s.state.fail_ev.shape[0] for s in sims)
        fev = -(-fev // 16) * 16 if fev else 0
        # telemetry sample capacity buckets like rows (multiple of 64);
        # ts == 0 (no sim carries buffers) selects the telemetry-free
        # kernel
        ts = max(s.state.tele_buf.shape[0] for s in sims)
        ts = -(-ts // _BUCKET_ROWS) * _BUCKET_ROWS if ts else 0
        padded = [s.state.pad_to(m, k, fev, ts) for s in sims]

        devs = self.devices[:len(padded)]
        n, r = padded[0].avail.shape
        key = (len(padded), m, k, fev, ts, n, r, self.use_kernel,
               tuple(str(d) for d in devs))
        cache_hit = key in self._seen
        self._seen.add(key)
        compile_time = 0.0
        if devs[0].type == "cuda" and "fleet_engine" not in build._loaded:
            t0 = time.time()
            build.library("fleet_engine")
            compile_time = time.time() - t0
        # contiguous parts, one per device, as even as they come
        cuts = np.linspace(0, len(padded), len(devs) + 1).round().astype(int)
        t0 = time.time()
        batches = [advance(stack(padded[a:b], dev), self.use_kernel)
                   for dev, a, b in zip(devs, cuts[:-1], cuts[1:])]
        finals = [f for batch in batches for f in unstack(batch)]
        wall = time.time() - t0
        return finals, wall, compile_time, cache_hit, len(devs)
