"""The Simulator — AccaSim's top-level class (paper Fig. 4).

    sim = Simulator('workload.swf', 'sys_config.json', dispatcher)
    output_file = sim.start_simulation()

Design notes mirroring the paper:
  * discrete event loop over submission/completion times (never ticks
    through empty seconds);
  * incremental job loading through the reader (LOADED window) and
    recycling of completed jobs' table rows — memory stays ~flat w.r.t.
    workload size;
  * two output streams: per-job dispatching records, and per-event-point
    simulator performance records (CPU time split dispatch vs other, RSS);
  * optional monitors + additional-data hooks.

Array-native core (DESIGN.md §4): workload records stream STRAIGHT into
``JobTable`` rows (``JobFactory.fill_row``) — a per-job ``Job`` object is
only built where the legacy API demands one.  The per-event capacity
sanity check runs as one batched numpy expression over the newly
submitted rows (all queued rows when additional-data hooks may have
mutated capacity), and dispatch decisions execute through the row-index
fast path.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Union

try:  # fast JSON if available (offline container ships orjson)
    import orjson as _json

    def _dumps(obj) -> bytes:
        return _json.dumps(obj)
except Exception:  # pragma: no cover
    def _dumps(obj) -> bytes:
        return json.dumps(obj).encode()

from ..utils import rss_mb
from .additional_data import AdditionalData, NodeFailureModel
from .dispatchers.base import Dispatcher, SchedulerBase
from .dispatchers.context import DispatchContext
from .events import EventManager
from .job import Job, JobFactory, swf_resource_mapper
from .jobtable import JobTable
from .monitors import SystemStatus, UtilizationMonitor
from .resources import ResourceManager


def default_job_factory(rm: ResourceManager) -> JobFactory:
    """The Simulator's default factory: SWF totals -> node-spanning
    request, sized by the densest node group of the system (shared with
    the fleet batch planner so both engines parse records identically)."""
    cores = int(max(rm.capacity[:, rm.rt_index["core"]])) \
        if "core" in rm.rt_index else 1
    mem_i = rm.rt_index.get("mem")
    mem = int(max(rm.capacity[:, mem_i])) if mem_i is not None else 0
    return JobFactory(swf_resource_mapper(cores, mem))


class Simulator:
    def __init__(
        self,
        workload: Union[str, Iterable],
        sys_config: Union[str, Dict],
        dispatcher: Union[Dispatcher, SchedulerBase],
        job_factory: Optional[JobFactory] = None,
        lookahead_jobs: int = 8192,
        output_dir: str = "results",
        name: Optional[str] = None,
        failures=None,
        checkpoint=None,
        quarantine_s: int = 0,
        telemetry_stride: int = 0,
    ) -> None:
        """``failures`` (a ``FailureInjector`` or its ``(times, nodes,
        is_fail)`` arrays) installs a native node FAIL/REPAIR event
        schedule on the event manager (DESIGN.md §9): failures preempt +
        requeue victims, ``checkpoint`` (a ``CheckpointRestartPolicy``)
        decides the remaining duration, and failed/quarantined nodes are
        masked out of every dispatcher's context for ``quarantine_s``
        seconds after each failure.

        ``telemetry_stride`` > 0 turns on the unified telemetry layer
        (DESIGN.md §10): one telemetry-schema sample every ``stride``
        events plus per-phase dispatch counters, decoded into
        ``self.telemetry`` (a :class:`~repro_torch.telemetry.TelemetryTrace`),
        summarized under ``summary["telemetry"]`` and written to
        ``{name}-telemetry.jsonl``."""
        if isinstance(sys_config, str):
            with open(sys_config) as fh:
                sys_config = json.load(fh)
        self.sys_config = sys_config
        self.rm = ResourceManager(sys_config)
        if isinstance(dispatcher, SchedulerBase):
            dispatcher = Dispatcher(dispatcher)
        self.dispatcher = dispatcher
        self._workload = workload
        self._lookahead = lookahead_jobs
        self.output_dir = output_dir
        self.name = name or self.dispatcher.name
        if job_factory is None:
            job_factory = default_job_factory(self.rm)
        self.job_factory = job_factory
        self.failures = failures
        self.checkpoint = checkpoint
        self.quarantine_s = quarantine_s
        self.telemetry_stride = int(telemetry_stride)
        self.telemetry = None

    # ------------------------------------------------------------------
    def _row_iterator(self, table: JobTable) -> Iterator:
        """Stream the workload into the job table: records become rows
        directly (no per-job ``Job`` object); pre-built ``Job`` instances
        pass through for the event manager to adopt."""
        wl = self._workload
        fill = self.job_factory.fill_row
        if isinstance(wl, str):
            from ..workloads.swf import SWFReader

            reader = SWFReader(wl)
            for rec in reader:
                yield fill(table, rec)
        else:
            for item in wl:
                if isinstance(item, Job):
                    yield item
                else:
                    yield fill(table, item)

    # ------------------------------------------------------------------
    def start_simulation(
        self,
        system_status: bool = False,
        system_utilization: bool = False,
        additional_data: Optional[List[AdditionalData]] = None,
        bench_sample_every: int = 1,
        max_events: Optional[int] = None,
        write_output: bool = True,
    ) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        out_path = os.path.join(self.output_dir, f"{self.name}-output.jsonl")
        bench_path = os.path.join(self.output_dir, f"{self.name}-bench.jsonl")
        out_fh = open(out_path, "wb") if write_output else None
        bench_fh = open(bench_path, "wb") if write_output else None

        sched = self.dispatcher.scheduler
        observe = getattr(sched, "observe_completion", None)

        if observe is None and out_fh is None:
            on_complete = None        # nothing to do -> skip façades entirely
        else:
            def on_complete(job: Job) -> None:
                if observe is not None and job.state.name == "COMPLETED":
                    observe(job)      # data-driven dispatchers learn online
                if out_fh is not None:
                    out_fh.write(_dumps(job.to_record()) + b"\n")

        table = JobTable(self.rm.resource_types)
        em = EventManager(
            self._row_iterator(table), self.rm,
            lookahead_jobs=self._lookahead, on_complete=on_complete,
            table=table)
        if self.failures is not None:
            arrays = self.failures.arrays() \
                if hasattr(self.failures, "arrays") else self.failures
            em.set_failure_schedule(*arrays, checkpoint=self.checkpoint,
                                    quarantine_s=self.quarantine_s)
        self.event_manager = em

        status = SystemStatus() if system_status else None
        util = None
        if system_utilization or self.telemetry_stride > 0:
            util = UtilizationMonitor(
                sample_every=self.telemetry_stride or 1)
        self.utilization_monitor = util
        # per-phase dispatch counters (telemetry layer, DESIGN.md §10)
        phase_totals: Optional[Dict[str, int]] = \
            {} if self.telemetry_stride > 0 else None
        adata = additional_data or []
        for ad in adata:
            if isinstance(ad, NodeFailureModel):
                ad.bind(self.rm)

        t_start = time.process_time()
        wall_start = time.time()
        dispatch_total = 0.0
        n_events = 0
        n_dispatch_events = 0
        kernel_launches_total = 0
        mem_samples: List[float] = []

        while em.has_events():
            t = em.next_event_time()
            # additional-data sources (failures, power traces) contribute
            # wake-up times between job events
            for ad in adata:
                ad_t = ad.next_event_time()
                if ad_t is not None and ad_t > em.current_time and \
                        (t is None or ad_t < t) and (em.n_running or em.n_queued):
                    t = ad_t
            if t is None:
                if em.n_queued:
                    # queued jobs remain but no event can free resources and
                    # no submissions remain -> they can never start (they
                    # were capacity-checked, so this means a livelock from
                    # failed nodes); reject to terminate cleanly.
                    for row in em.queue_rows():
                        em.reject_row(int(row))
                break
            _, submitted = em.advance_to(t)

            ad_view = {}
            for ad in adata:
                ad_view[ad.name] = ad.update(em)
            self.additional_view = ad_view

            # capacity sanity: reject jobs that can never fit this system.
            # Capacity only changes through additional-data hooks (node
            # failures), so without them only NEW submissions need the
            # check — one batched numpy expression either way.
            check_rows = em.queue_rows() if adata else submitted
            if len(check_rows):
                unfit = self.rm.unfit_rows(em.table, check_rows,
                                           assume_static_capacity=not adata)
                for row in unfit:
                    em.reject_row(int(row))

            dt_launches = 0
            dt_dispatch = 0.0
            if em.n_queued:
                d0 = time.perf_counter()
                # one frozen context per event point; the dispatcher
                # answers with a DispatchPlan (batched protocol)
                ctx = DispatchContext.from_event_manager(t, em)
                plan = self.dispatcher.plan(ctx)
                self.last_plan = plan
                for job, nodes in plan.starts:
                    em.start_job(job, nodes)
                for job in plan.rejects:
                    em.reject_job(job)
                dt_launches = int(plan.stats.get("kernel_launches", 0))
                kernel_launches_total += dt_launches
                if phase_totals is not None:
                    for k, v in plan.stats.get(
                            "phase_counters", {}).items():
                        phase_totals[k] = phase_totals.get(k, 0) + int(v)
                n_dispatch_events += 1
                dt_dispatch = time.perf_counter() - d0
                dispatch_total += dt_dispatch

            if status is not None:
                self.last_status = status.query(em)
            if util is not None:
                util.observe(em)

            n_events += 1
            if n_events % max(bench_sample_every, 1) == 0:
                rss = rss_mb()
                mem_samples.append(rss)
                if bench_fh is not None:
                    bench_fh.write(_dumps({
                        "t": t,
                        "queue": em.n_queued,
                        "running": em.n_running,
                        "dispatch_s": dt_dispatch,
                        "kernel_launches": dt_launches,
                        "rss_mb": rss,
                    }) + b"\n")
            if max_events is not None and n_events >= max_events:
                break

        if util is not None:
            # end-of-sim sample (after livelock rejections, matching the
            # fleet engine's post-loop ordering)
            util.finalize(em)

        cpu_total = time.process_time() - t_start
        self.summary = {
            "dispatcher": self.dispatcher.name,
            "events": n_events,
            "submitted": em.n_submitted,
            "completed": em.n_completed,
            "rejected": em.n_rejected,
            "cpu_time_s": cpu_total,
            "wall_time_s": time.time() - wall_start,
            "dispatch_time_s": dispatch_total,
            "kernel_launches": kernel_launches_total,
            "kernel_launches_per_event": (
                kernel_launches_total / n_dispatch_events
                if n_dispatch_events else 0.0),
            "sim_end_time": em.current_time,
            "mem_avg_mb": (sum(mem_samples) / len(mem_samples)) if mem_samples else rss_mb(),
            "mem_max_mb": max(mem_samples) if mem_samples else rss_mb(),
        }
        if em._fail_t is not None:
            self.summary["failures"] = {
                "requeued_jobs": em.n_requeued,
                "lost_work_s": em.lost_work_s,
                "node_downtime_s": em.node_downtime_s,
            }
        if phase_totals is not None:
            phase_totals["fail_drain_trips"] = \
                phase_totals.get("fail_drain_trips", 0) + \
                int(getattr(em, "n_fail_drain_trips", 0))
            cap = self.rm.capacity.sum(axis=0)
            self.telemetry = util.to_trace(
                self.name, self.rm.resource_types,
                {rt: int(cap[i])
                 for i, rt in enumerate(self.rm.resource_types)},
                phase_counters=phase_totals)
            self.summary["telemetry"] = {
                "stride": self.telemetry.stride,
                "n_samples": self.telemetry.n_samples,
                "phase_counters": dict(self.telemetry.phase_counters),
            }
            if write_output:
                self.telemetry.write_jsonl(os.path.join(
                    self.output_dir, f"{self.name}-telemetry.jsonl"))
        if write_output:
            out_fh.close()
            bench_fh.write(_dumps({"summary": self.summary}) + b"\n")
            bench_fh.close()
        return out_path
