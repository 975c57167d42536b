"""Experiment automation (paper Fig. 5).

    exp = Experiment('my_experiment', workload, sys_cfg)
    exp.gen_dispatchers([FirstInFirstOut, ShortestJobFirst], [FirstFit])
    exp.run_simulation()      # simulates every dispatcher + all plots

Batch planner (DESIGN.md §8): instead of a repeat-loop of host
simulations, ``run_simulation`` now *plans* the dispatcher×repeat grid.
Grid points whose scheduler lowers onto the fleet engine
(FIFO/SJF/LJF/EBF × FirstFit/BestFit, see
``repro_torch.fleet.engine.dispatch_code``) run as ONE batched
``FleetRunner.run`` — every repeat of every compilable dispatcher
advances in the ``fleet_engine`` kernel, one thread block per sim, one
launch per cost class — and their summaries/outputs re-enter the
existing results/plots pipeline unchanged.  Everything else
(data-driven schedulers, runs with custom ``start_kwargs``) falls back
to the host engine per-dispatcher.  Fallbacks are never silent: every
summary row carries ``engine`` ("fleet"/"host") and
``fallback_reason`` (None on the fleet path; on the host path, WHY the
row could not compile — e.g. ``"non-compilable-dispatcher"`` or
``"custom-start-kwargs"``).

Device: ``Experiment(..., device=None)`` runs the fleet rows on the
card (every visible CUDA device) and raises without one;
``device="cpu"`` runs them through the plain PyTorch version
(``fleet.advance_plain``).  Host rows run the numpy ``Simulator``; a
vectorized dispatcher among them runs on its own allocator's device.
A fleet row's ``cpu_time_s``/``wall_time_s``/``dispatch_time_s`` are
its batch's wall time divided by the number of sims in the batch.

Repeat seeding: a ``SyntheticWorkload`` repeat ``rep`` runs on
``base_seed + rep`` (``SyntheticWorkload.reseed``), so repeats draw
independent arrival/duration streams; the seed is recorded in each
repeat's summary.  Non-seeded workloads replay identically and record
no seed.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Type

from ..core.dispatchers.base import AllocatorBase, SchedulerBase
from ..core.resources import ResourceManager
from ..core.simulator import Simulator, default_job_factory
from ..workloads.synthetic import SyntheticWorkload
from .plot_factory import (DECISION_PLOTS, PERFORMANCE_PLOTS,
                           TELEMETRY_PLOTS, PlotFactory)


class Experiment:
    def __init__(self, name: str, workload, sys_config,
                 output_dir: str = "results", repeats: int = 1,
                 use_fleet: bool = True, device=None,
                 **sim_kwargs) -> None:
        self.name = name
        self.workload = workload
        self.sys_config = sys_config
        self.output_dir = os.path.join(output_dir, name)
        self.repeats = max(1, repeats)
        self.use_fleet = use_fleet
        self.device = device
        self.sim_kwargs = sim_kwargs
        self.dispatchers: List[SchedulerBase] = []
        self.results: Dict[str, Dict] = {}

    # ------------------------------------------------------------------
    def gen_dispatchers(self, schedulers: Sequence[Type[SchedulerBase]],
                        allocators: Sequence[Type[AllocatorBase]]) -> None:
        """Cross product of scheduler × allocator classes (paper Fig. 5)."""
        for s_cls in schedulers:
            for a_cls in allocators:
                self.add_dispatcher(s_cls(a_cls()))

    def add_dispatcher(self, scheduler: SchedulerBase) -> None:
        self.dispatchers.append(scheduler)

    # ------------------------------------------------------------------
    # batch planning
    # ------------------------------------------------------------------
    def _repeat_workload(self, rep: int) -> Tuple[object, Optional[int]]:
        """Workload + recorded seed for repeat ``rep``."""
        wl = self.workload
        if isinstance(wl, SyntheticWorkload):
            seed = wl.seed + rep
            return wl.reseed(seed), seed
        return wl, None

    def _fallback_reason(self, sched: SchedulerBase,
                         start_kwargs: Dict) -> Optional[str]:
        """``None`` when this grid row lowers onto the compiled engine;
        otherwise the reason it must run on the host (compilable
        scheduler, a materializable workload, and no host-only knobs —
        custom start kwargs, unknown sim kwargs — are all required)."""
        if not self.use_fleet:
            return "fleet-disabled"
        if start_kwargs:
            return "custom-start-kwargs"
        if not isinstance(self.workload, (SyntheticWorkload, list, tuple)):
            return "host-only-workload"
        # failure scenarios lower onto the compiled engine (DESIGN.md §9),
        # telemetry lowers onto the device-resident buffers (§10)
        extra = set(self.sim_kwargs) - {"job_factory", "lookahead_jobs",
                                        "failures", "checkpoint",
                                        "quarantine_s", "telemetry_stride"}
        if extra:
            return "host-only-sim-kwargs:" + ",".join(sorted(extra))
        from ..fleet.engine import compiles
        if not compiles(sched):
            return "non-compilable-dispatcher"
        return None

    def _rep_name(self, name: str, rep: int) -> str:
        return f"{name}-r{rep}" if self.repeats > 1 else name

    def _run_fleet(self, scheds: List[SchedulerBase]) -> Dict[str, Dict]:
        """Lower ``scheds`` × repeats onto ONE FleetRunner launch."""
        from ..fleet.engine import dispatch_code
        from ..fleet.runner import FleetRunner

        factory = self.sim_kwargs.get("job_factory")
        if factory is None:
            factory = default_job_factory(ResourceManager(self.sys_config))
        failures = self.sim_kwargs.get("failures")
        quarantine_s = int(self.sim_kwargs.get("quarantine_s", 0))
        ckpt_every_s = int(getattr(self.sim_kwargs.get("checkpoint"),
                                   "ckpt_every_s", 0) or 0)
        telemetry_stride = int(self.sim_kwargs.get("telemetry_stride", 0))

        runner = FleetRunner(device=self.device)
        sims, keys = [], []
        for sched in scheds:
            name = sched.dispatcher_name
            s_code, a_code = dispatch_code(sched)
            for rep in range(self.repeats):
                workload, seed = self._repeat_workload(rep)
                sims.append(FleetRunner.build(
                    self._rep_name(name, rep), workload, self.sys_config,
                    s_code, alloc_id=a_code, job_factory=factory,
                    seed=seed, failures=failures,
                    quarantine_s=quarantine_s, ckpt_every_s=ckpt_every_s,
                    telemetry_stride=telemetry_stride))
                keys.append((name, rep))
        result = runner.run(sims)

        out: Dict[str, Dict] = {}
        for i, (name, rep) in enumerate(keys):
            out_path, bench_path = result.write_outputs(self.output_dir, i)
            entry = out.setdefault(name, {"summaries": []})
            summary = result.summary(i)
            summary["fallback_reason"] = None
            entry["summaries"].append(summary)
            entry["output"] = out_path       # last repeat wins (host parity)
            entry["bench"] = bench_path
        return out

    def _run_host(self, sched: SchedulerBase, start_kwargs: Dict,
                  fallback_reason: Optional[str] = None) -> Dict:
        """The per-dispatcher host repeat loop (non-compilable grid rows)."""
        name = sched.dispatcher_name
        summaries = []
        out_path = None
        for rep in range(self.repeats):
            # each repeat runs a FRESH scheduler: data-driven dispatchers
            # (observe_completion) must not leak learned state between
            # repeats, or repeat statistics are biased toward the later
            # (better-informed) runs
            rep_sched = copy.deepcopy(sched)
            rep_sched.reset()
            workload, seed = self._repeat_workload(rep)
            sim = Simulator(workload, self.sys_config, rep_sched,
                            output_dir=self.output_dir,
                            name=self._rep_name(name, rep),
                            **self.sim_kwargs)
            out_path = sim.start_simulation(**start_kwargs)
            summary = dict(sim.summary)
            summary["engine"] = "host"
            summary["fallback_reason"] = fallback_reason
            if seed is not None:
                summary["seed"] = seed
            summaries.append(summary)
        return {
            "summaries": summaries,
            "output": out_path,
            "bench": out_path.replace("-output.jsonl", "-bench.jsonl"),
        }

    # ------------------------------------------------------------------
    def run_simulation(self, produce_plots: bool = True,
                       start_kwargs: Optional[Dict] = None) -> Dict[str, Dict]:
        os.makedirs(self.output_dir, exist_ok=True)
        start_kwargs = start_kwargs or {}

        reasons = {s.dispatcher_name: self._fallback_reason(s, start_kwargs)
                   for s in self.dispatchers}
        fleet_rows = [s for s in self.dispatchers
                      if reasons[s.dispatcher_name] is None]
        fleet_results = self._run_fleet(fleet_rows) if fleet_rows else {}

        outputs, benches, labels = [], [], []
        for sched in self.dispatchers:       # results keep dispatcher order
            name = sched.dispatcher_name
            if name in fleet_results:
                self.results[name] = fleet_results[name]
            else:
                self.results[name] = self._run_host(
                    sched, start_kwargs, fallback_reason=reasons[name])
            outputs.append(self.results[name]["output"])
            benches.append(self.results[name]["bench"])
            labels.append(name)

        with open(os.path.join(self.output_dir, "summaries.json"), "w") as fh:
            json.dump({k: v["summaries"] for k, v in self.results.items()},
                      fh, indent=1)

        if produce_plots:
            pf = PlotFactory("decision", self.sys_config)
            pf.set_files(outputs, labels, benches)
            for kind in DECISION_PLOTS:
                pf.produce_plot(kind)
            pf2 = PlotFactory("performance", self.sys_config)
            pf2.set_files(outputs, labels, benches)
            for kind in PERFORMANCE_PLOTS:
                pf2.produce_plot(kind)
            if int(self.sim_kwargs.get("telemetry_stride", 0)) > 0:
                pf3 = PlotFactory("telemetry", self.sys_config)
                pf3.set_files(outputs, labels, benches)
                for kind in TELEMETRY_PLOTS:
                    pf3.produce_plot(kind)
        return self.results
