"""Entry: a policy x seed grid through the port's fleet engine.

One request is one grid: ``FleetRunner().run(sims)`` on the card and
``FleetResult.summary(i)`` for every sim, which is what a user of the
Table-2 study reads.  Its work is the grid's simulated events (the sum
of every sim's ``events``).

Set-up: load (on a checkout's first run, build) the ``fleet_engine``
library, only the instance the system's shape needs; generate the
grid's streams from the seed (seed ``i`` of the grid is ``seeds x seed
+ i``); build each stream once with ``FleetRunner.build`` and give the
configuration's policies that built state; run one warm grid.

The check, after the window, against the plain reference
(``perfbench/reference/fleet_ref.py``), run in worker processes on the
same streams and system for every sim of the grid.  Three numbers,
each with the limit 0:

* ``job_mismatch``: jobs whose start, nodes or state differ from the
  reference's, in the window's last grid, over one sim of every seed
  of the grid (each policy twice in a grid of 16 seeds, drawn from the
  seed);
* ``count_mismatch``: summary counts (events, submitted, completed,
  rejected, end time) that differ from the reference's, over every sim
  of every grid;
* ``grids_failing``: grids with either.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing
import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

COUNTS = ("events", "submitted", "completed", "rejected", "sim_end_time")


def run_references(jobs: List[Tuple[Dict, Dict, str]],
                   broken: Optional[str] = None) -> List[Dict]:
    """``fleet_ref.simulate`` of each ``(stream columns, system,
    policy)``, in up to 8 worker processes, in order."""
    from perfbench.reference import fleet_ref

    args = [(cols, system, policy, broken) for cols, system, policy in jobs]
    workers = max(1, min(len(args), 8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) \
            as pool:
        return list(pool.map(fleet_ref.simulate_star, args))


def compare(program: Dict[str, List], reference: Dict[str, List]) -> int:
    """Jobs whose ``[start, nodes, state]`` differ (or are missing)."""
    keys = set(program) | set(reference)
    return sum(program.get(k) != reference.get(k) for k in keys)


class Entry:
    """The fleet grid of one cell (see the module docstring)."""

    #: device kernels of the timed path, as the profiler names them
    KERNELS = ("fleet_engine",)
    #: host spans of the traced run (beside ``fleet_kernel.*``)
    HOST_SPANS = ("runner.stack", "runner.unstack", "results.summary")

    def __init__(self, cell, seed: int, device: str,
                 jobs: Optional[int] = None,
                 seeds: Optional[int] = None) -> None:
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        cfg = cell.config
        self.policies: List[str] = list(cfg["policies"])
        self.jobs = int(cfg["jobs_per_sim"] if jobs is None else jobs)
        self.n_seeds = int(cfg["seeds_per_grid"] if seeds is None else seeds)
        self.system = cfg["system"]
        self.grid_counts: List[List[Tuple]] = []
        self.last = None                    # the last grid's result
        # one sim of each seed, every policy as often as the others: the
        # sims whose every job is checked (all 128 would take longer
        # than the window to read out)
        rng = random.Random(f"perfbench-sample-{self.seed}")
        order: List[int] = []
        while len(order) < self.n_seeds:
            perm = list(range(len(self.policies)))
            rng.shuffle(perm)
            order += perm
        self.job_sample = [s * len(self.policies) + order[s]
                           for s in range(self.n_seeds)]
        self.info: Dict[str, object] = {}

    # ------------------------------------------------------------------
    def setup(self) -> Dict[str, object]:
        """Everything before the window; returns facts for the log."""
        from repro_torch.fleet.engine import ALLOC_NAMES, SCHED_NAMES
        from repro_torch.fleet.runner import FleetRunner, FleetSim

        codes = {name: code for names in (SCHED_NAMES, ALLOC_NAMES)
                 for code, name in names.items()}
        if self.device == "cuda":
            self._load_library()
        self.make_streams()
        sims = []
        for i, st in enumerate(self.streams):
            base = FleetRunner.build(f"seed{i}", st.records(), self.system,
                                     sched_id=0, alloc_id=0,
                                     seed=self.n_seeds * self.seed + i)
            for pol in self.policies:
                sc, ac = (codes[x] for x in pol.split("-"))
                sims.append(FleetSim(
                    f"{pol}-seed{i}", base.state._replace(
                        sched_id=np.int32(sc), alloc_id=np.int32(ac)),
                    base.meta, sc, ac, base.seed))
        self.sims = sims
        self.runner = FleetRunner(device=self.device)
        warm = self.request()
        self.grid_counts.clear()
        self.info.update(sims=len(sims), jobs_per_sim=self.jobs,
                         events_per_grid=warm)
        return dict(self.info)

    def make_streams(self) -> None:
        """The grid's job streams, from the seed."""
        gen = self.cell.generator()
        self.streams = [gen.generate(self.cell.traffic,
                                     self.n_seeds * self.seed + i, self.jobs)
                        for i in range(self.n_seeds)]

    def _load_library(self) -> None:
        """The fleet kernel's library, built on a checkout's first run;
        past the fast paths' shapes the wide instance as well."""
        import torch
        from repro_torch.kernels import build

        from perfbench.reference.fleet_ref import system_capacity

        build.build_all(["fleet_engine"])
        lib = build.library("fleet_engine")
        cap, _ = system_capacity(self.system)
        index = torch.cuda.current_device()
        wide = lib.fleet_engine_needs_wide(cap.shape[0], cap.shape[1], index)
        build.check(0 if wide >= 0 else -wide, "fleet_engine")
        if wide:
            build.build_all(["fleet_engine_wide"])
            build.library("fleet_engine_wide")
        self.info["kernel_instance"] = "wide" if wide else "fast"

    # ------------------------------------------------------------------
    def request(self, tracer=None) -> int:
        """One grid on the timed path; returns its events."""
        res = self.runner.run(self.sims)
        span = tracer.span("results.summary") if tracer is not None \
            else contextlib.nullcontext()
        with span:
            summaries = [res.summary(i) for i in range(len(self.sims))]
        counts = [tuple(s[k] for k in COUNTS) for s in summaries]
        self.grid_counts.append(counts)
        self.last = res
        return sum(c[0] for c in counts)

    @contextlib.contextmanager
    def instrument(self, tracer):
        """Spans around the names ``fleet/runner.py`` calls: pad and
        stack (``runner.stack``, ending in a synchronise), the kernel's
        launches (``fleet_kernel.<cost class>``, CUDA events), the copy
        back and unstack (``runner.unstack``)."""
        from repro_torch.fleet import runner as rmod
        from repro_torch.fleet.engine import SCHED_EBF
        from repro_torch.fleet.state import SimState

        saved = (rmod.stack, rmod.unstack, rmod.advance, SimState.pad_to,
                 rmod.FleetRunner._launch)
        stack, unstack, advance, pad_to, launch = saved
        cls = ["blocking"]

        def launch_w(runner, sims):
            cls[0] = "ebf" if all(s.sched_id == SCHED_EBF for s in sims) \
                else "blocking"
            return launch(runner, sims)

        def pad_to_w(state, *a, **k):
            with tracer.span("runner.stack"):
                return pad_to(state, *a, **k)

        def stack_w(states, device):
            with tracer.span("runner.stack", sync=True):
                return stack(states, device)

        def advance_w(batch, *a, **k):
            with tracer.kernel(f"fleet_kernel.{cls[0]}"):
                return advance(batch, *a, **k)

        def unstack_w(batch):
            with tracer.span("runner.unstack"):
                return unstack(batch)

        rmod.stack, rmod.unstack, rmod.advance = stack_w, unstack_w, advance_w
        SimState.pad_to = pad_to_w
        rmod.FleetRunner._launch = launch_w
        try:
            yield
        finally:
            (rmod.stack, rmod.unstack, rmod.advance, SimState.pad_to,
             rmod.FleetRunner._launch) = saved

    def device_counters(self) -> Dict[str, int]:
        from repro_torch.kernels import counters

        return counters.device_launch_stats()

    def reset_counters(self) -> None:
        from repro_torch.kernels import counters

        counters.reset_device_launches()

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Free the program's state, except what the check reads."""
        self.runner = None
        self.sims = None

    def reference_jobs(self) -> List[Tuple[Dict, Dict, str]]:
        """The reference's inputs, in the grid's sim order: the same
        streams and system the program was handed."""
        jobs = []
        for st in self.streams:
            cols = {"submit": st.submit, "duration": st.duration,
                    "expected": st.expected, "nodes": st.nodes,
                    "req": st.req}
            jobs += [(cols, self.system, pol) for pol in self.policies]
        return jobs

    def check(self):
        """``(compared, failed)``: each number compared as ``(name,
        value, limit)``, and how many of the window's grids failed.  The
        reference runs in its workers while the last grid's jobs are
        read out here."""
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as bg:
            pending = bg.submit(run_references, self.reference_jobs())
            traces = {i: self.last.trace(i) for i in self.job_sample}
            refs = pending.result()
        want = [tuple(ref[c] for c in COUNTS) for ref in refs]
        bad = set()
        count_mismatch = 0
        for g, counts in enumerate(self.grid_counts):
            miss = sum(a != b for have, ref in zip(counts, want)
                       for a, b in zip(have, ref))
            count_mismatch += miss
            if miss:
                bad.add(g)
        job_mismatch = sum(compare(tr, refs[i]["trace"])
                           for i, tr in traces.items())
        if job_mismatch:
            bad.add(len(self.grid_counts) - 1)
        self.info.update(checked_grids=len(self.grid_counts),
                         sims_checked=len(refs),
                         job_sample=[
                             f"{self.policies[i % len(self.policies)]}"
                             f"-seed{i // len(self.policies)}"
                             for i in self.job_sample],
                         check_s=time.perf_counter() - t0)
        return [("job_mismatch", job_mismatch, 0),
                ("count_mismatch", count_mismatch, 0),
                ("grids_failing", len(bad), 0)], len(bad)
