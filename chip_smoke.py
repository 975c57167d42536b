#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of AccaSim, on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and drives the simulator's main path on the card:

1. card: name and power limit, torch and CUDA versions, kernel build;
2. Seth (the paper's Fig. 7 system, 120 nodes x 4 cores x 1 GB) with a
   Seth-like stream of 10,000 jobs: the 8 vectorized Table-2 rows and
   the per-job FIFO-vFF row on CUDA, each against its numpy twin;
3. a RICC-sized system (1024 nodes x 8 cores x 12 GB) with 5,000 jobs
   submitted within the first hour, so the queue is thousands of jobs
   deep: vEBF-vBF, FIFO-vBF and per-job FIFO-vFF against their numpy
   twins, capped by ``max_events``;
4. kernels: each kernel against its plain PyTorch version on the card,
   on the largest inputs the main path gave it plus ragged and
   -1-floored cases (fit exact, score bitwise), with its time, the plain
   version's time and its bound.

The per-event dispatch traces of every vectorized row must equal its
numpy twin's, launches per event must stay within the batched contract,
and every kernel must have launched on the main path.  The last two
lines are the kernel table and ``{"ok": true, "device": ...}``; any
failure exits non-zero before them.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import Job, Simulator  # noqa: E402
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling,  # noqa: E402
                                          FirstFit, FirstInFirstOut,
                                          LongestJobFirst, ShortestJobFirst)
from repro_torch.core.dispatchers.base import SchedulerBase  # noqa: E402
from repro_torch.core.dispatchers.vectorized import (  # noqa: E402
    VectorizedAllocator, VectorizedEasyBackfilling)
from repro_torch.kernels import alloc_score as k_alloc  # noqa: E402
from repro_torch.kernels import build, counters, ops, ref  # noqa: E402
from repro_torch.kernels import ebf_shadow as k_ebf  # noqa: E402

# H100 SXM, NVIDIA's data sheet (see PERF.md): HBM rate, fp32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SETH = {"groups": {"seth": {"core": 4, "mem": 1024}}, "nodes": {"seth": 120}}
RICC = {"groups": {"ricc": {"core": 8, "mem": 12288}},
        "nodes": {"ricc": 1024}}
SETH_JOBS = 10_000
RICC_JOBS = 5_000
RICC_MAX_EVENTS = 150

# kernel -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "alloc_score_batch": ("src/repro_torch/kernels/csrc/alloc_score.cu",
                          "src/repro/kernels/alloc_score.py:108"),
    "alloc_score": ("src/repro_torch/kernels/csrc/alloc_score.cu",
                    "src/repro/kernels/alloc_score.py:49"),
    "ebf_shadow": ("src/repro_torch/kernels/csrc/ebf_shadow.cu",
                   "src/repro/kernels/ebf_shadow.py:60"),
}
# device-side function names, as the profiler reports them
DEVICE_NAMES = {"alloc_score_batch_kernel", "ebf_shadow_kernel"}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def seth_jobs(job_cls, n, seed=0):
    """Poisson arrivals with a daily cycle; Seth-plausible job mix (the
    generator of the reference's ``benchmarks/common.py``)."""
    rng = random.Random(seed)
    t = 0
    for i in range(n):
        hour = (t // 3600) % 24
        rate = 55.0 if 8 <= hour <= 18 else 240.0
        t += int(rng.expovariate(1.0 / rate)) + 1
        procs = rng.choice([1, 1, 1, 1, 2, 2, 4, 4, 8, 16, 32])
        nodes = max(1, procs // 4)
        dur = int(rng.lognormvariate(7.2, 1.5)) + 1
        dur = min(dur, 3 * 86400)
        yield job_cls(
            id=str(i), user_id=rng.randint(1, 50), submission_time=t,
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 4.0)) + 60,
                                  4 * 86400),
            requested_nodes=nodes,
            requested_resources={"core": min(procs, 4),
                                 "mem": rng.choice([128, 256, 512, 1024])})


def ricc_jobs(job_cls, n, seed=1):
    """``n`` jobs submitted in per-minute batches over the first hour,
    1-32 nodes each, 10 min to 4 h, asking per core for half or all of a
    node's per-core memory share (1.5 GB)."""
    rng = random.Random(seed)
    subs = sorted(60 * rng.randrange(60) for _ in range(n))
    for i, t in enumerate(subs):
        dur = rng.randint(600, 4 * 3600)
        cores = rng.choice([1, 2, 4, 8, 8, 8])
        yield job_cls(
            id=str(i), user_id=rng.randint(1, 200), submission_time=t,
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 2.0)) + 300,
                                  6 * 3600),
            requested_nodes=rng.randint(1, 32),
            requested_resources={"core": cores,
                                 "mem": cores * rng.choice([768, 1536])})


# ----------------------------------------------------------------------
# instrumentation
# ----------------------------------------------------------------------
class Tap:
    """Observes the port's ``ops`` wrappers: per kernel, the peak size
    (J, M) of the current row and the largest inputs of each phase, for
    the kernel checks.  It keeps references, not copies (the inputs are
    cast to int32 only when the checks run), so it adds a size compare
    per call to the timed rows.  It launches nothing itself."""

    SIZE = {"alloc_score": lambda a: a[0].shape[0],
            "alloc_score_batch": lambda a: a[2].shape[0],
            "ebf_shadow_fits": lambda a: a[1].shape[0]}

    def __init__(self, ops) -> None:
        self.ops = ops
        self.orig = {name: getattr(ops, name) for name in self.SIZE}
        self.peak = {}
        self.inputs = {}          # (phase, name) -> (size, inputs)
        self.phase = None
        for name in self.SIZE:
            setattr(ops, name, self._wrap(name))

    def _wrap(self, name):
        orig, size = self.orig[name], self.SIZE[name]

        def observed(*args):
            s = size(args)
            self.peak[name] = max(self.peak.get(name, 0), s)
            key = (self.phase, name)
            if s > self.inputs.get(key, (-1,))[0]:
                self.inputs[key] = (s, args[:3])
            return orig(*args)
        return observed

    def close(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


class Recorder(SchedulerBase):
    """Wraps a planner; keeps per event (time, trace) and the launches and
    greedy probes the plan cost."""

    def __init__(self, inner) -> None:
        super().__init__(inner.allocator)
        self.inner = inner
        self.name = inner.name
        self.traces, self.launches, self.trips = [], [], []

    def plan(self, ctx):
        l0 = counters.launch_count()
        plan = self.inner.plan(ctx)
        self.launches.append(counters.launch_count() - l0)
        self.trips.append(plan.stats["phase_counters"]["dispatch_trips"])
        self.traces.append((ctx.now, plan.trace()))
        return plan


def device_time_us(prof):
    """(our kernels' device time, all device time) of a profile, in us."""
    ours = total = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        total += t
        if any(k in ev.key for k in DEVICE_NAMES):
            ours += t
    return ours, total


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def run_pair(tap, system, jobs, label, vx_sched, np_sched, kind,
             max_events=None, profile=False):
    """Run ``vx_sched`` (CUDA) and its numpy twin on the same workload and
    hold their per-event traces equal; returns the row's numbers.  Both
    timed runs go without the profiler.  With ``profile`` the CUDA row is
    run a second time under ``torch.profiler`` for its device time, and
    that run's traces are held equal too."""
    runs = [("cuda", vx_sched, False), ("numpy", np_sched, False)]
    if profile:
        runs.append(("cuda_profiled", vx_sched, True))
    rows = {}
    for engine, sched, traced in runs:
        rec = Recorder(sched)
        tap.peak = {}
        with tempfile.TemporaryDirectory() as td:
            sim = Simulator(jobs(Job), system, rec, output_dir=td,
                            name=label)
            with (torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                  if traced else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                sim.start_simulation(write_output=False,
                                     max_events=max_events)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        rows[engine] = (rec, sim.summary, wall, dict(tap.peak), prof)
    rec, summ, wall, peak, _ = rows["cuda"]
    twin, twin_summ, twin_wall, _, _ = rows["numpy"]
    for engine in rows:
        got = rows[engine][0].traces
        if got != twin.traces:
            first = next(i for i, (a, b) in enumerate(zip(got, twin.traces))
                         if a != b) if len(got) == len(twin.traces) \
                else min(len(got), len(twin.traces))
            raise AssertionError(f"{label} ({engine}): per-event traces "
                                 f"diverge from the numpy twin at dispatch "
                                 f"event {first}")
    for k in ("events", "submitted", "completed", "rejected",
              "sim_end_time"):
        if summ[k] != twin_summ[k]:
            raise AssertionError(f"{label}: summary {k} {summ[k]} != "
                                 f"{twin_summ[k]}")
    lp = np.asarray(rec.launches)
    if kind == "batched" and not np.all(lp == 1):
        raise AssertionError(f"{label}: launches per event {set(lp)} != 1")
    if kind == "ebf" and not (np.all(lp >= 1) and np.all(lp <= 3)):
        raise AssertionError(f"{label}: launches per event outside [1, 3]")
    if kind == "per_job" and not np.array_equal(lp, rec.trips):
        raise AssertionError(f"{label}: per-job launches != probes")
    out = {"row": label, "events": summ["events"],
           "dispatch_events": len(rec.traces),
           "starts": sum(len(t) for _, t in rec.traces),
           "wall_s": wall, "events_per_s": summ["events"] / wall,
           "dispatch_s_per_event": summ["dispatch_time_s"] / summ["events"],
           "launches_per_event": summ["kernel_launches_per_event"],
           "max_launches_in_an_event": int(lp.max()),
           "peak_J": peak.get("alloc_score_batch"),
           "peak_M": peak.get("ebf_shadow_fits"),
           "twin_wall_s": twin_wall,
           "twin_events_per_s": twin_summ["events"] / twin_wall,
           "traces_equal": True}
    if profile:
        # the profiled run does the same device work; its shares are of
        # the unprofiled wall, and its own wall shows the profiler's cost
        _, _, prof_wall, _, prof = rows["cuda_profiled"]
        ours, total = device_time_us(prof)
        out["kernel_share_of_wall"] = ours * 1e-6 / wall
        out["device_busy_share"] = total * 1e-6 / wall
        out["profiled_wall_s"] = prof_wall
    return out


def check_and_time(name, fn, plain, cases, timed):
    """Hold the kernel ``fn`` against ``plain`` on every case (CUDA
    tensors), then time both on the ``timed`` case."""
    err = 0.0
    for args in cases:
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} != "
                                     f"{w.shape}/{w.dtype}")
            if g.dtype == torch.float32:
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"{name}: score not bitwise equal")
            elif not torch.equal(g, w):
                raise AssertionError(f"{name}: integer output differs")
            if g.numel():
                err = max(err, float((g.double() - w.double()).abs().max()))
    return err, time_ms(lambda: fn(*timed)), time_ms(lambda: plain(*timed))


def device_ms(fn, reps=20):
    """Device time per call from the profiler: (our kernels' time, all
    device time).  Unlike ``time_ms`` it excludes the host's enqueue
    cost, which bounds back-to-back calls of a small kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ours, total = device_time_us(prof)
    return ours * 1e-3 / reps, total * 1e-3 / reps


def time_ms(fn, reps=20, rounds=7):
    """Median over rounds of CUDA-event time per call, warm."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def bound(name, shapes):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and fp32-rate
    operations / peak, for one call at these shapes (int32 and float32
    are 4 bytes; inputs read once, outputs written once)."""
    if name == "ebf_shadow":
        m, n, r = shapes
        nbytes = 4 * (n * r + m * n * r + r + m)
        ops = 2 * m * n * r                       # add + compare
    else:
        j, n, r = shapes
        nbytes = 4 * (j * r + 2 * n * r + 2 * j * n)
        ops = 2 * j * n * r + 5 * n * r           # compares; score once
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def floored_cases(rng, dev, n, r, j, m):
    """Ragged N and -1-floored rows (ineligible nodes), J = 1 included."""
    cap = rng.integers(1, 16, (n, r)).astype(np.int32)
    avail = rng.integers(0, 16, (n, r)).clip(0, cap).astype(np.int32)
    down = rng.choice(n, size=max(1, n // 10), replace=False)
    avail[down] = -1
    req = rng.integers(0, 6, (j, r)).astype(np.int32)
    req[:, 0] = 0                       # floored rows must not fit anyway
    deltas = rng.integers(0, 3, (m, n, r)).astype(np.int32)
    deltas[:, down, :] = 0              # releases there are filtered
    t = [torch.from_numpy(x).to(dev) for x in (avail, cap, req, deltas)]
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run(torch.device("cuda"))


def run(dev) -> int:
    """All phases on ``dev``; raises on any failure."""
    t_start = time.perf_counter()

    # ---- 1. card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log({"phase": "card", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": smi, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    built = build.build_all()
    for name, (secs, text) in built.items():
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log({"phase": "build", "source": name, "nvcc_s": secs,
             "ptxas": ptxas})
    log({"phase": "build", "total_s": time.perf_counter() - t0})

    # ---- 2./3. main path ---------------------------------------------
    tap = Tap(ops)
    cuda_alloc = lambda pol, **kw: VectorizedAllocator(pol, device=dev, **kw)
    numpy_alloc = {"FF": FirstFit, "BF": BestFit}
    simple = {"FIFO": FirstInFirstOut, "SJF": ShortestJobFirst,
              "LJF": LongestJobFirst}
    seth = lambda job: seth_jobs(job, SETH_JOBS)
    ricc = lambda job: ricc_jobs(job, RICC_JOBS)

    counters.reset_device_launches()
    tap.phase = "seth"
    for sched in ("FIFO", "SJF", "LJF", "EBF"):
        for pol in ("FF", "BF"):
            if sched == "EBF":
                vx = VectorizedEasyBackfilling(cuda_alloc(pol))
                tw = EasyBackfilling(numpy_alloc[pol]())
            else:
                vx = simple[sched](cuda_alloc(pol))
                tw = simple[sched](numpy_alloc[pol]())
            log({"phase": "seth", **run_pair(
                tap, SETH, seth, f"{vx.dispatcher_name}", vx, tw,
                "ebf" if sched == "EBF" else "batched")})
    log({"phase": "seth", **run_pair(
        tap, SETH, seth, "FIFO-vFF-per-job",
        FirstInFirstOut(cuda_alloc("FF", batched=False)),
        FirstInFirstOut(FirstFit()), "per_job")})
    seth_launches = counters.device_launch_stats()
    log({"phase": "seth", "cuda_launches": seth_launches})
    missing = set(KERNELS) - set(seth_launches)
    if missing:
        raise AssertionError(f"seth: no CUDA launch of {sorted(missing)}")

    tap.phase = "ricc"
    for label, vx, tw, kind in (
            ("vEBF-vBF", VectorizedEasyBackfilling(cuda_alloc("BF")),
             EasyBackfilling(BestFit()), "ebf"),
            ("FIFO-vBF", FirstInFirstOut(cuda_alloc("BF")),
             FirstInFirstOut(BestFit()), "batched"),
            ("FIFO-vFF-per-job",
             FirstInFirstOut(cuda_alloc("FF", batched=False)),
             FirstInFirstOut(FirstFit()), "per_job")):
        log({"phase": "ricc", **run_pair(
            tap, RICC, ricc, label, vx, tw, kind,
            max_events=RICC_MAX_EVENTS, profile=True)})
    launches = counters.device_launch_stats()
    tap.close()
    log({"phase": "main_path", "cuda_launches": launches,
         "ricc_cuda_launches": {k: v - seth_launches.get(k, 0)
                                for k, v in launches.items()}})
    missing = set(KERNELS) - set(launches)
    if missing:
        raise AssertionError(f"main path: no CUDA launch of "
                             f"{sorted(missing)}")

    # ---- 4. kernels against their plain versions ---------------------
    rng = np.random.default_rng(0)
    put = lambda xs: tuple(
        torch.from_numpy(np.array(x, dtype=np.int32)).to(dev) for x in xs)
    table = []

    def main_inputs(name):
        return [put(tap.inputs[(ph, name)][1]) for ph in ("seth", "ricc")
                if (ph, name) in tap.inputs]

    # alloc_score_batch: (avail, capacity, req[J, R])
    seen = main_inputs("alloc_score_batch")
    timed = max(seen, key=lambda x: x[2].shape[0])
    cases = list(seen)
    for n, j in ((1000, 1), (129, 37), (1024, 4097)):
        a, c, q, _ = floored_cases(rng, dev, n, 2, j, 1)
        cases.append((a, c, q))
    specs = [("alloc_score_batch", k_alloc.alloc_score_batch,
              ref.alloc_score_batch_ref, cases, timed,
              (timed[2].shape[0],) + tuple(timed[0].shape))]
    # alloc_score: (avail, capacity, req[R])
    seen = main_inputs("alloc_score")
    timed = max(seen, key=lambda x: x[0].shape[0])
    cases = list(seen)
    for n in (1000, 129, 1):
        a, c, q, _ = floored_cases(rng, dev, n, 2, 1, 1)
        cases.append((a, c, q[0]))
    specs.append(("alloc_score", k_alloc.alloc_score, ref.alloc_score_ref,
                  cases, timed, (1,) + tuple(timed[0].shape)))
    # ebf_shadow: (avail, deltas[M, N, R], req[R])
    seen = main_inputs("ebf_shadow_fits")
    timed = max(seen, key=lambda x: x[1].shape[0])
    cases = list(seen)
    for n, m in ((1000, 3), (129, 64), (1024, 1001)):
        a, _, q, d = floored_cases(rng, dev, n, 2, 1, m)
        cases.append((a, d, q[0]))
    specs.append(("ebf_shadow", k_ebf.ebf_shadow, ref.ebf_shadow_ref,
                  cases, timed, tuple(timed[1].shape)))

    for name, fn, plain, cases, timed, shapes in specs:
        err, ms, plain_ms = check_and_time(name, fn, plain, cases, timed)
        b_ms, b_by = bound(name, shapes)
        src, replaces = KERNELS[name]
        log({"phase": "kernel", "name": name, "cases": len(cases),
             "timed_shape": list(shapes), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms,
             "device_ms": device_ms(lambda: fn(*timed))[0],
             "plain_device_ms": device_ms(lambda: plain(*timed))[1]})
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None})

    log({"phase": "done", "total_s": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
