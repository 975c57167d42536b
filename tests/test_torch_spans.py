"""The port's spans and counters (``repro_torch.telemetry.spans``) on the
fleet path, and the per-launch device time in ``FleetResult.launches``.

A small mixed-policy grid runs through ``FleetRunner(device="cpu")`` (two
launches: blocking and EBF).  Off, nothing but the set-up spans records
and no profiler range opens; on under ``torch.profiler``, every fleet
span nests in its grid and appears in the profiler's trace as often as
in the records, the copy counters count the stacked batch's bytes, and
the summary counters count the summaries; ``enable()`` records without a
profiler; results are the same on and off.  On the card,
``device_time_s`` agrees with CUDA events around ``advance``::

    python -m pytest -q -m cuda tests/test_torch_spans.py
"""
from collections import Counter
import types

import pytest
import torch

from repro_torch.core.job import JobFactory
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SCHED_SJF, FleetRunner)
from repro_torch.fleet import runner as rmod
from repro_torch.kernels import build
from repro_torch.telemetry import spans
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 4, "b": 2}}
WL = dict(mean_interarrival_s=25.0, duration_median_s=900.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})
POLICIES = [(SCHED_FIFO, ALLOC_FF), (SCHED_EBF, ALLOC_FF),
            (SCHED_SJF, ALLOC_BF), (SCHED_EBF, ALLOC_BF)]
FLEET = ("fleet.run", "fleet.launch", "fleet.pad", "fleet.stack",
         "fleet.unstack")
# summary fields that time or measure memory
TIMED = ("cpu_time_s", "wall_time_s", "dispatch_time_s", "mem_avg_mb",
         "mem_max_mb")


def _sims(n=40):
    return [FleetRunner.build(f"p{i}", SyntheticWorkload(n, seed=11 + i,
                                                         **WL),
                              SYS, sc, ac, job_factory=JobFactory())
            for i, (sc, ac) in enumerate(POLICIES)]


def _grid(sims, device="cpu"):
    """One grid and every sim's summary, as a user reads it."""
    res = FleetRunner(device=device).run(sims)
    return res, [res.summary(i) for i in range(len(sims))]


def _no_range(*a, **k):
    raise AssertionError("a profiler range opened")


@pytest.fixture
def clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def sims():
    return _sims()


def test_off_records_only_setup_spans(clean, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    sims = _sims()
    res, summ = _grid(sims)
    assert len(res.launches) == 2
    assert {r.name for r in spans.records()} == {"fleet.build"}
    assert set(spans.totals()) == {"fleet.build"}
    assert spans.totals()["fleet.build"]["count"] == len(sims)
    assert not spans.on() and not spans.span("fleet.run")


def test_on_under_the_profiler(clean, sims, monkeypatch):
    stacked = []
    stack = rmod.stack

    def stack_w(states, device):
        batch = stack(states, device)
        stacked.append(sum(t.nbytes for t in batch))
        return batch
    monkeypatch.setattr(rmod, "stack", stack_w)
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        assert spans.on()
        res, summ = _grid(sims)
        res.summary(0)
    recs = spans.records()
    by_id = {r.span_id: r for r in recs}
    names = Counter(r.name for r in recs)
    assert names == {"fleet.run": 1, "fleet.launch": 2, "fleet.pad": 2,
                     "fleet.stack": 2, "fleet.unstack": 2}
    # nested fleet.run > fleet.launch > {pad, stack, unstack}, one grid
    (run,) = [r for r in recs if r.name == "fleet.run"]
    assert run.parent is None and run.grid is not None
    assert run.attrs == {"n_sims": len(sims)}
    launches = [r for r in recs if r.name == "fleet.launch"]
    assert [r.attrs["cost_class"] for r in launches] == ["blocking", "ebf"]
    assert [r.attrs["n_sims"] for r in launches] == [2, 2]
    assert all(r.attrs["m"] == 64 and r.attrs["device_s"] is None
               for r in launches)
    for r in recs:
        assert r.grid == run.grid
        assert run.start_ns <= r.start_ns <= r.end_ns <= run.end_ns
        if r.name in ("fleet.pad", "fleet.stack", "fleet.unstack"):
            assert by_id[r.parent].name == "fleet.launch"
    assert all(r.parent == run.span_id for r in launches)
    # every span is a profiler range, as often as it is a record
    ranges = Counter(e.name for e in prof.events() if e.name in FLEET)
    assert ranges == names
    tot = spans.totals()
    # the copies' bytes: each stacked batch's, both ways, on any device
    assert len(stacked) == 2
    assert tot["fleet.h2d"]["bytes"] == tot["fleet.d2h"]["bytes"] == \
        sum(stacked)
    n_fields = len(sims[0].state)
    assert tot["fleet.h2d"]["count"] == tot["fleet.d2h"]["count"] == \
        2 * n_fields
    assert tot["results.summary"]["count"] == len(sims) + 1
    assert tot["results.rss"]["count"] == len(sims) + 1
    assert tot["results.summary"]["seconds"] >= \
        tot["results.rss"]["seconds"] > 0
    assert "fleet.kernel.wait" not in tot          # CUDA only
    assert tot["fleet.launch"]["seconds"] == pytest.approx(
        sum(r.seconds for r in launches))


def test_enable_and_disable_without_a_profiler(clean, sims, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    spans.enable()
    _grid(sims)
    first = Counter(r.name for r in spans.records())
    assert first["fleet.run"] == 1 and first["fleet.launch"] == 2
    assert spans.totals()["results.summary"]["count"] == len(sims)
    spans.disable()
    _grid(sims)
    assert Counter(r.name for r in spans.records()) == first
    spans.reset()
    assert spans.records() == [] and spans.totals() == {}


def test_setup_spans_record_while_off(clean, monkeypatch, tmp_path):
    FleetRunner.build("one", SyntheticWorkload(5, seed=3, **WL), SYS,
                      SCHED_FIFO, job_factory=JobFactory())
    # a library already built: no nvcc runs, the load is timed
    lib_file = tmp_path / "libfleet_engine.so"
    lib_file.write_bytes(b"")

    class Lib:
        def __getattr__(self, fn):
            obj = types.SimpleNamespace()
            setattr(self, fn, obj)
            return obj
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_target", lambda name: lib_file)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    assert build.build_all(["fleet_engine"]) == {}
    build.library("fleet_engine")
    build.library("fleet_engine")                  # loaded: no span
    recs = spans.records()
    assert [r.name for r in recs] == ["fleet.build", "kernels.build",
                                      "kernels.load"]
    assert recs[0].attrs == {"sim": "one"}
    assert recs[1].attrs == {"built": False}
    assert recs[2].attrs == {"library": "fleet_engine", "built": False}
    assert all(r.parent is None and r.end_ns >= r.start_ns for r in recs)


def test_results_are_the_same_on_and_off(clean, sims):
    off, off_summ = _grid(sims)
    spans.enable()
    on, on_summ = _grid(sims)
    assert spans.totals()["fleet.run"]["count"] == 1
    for i in range(len(sims)):
        assert on.trace(i) == off.trace(i)
        assert {k: v for k, v in on_summ[i].items() if k not in TIMED} == \
            {k: v for k, v in off_summ[i].items() if k not in TIMED}
    assert [{k: v for k, v in l.items() if "time" not in k}
            for l in on.launches] == \
        [{k: v for k, v in l.items() if "time" not in k}
         for l in off.launches]


def test_device_time_is_none_on_the_cpu(clean, sims):
    res, _ = _grid(sims)
    assert [l["device_time_s"] for l in res.launches] == [None, None]
    assert all(l["wall_time_s"] > 0 for l in res.launches)


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_time_matches_cuda_events_around_advance(cuda_dev, clean,
                                                        monkeypatch):
    """``device_time_s`` (events around the kernel alone) within 2 % of
    events around the whole ``advance`` call, on launches long enough
    that the host work between the two pairs is small."""
    sims = _sims(3000)
    FleetRunner().run(sims)                        # build and warm up
    around = []
    advance = rmod.advance

    def advance_w(batch, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = advance(batch, *a, **k)
        end.record()
        end.synchronize()
        around.append(start.elapsed_time(end) * 1e-3)
        return out
    monkeypatch.setattr(rmod, "advance", advance_w)
    res = FleetRunner().run(sims)
    got = [l["device_time_s"] for l in res.launches]
    assert len(got) == len(around) == 2
    for g, want in zip(got, around):
        assert 0 < g <= want * 1.0001
        assert g == pytest.approx(want, rel=0.02)
    spans.enable()
    traced = FleetRunner().run(sims)
    devs = [r.attrs["device_s"] for r in spans.records()
            if r.name == "fleet.launch"]
    assert devs == [l["device_time_s"] for l in traced.launches]
    assert spans.totals()["fleet.kernel.wait"]["count"] == 2
