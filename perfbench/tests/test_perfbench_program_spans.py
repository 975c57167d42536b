"""The readers of the program's own spans and counters
(``repro_torch.telemetry.spans``): None where the recorder holds nothing
(or the program has no recorder), the right number from known totals,
and a traced run's line carrying them where the untraced one does not.

    python -m pytest -q perfbench/tests
"""
import importlib.util
import sys
import time

import pytest
import torch

from perfbench import harness
from repro_torch.telemetry import spans

CELL = "seth.grid"
# metric -> what it reads from these totals
TOTALS = {"fleet.pad": {"count": 4, "seconds": 0.2, "bytes": 0},
          "fleet.h2d": {"count": 204, "seconds": 0.04, "bytes": 80_000_000},
          "fleet.d2h": {"count": 204, "seconds": 0.03, "bytes": 80_000_000},
          "results.rss": {"count": 256, "seconds": 0.006, "bytes": 0},
          "fleet.build": {"count": 16, "seconds": 2.5, "bytes": 0},
          "kernels.build": {"count": 2, "seconds": 0.01, "bytes": 0},
          "kernels.load": {"count": 1, "seconds": 0.05, "bytes": 0}}
WANT = {"runner.pad_ms": 100.0, "runner.h2d_ms": 20.0,
        "runner.h2d_gbps": 2.0, "runner.d2h_ms": 15.0,
        "results.rss_ms": 3.0, "setup.fleet_build_s": 2.5,
        "setup.kernels_s": 0.06}
PROGRAM = sorted(WANT)


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_spans", harness.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def test_the_new_metrics_are_declared():
    names = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name in PROGRAM:
        assert names[name]["source"] == "program_span"
        assert names[name]["moves"] == (
            "setup_s" if name.startswith("setup.") else "grid_events_per_s")


@pytest.mark.parametrize("metric", PROGRAM)
def test_a_reader_finds_nothing_in_an_empty_record(metric, clean,
                                                   monkeypatch):
    cell = harness.resolve(CELL)
    reader = cell.reader(metric)
    assert reader.read(harness.RunRecord(requests=2)) is None
    # a program without the recorder (an older checkout)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch.telemetry"], "spans")
    assert reader.read(harness.RunRecord(requests=2)) is None


@pytest.mark.parametrize("metric", PROGRAM)
def test_a_reader_reads_known_totals(metric, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: TOTALS)
    reader = harness.resolve(CELL).reader(metric)
    assert reader.read(harness.RunRecord(requests=2)) == \
        pytest.approx(WANT[metric])


def test_a_traced_run_reports_them_and_an_untraced_one_does_not(clean):
    run = _run_module()
    cell = harness.resolve(CELL)
    args = {"jobs": 24, "seeds": 2}
    plain, _ = run.run(cell, 2**31 + 5, 0.05, False, "cpu",
                       time.perf_counter(), entry_args=args)
    assert plain["correct"] is True
    assert not set(plain["metrics"]) & set(PROGRAM)
    spans.reset()
    traced, _ = run.run(cell, 2**31 + 5, 0.05, True, "cpu",
                        time.perf_counter(), entry_args=args)
    assert traced["correct"] is True
    got = traced["metrics"]
    # no kernel library loads on the CPU: setup.kernels_s is the card's
    assert set(got) >= set(PROGRAM) - {"setup.kernels_s"}
    assert "setup.kernels_s" not in got
    assert all(got[m]["value"] > 0 for m in PROGRAM if m in got)
    # the warm grid in set-up ran untraced: only the window's grids count
    tot = spans.totals()
    assert tot["fleet.run"]["count"] == traced["attempted"]
    assert tot["fleet.build"]["count"] == args["seeds"]


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reports_all_seven(clean):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    run = _run_module()
    res, _ = run.run(harness.resolve(CELL), 2**31 + 5, 1.0, True, "cuda",
                     time.perf_counter(),
                     entry_args={"jobs": 200, "seeds": 2})
    assert res["correct"] is True
    assert set(res["metrics"]) >= set(PROGRAM)
