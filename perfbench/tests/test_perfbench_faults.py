"""Each fault the cells can have, planted under a run's timed path on
the CPU (the port's plain version, a small grid, the card's look
skipped), makes ``correct`` come out false.  The cells run on one chip,
so no exchange between chips can be left out.

    python -m pytest -q perfbench/tests
"""
import importlib.util
import time

import pytest

from perfbench import harness
from repro_torch.fleet import runner as rmod
from repro_torch.fleet.state import SimState

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(rmod, "advance", lambda batch, *a, **k: batch)


def _half_left_out(monkeypatch):
    advance = rmod.advance

    def half(batch, *a, **k):
        h = batch.submit.shape[0] // 2
        advance(SimState(*(t[:h] for t in batch)), *a, **k)
        return batch
    monkeypatch.setattr(rmod, "advance", half)


def _answer_altered(monkeypatch):
    unstack = rmod.unstack

    def altered(batch):
        finals = unstack(batch)
        for f in finals:
            f.start[0] += 1
        return finals
    monkeypatch.setattr(rmod, "unstack", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_faults", harness.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    res, _ = run.run(harness.resolve(cell), 3, 0.05, False, "cpu",
                     time.perf_counter(),
                     entry_args={"jobs": 24, "seeds": 2},
                     entry_hook=lambda ent: fault(monkeypatch))
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_is_correct(cell):
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_sound", harness.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    res, _ = run.run(harness.resolve(cell), 3, 0.05, False, "cpu",
                     time.perf_counter(),
                     entry_args={"jobs": 24, "seeds": 2})
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference with EASY's reservation broken, in the program's
    place under a run, fails the run's check (``perfbench/control.py``
    at a small size, on seeds whose job sample holds an EBF sim whose
    first 800 jobs queue up enough for the broken reservation to show;
    at the cell's size every seed shows it)."""
    from perfbench import control

    for seed in (10, 23):
        res = control.control_run(harness.resolve(cell), seed, 0.05, "cpu",
                                  entry_args={"jobs": 800, "seeds": 2})
        assert res["correct"] is False
        assert res["compared"]["job_mismatch"]["value"] > 0
        assert res["failed"] >= 1
