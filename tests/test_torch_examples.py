"""The port's examples against the reference's, on the CPU.

Each ``examples_torch`` script runs in a temporary directory (each
writes under ``./results``) with ``--device cpu`` where it takes one,
and so does the reference example of the same name; their printed JSON
must carry the same keys and agree on every simulated outcome:

* ``quickstart``: the whole summary but its timings, whole;
* ``dispatcher_comparison``: makespans and kernel launches per event of
  every row, at 300 jobs, with and without ``--vectorized``;
* ``heterogeneous_eurora``: ``make_jobs()`` equal job by job at its full
  size, then both ``main``s with ``make_jobs`` cut to 300 jobs, every
  printed field equal (slowdowns, makespan, power, ``deferred``).
"""
import importlib.util
import json
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMED = ("cpu_time_s", "wall_time_s", "dispatch_time_s", "mem_avg_mb",
         "mem_max_mb")


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv, cwd, monkeypatch, capsys):
    """Run ``mod.main()`` with ``argv`` in ``cwd``; its standard output."""
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def test_quickstart_matches_reference(tmp_path, monkeypatch, capsys):
    out = {}
    for folder in ("examples", "examples_torch"):
        text = _main(_load(folder, "quickstart"), [], tmp_path / folder,
                     monkeypatch, capsys)
        head, plot = text.split("slowdown plot:")
        out[folder] = json.loads(head.removeprefix("summary:"))
        assert os.path.getsize(plot.strip()) > 0
    got, want = out["examples_torch"], out["examples"]
    assert list(got) == list(want)
    for key in want:
        if key in TIMED:
            assert type(got[key]) is type(want[key]), key
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["numpy_rows", "with_vectorized_rows"])
def test_dispatcher_comparison_matches_reference(tmp_path, monkeypatch,
                                                 capsys, vectorized):
    flags = ["--vectorized"] if vectorized else []
    out = {}
    for folder, extra in (("examples", []),
                          ("examples_torch", ["--device", "cpu"])):
        text = _main(_load(folder, "dispatcher_comparison"),
                     ["300"] + flags + extra, tmp_path / folder, monkeypatch,
                     capsys)
        *table, last = text.strip().splitlines()
        assert last == "plots under results/dispatcher_comparison/"
        out[folder] = json.loads("\n".join(table))
    got, want = out["examples_torch"], out["examples"]
    assert list(got) == list(want)
    assert len(want) == (11 if vectorized else 8)
    for name in want:
        assert list(got[name]) == list(want[name])
        for key in ("makespan", "kernel_launches_per_event"):
            assert got[name][key] == want[name][key], (name, key)
    if vectorized:
        for v, twin in (("FIFO-vFF", "FIFO-FF"), ("FIFO-vBF", "FIFO-BF"),
                        ("vEBF-vFF", "EBF-FF")):
            assert got[v]["makespan"] == got[twin]["makespan"]


def test_heterogeneous_eurora_matches_reference(tmp_path, monkeypatch,
                                                capsys):
    mods = {f: _load(f, "heterogeneous_eurora")
            for f in ("examples", "examples_torch")}
    fields = ("id", "user_id", "submission_time", "duration",
              "expected_duration", "requested_nodes", "requested_resources")
    jobs = {f: [tuple(getattr(j, k) for k in fields) for j in m.make_jobs()]
            for f, m in mods.items()}
    assert len(jobs["examples"]) == 2500
    assert jobs["examples_torch"] == jobs["examples"]
    assert mods["examples_torch"].EURORA == mods["examples"].EURORA
    assert mods["examples_torch"].WATTS == mods["examples"].WATTS

    out = {}
    for folder, mod in mods.items():
        full = mod.make_jobs
        monkeypatch.setattr(mod, "make_jobs", lambda full=full: full(n=300))
        *rows, last = _main(mod, [], tmp_path / folder, monkeypatch,
                            capsys).strip().splitlines()
        assert last.startswith("utilization heatmap:")
        assert os.path.getsize(last.split(":", 1)[1].strip()) > 0
        out[folder] = json.loads("\n".join(rows))
    assert list(out["examples_torch"]) == list(out["examples"])
    assert out["examples_torch"] == out["examples"]
