"""The harness on the CPU: cells resolve to their files by name, a new
cell is data only, names and units keep to the contract, the result
line's keys, the import guard, and no run without a card.

    python -m pytest -q perfbench/tests
"""
import importlib.util
import json
import os
import re
import shutil
import time

import pytest
import torch

from perfbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "perfbench_run_under_test", harness.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.entry().Entry
    assert c.generator().generate
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]).read)
    cfg = next(x for x in SPEC["configs"] if x["name"] == c.config["name"])
    assert os.path.isfile(harness.ROOT / cfg["file"])
    assert set(cfg["reduced"]) <= set(c.config["reduced"])


def test_a_new_cell_is_found_from_data_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((root / "perfbench/configs/seth.json").read_text())
    cfg["name"] = "seth_small"
    cfg["jobs_per_sim"] = 30
    (root / "perfbench/configs/seth_small.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (root / "perfbench/traffic/seth_stream.json").read_text())
    traffic["params"]["day_gap_s"] = traffic["params"]["night_gap_s"] = 98
    (root / "perfbench/traffic/seth_flat.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/metrics/dummy.jobs.py").write_text(
        "def read(run):\n    return run.requests or None\n")
    spec["configs"].append({"name": "seth_small", "source": "x",
                            "file": "perfbench/configs/seth_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "seth.flat", "config": "seth_small",
                              "traffic": "seth_flat", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "dummy.jobs", "unit": "grids",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "grid_events_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("seth.flat", root=root)
    st = cell.generator().generate(cell.traffic, 1,
                                   cell.config["jobs_per_sim"])
    assert len(st) == 30 and st.submit[-1] > 0
    assert cell.config["name"] == "seth_small"
    assert "dummy.jobs" in [m["name"] for m in cell.per_layer]
    assert harness.read_metrics(cell, harness.RunRecord(requests=3),
                                cell.per_layer[-1:]) == {
        "dummy.jobs": {"value": 3, "unit": "grids"}}
    # a reader that finds nothing to read leaves its metric out
    assert harness.read_metrics(cell, harness.RunRecord(),
                                cell.per_layer[-1:]) == {}


def test_names_and_units_keep_to_the_contract():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"])
               for m in SPEC["end_to_end"] + SPEC["per_layer"])
    assert len(set(x["name"] for key in ("end_to_end", "per_layer")
                   for x in SPEC[key])) == len(SPEC["end_to_end"]) + len(
                       SPEC["per_layer"])
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_keys(trace):
    run = _run_module()
    cell = harness.resolve("seth.grid")
    res, forbidden = run.run(cell, 2**31 + 11, 0.05, trace, "cpu",
                             time.perf_counter(),
                             entry_args={"jobs": 12, "seeds": 1})
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["compared"]
    assert res["correct"] is True and forbidden == []
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"}
               for c in res["compared"].values())


def test_the_import_guard_compares_whole_top_level_names():
    mods = {"jax.numpy": 1, "repro.core": 1, "repro_torch.fleet": 1,
            "reprocess": 1, "flax": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jax", "repro"]
    assert harness.forbidden_modules({"repro_torch": 1, "jaxtyping": 1}) \
        == []


def test_no_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = _run_module()
    rc = run.main(["--workload", "seth.grid", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert "correct" not in out.out and "no run on the CPU" in out.err
