"""The readers of the dry-run records against the reference's, on the CPU.

* ``roofline.ideal_bytes_per_dev`` equals the reference's for every arch
  × applicable shape × mesh (single, multi) at full size, under the
  ``baseline`` and ``zero3`` rules (exact).
* ``python -m repro_torch.launch.dryrun --smoke --mesh single`` prints
  the reference's lines and writes records of its fields for a train and
  a decode cell.
* On those records (plus a failed one), the port's ``roofline.run``
  writes the reference's ``roofline.md`` and ``roofline_stats.json``
  byte for byte and emits its CSV lines, with the reference's constants
  set to the port's H100 ones inside the test.
* ``examples_torch/cluster_sim.py`` prints the reference example's JSON
  on the same records (each example in a subprocess, its working
  directory a temporary one holding ``results/dryrun``).
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import roofline as jroof  # noqa: E402
from repro.configs import applicable_shapes, get_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402

from benchmarks_torch import roofline  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ideal_bytes_equal_reference(arch):
    for shape in applicable_shapes(get_config(arch)):
        for mesh_kind in ("single", "multi"):
            for rules in ("baseline", "zero3"):
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "rules": rules, "rules_base": rules}
                assert roofline.ideal_bytes_per_dev(rec) == \
                    jroof.ideal_bytes_per_dev(rec), (shape, mesh_kind, rules)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's dry-run records of a train and a decode cell, written
    by its CLI under ``<tmp>/results/dryrun``, and its stdout."""
    root = tmp_path_factory.mktemp("dryrun")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "train_4k,decode_32k", "--mesh",
         "single", "--smoke"], cwd=root, env=ENV, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return root, out.stdout


def test_dryrun_cli_prints_the_reference_lines(records):
    root, stdout = records
    lines = stdout.strip().splitlines()
    pat = (r"\[ok\]   smollm-360m__{}__single__baseline: compile=[\d.]+s "
           r"mem/dev=[\d.]+GiB dominant=(compute|memory|collective) "
           r"bound=\d+\.\d{{4}}s useful=\d+\.\d\d")
    assert re.fullmatch(pat.format("train_4k"), lines[0]), lines[0]
    assert re.fullmatch(pat.format("decode_32k"), lines[1]), lines[1]
    assert lines[2] == "done: ok=2 fail=0 skip=0"
    keys = {"arch", "shape", "mesh", "chips", "rules", "rules_base", "ok",
            "knobs", "microbatches", "lower_s", "compile_s", "memory",
            "cost_analysis_raw", "hlo", "roofline", "total_s"}
    for path in (root / "results" / "dryrun").glob("*.json"):
        rec = json.loads(path.read_text())
        assert set(rec) == keys and rec["chips"] == 256, path.name
        assert set(rec["memory"]) == {
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "per_device_bytes", "per_device_gib", "fits_16gib_hbm"}


def test_roofline_report_equals_reference(records, tmp_path, monkeypatch,
                                          capsys):
    root, _ = records
    src = root / "results" / "dryrun"
    recs = tmp_path / "recs"
    recs.mkdir()
    for p in src.glob("*.json"):
        (recs / p.name).write_text(p.read_text())
    (recs / "granite-34b__train_4k__multi__baseline.json").write_text(
        json.dumps({"arch": "granite-34b", "shape": "train_4k",
                    "mesh": "multi", "rules": "baseline", "ok": False,
                    "error": "RuntimeError: placement refused"}))
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jmesh, "HBM_BW", mesh.HBM_BW)
    for mod in (roofline, jroof):
        mod._IDEAL_CACHE.clear()
    jstats = jroof.run(str(tmp_path / "ref"), str(recs))
    jout = capsys.readouterr().out
    stats = roofline.run(str(tmp_path / "port"), str(recs))
    out = capsys.readouterr().out
    assert stats == jstats and out == jout and stats["cells"] == 3
    for name in ("roofline.md", "roofline_stats.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_benchmarks_run_lists_roofline():
    from benchmarks_torch import run
    assert "roofline" in run.MODULES


def test_cluster_sim_prints_the_reference_json(records):
    root, _ = records
    outs = []
    for script in (ROOT / "examples" / "cluster_sim.py",
                   ROOT / "examples_torch" / "cluster_sim.py"):
        out = subprocess.run([sys.executable, str(script)], cwd=root,
                             env=ENV, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(out.stdout)
    assert outs[0] == outs[1]
    assert outs[1].startswith("loaded 2 job profiles from the dry-run\n")
    assert json.loads(outs[1].split("\n", 1)[1])["jobs"] == 60
