"""The port's benchmark modes against the reference's, on the CPU.

Each ``benchmarks_torch`` mode runs with ``device="cpu"`` (the kernels'
and the fleet's plain PyTorch versions) beside the reference mode of the
same name, on the same inputs, with every module's ``REPO_ROOT`` pointed
at a temporary directory so that no ``BENCH_*.json`` lands in the tree.
Their results must be equal: the same keys at every level, the same
``emit`` names, and the same values but for the fields in ``TIMED``
(times and memory, the environment stamp and the device).  The fleet
modes run at 60 jobs a sim and the failure scale cell at 2,000 jobs
(module constants lowered here), since the reference compiles its fleet
with jax on the CPU.  ``bench_profile`` times both packages' fleet
launches on a counting clock: its 15 % telemetry gate compares two
timings, which CPU noise on a shared machine could decide either way;
the gate itself is exercised by a test that makes telemetry slower.
"""
import fnmatch
import importlib.util
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_core as ref_core  # noqa: E402
from benchmarks import bench_dispatch as ref_dispatch  # noqa: E402
from benchmarks import bench_failures as ref_failures  # noqa: E402
from benchmarks import bench_fleet as ref_fleet  # noqa: E402
from benchmarks import bench_kernels as ref_kernels  # noqa: E402
from benchmarks import bench_profile as ref_profile  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig_generator as ref_fig  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from benchmarks import table1_scalability as ref_table1  # noqa: E402
from benchmarks_torch import bench_core, bench_dispatch  # noqa: E402
from benchmarks_torch import bench_failures, bench_fleet  # noqa: E402
from benchmarks_torch import bench_kernels, bench_profile  # noqa: E402
from benchmarks_torch import common, fig_generator  # noqa: E402
from benchmarks_torch import run as port_run  # noqa: E402
from benchmarks_torch import table1_scalability as table1  # noqa: E402
from repro import fleet as ref_fleet_pkg  # noqa: E402
from repro.fleet import runner as ref_runner_mod  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import fleet as port_fleet_pkg  # noqa: E402
from repro_torch.fleet import runner as port_runner_mod  # noqa: E402
from repro_torch.kernels import alloc_score as k_alloc  # noqa: E402
from repro_torch.kernels import ebf_shadow as k_ebf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# fields that time, measure memory, stamp the environment or name the
# device: compared by type only
TIMED = ("*_us", "*_s", "events_per_s", "sims_per_s", "speedup*",
         "overhead_*", "mem_*", "peak_rss_mb", "env", "mode", "compile_*")
FLEET_JOBS = 60


def _timed(key):
    return any(fnmatch.fnmatchcase(key, p) for p in TIMED)


def assert_same(got, want, where="result"):
    """Equal keys at every level, equal values outside ``TIMED``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), \
            (where, list(got), list(want))
        for k in want:
            if _timed(k):
                assert type(got[k]) is type(want[k]), (f"{where}.{k}",
                                                       got[k], want[k])
            else:
                assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _names(text):
    """The ``emit`` names of a mode's standard output, in order."""
    return [ln.split(",")[0] for ln in text.strip().splitlines()]


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Every mode's ``REPO_ROOT`` in a temporary directory; fresh fleet
    compile caches in both packages, so ``cache_hit`` depends on this
    test alone."""
    for name, mods in (("ref", (ref_dispatch, ref_core, ref_fleet,
                                ref_failures, ref_profile)),
                       ("port", (bench_dispatch, bench_core, bench_fleet,
                                 bench_failures, bench_profile))):
        (tmp_path / name).mkdir()
        for mod in mods:
            monkeypatch.setattr(mod, "REPO_ROOT", str(tmp_path / name))
    monkeypatch.setattr(ref_fleet_pkg.FleetRunner, "_compile_cache", {})
    monkeypatch.setattr(port_fleet_pkg.FleetRunner, "_seen", set())
    return tmp_path


def _both(roots, capsys, json_name, call_ref, call_port):
    """Run the reference, then the port; their results, the JSON each
    wrote, and their emit names."""
    out = {}
    for name, call, fname in (("ref", call_ref, f"BENCH_{json_name}.json"),
                              ("port", call_port,
                               f"BENCH_torch_{json_name}.json")):
        capsys.readouterr()
        result = call(str(roots / name / "out"))
        text = capsys.readouterr().out
        with open(roots / name / fname) as fh:
            assert json.load(fh) == json.loads(json.dumps(result))
        out[name] = result, _names(text)
    return out["port"], out["ref"]


class CountingClock:
    """``time.time`` that moves one second a call: every fleet launch
    then takes the same wall on both packages."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 1.0
        return self.t


# ----------------------------------------------------------------------
# table1
# ----------------------------------------------------------------------
def test_table1_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "SCALE", 0.002)
    monkeypatch.setattr(ref_common, "SCALE", 0.002)
    out = {}
    for name, mod in (("ref", ref_table1), ("port", table1)):
        capsys.readouterr()
        rows = mod.run(str(tmp_path / name))
        with open(tmp_path / name / "table1.json") as fh:
            assert json.load(fh) == rows
        out[name] = rows, _names(capsys.readouterr().out)
    (got, got_names), (want, want_names) = out["port"], out["ref"]
    assert got_names == want_names
    assert list(got) == list(want)
    assert [r["jobs"] for r in want.values()] == [100, 220, 1000]
    for label in want:
        assert list(got[label]) == list(want[label])
        assert got[label]["jobs"] == want[label]["jobs"]


# ----------------------------------------------------------------------
# bench_dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["numpy", "per-job", "batched"])
def test_dispatch_engine_matches_reference(engine, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    want = ref_dispatch._run_engine(engine, 32, 96, str(tmp_path))
    got = bench_dispatch._run_engine(engine, 32, 96, str(tmp_path), "cpu")
    assert list(got) == list(want)
    for key in ("engine", "nodes", "jobs", "events", "kernel_launches",
                "kernel_launches_per_event", "completed", "sim_end_time"):
        assert got[key] == want[key], key
    assert_same(got, want)


def test_dispatch_quick_through_run_py(roots, monkeypatch, capsys):
    """``run.py --quick --device cpu``: the port's quick dispatch sweep,
    whose engines must agree on ``sim_end_time``; its JSON has the keys
    of the reference's committed ``BENCH_dispatch.json``."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--quick", "--device",
                                      "cpu"])
    capsys.readouterr()
    port_run.main()
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert _names("\n".join(lines[1:])) == [
        "dispatch/numpy/64x256", "dispatch/per-job/64x256",
        "dispatch/batched/64x256", "dispatch/speedup_batched_vs_per_job"]
    assert re.fullmatch(r"# dispatch quick: [0-9.]+x batched vs per-job on "
                        r"64x256\n", cap.err)
    with open(roots / "port" / "BENCH_torch_dispatch.json") as fh:
        got = json.load(fh)
    with open(ROOT / "BENCH_dispatch.json") as fh:
        want = json.load(fh)
    assert list(got) == list(want)
    assert list(got["cells"][0]) == list(want["cells"][0])
    assert got["mode"] == "cpu" and got["headline"] == "64x256"
    assert len({c["sim_end_time"] for c in got["cells"]}) == 1
    assert [c["engine"] for c in got["cells"]] == ["numpy", "per-job",
                                                   "batched"]


# ----------------------------------------------------------------------
# bench_core
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scenario,engine,max_events", [
    ("steady", "REJECT", None), ("steady", "FIFO-FF", None),
    ("contended", "FIFO-FF", 1000)])
def test_core_probe_matches_reference(scenario, engine, max_events,
                                      tmp_path):
    want = ref_core._probe(scenario, engine, 2000, str(tmp_path),
                           max_events=max_events)
    got = bench_core._probe(scenario, engine, 2000, str(tmp_path),
                            max_events=max_events)
    assert_same(got, want)
    if scenario == "contended":
        assert got["events"] == 1000 and got["final_queue"] > 100


def test_core_quick_has_no_baseline_fields(roots, capsys):
    result = bench_core.run(str(roots / "out"), quick=True)
    names = _names(capsys.readouterr().out)
    assert list(result) == ["benchmark", "sizes", "headline_cell", "cells",
                            "env"]
    assert "speedup_vs_baseline" not in result
    assert "baseline_events_per_s" not in result
    assert names == [f"core/{c['name']}" for c in result["cells"]] == [
        "core/contended/FIFO-FF/100000", "core/steady/REJECT/10000",
        "core/steady/FIFO-FF/10000"]
    with open(ROOT / "BENCH_core.json") as fh:
        want = json.load(fh)
    assert list(result["cells"][0]) == list(want["cells"][0])
    assert result["cells"][0]["events"] == bench_core.CONTENDED_EVENTS


# ----------------------------------------------------------------------
# the fleet modes
# ----------------------------------------------------------------------
def test_fleet_matches_reference(roots, monkeypatch, capsys):
    for mod in (ref_fleet, bench_fleet):
        monkeypatch.setattr(mod, "JOBS_QUICK", FLEET_JOBS)
    (got, got_names), (want, want_names) = _both(
        roots, capsys, "fleet",
        lambda out: ref_fleet.run(out, quick=True),
        lambda out: bench_fleet.run(out, quick=True, device="cpu"))
    assert got_names == want_names
    assert_same(got, want)
    assert got["n_sims"] == 4 and got["fleet_covered_fraction"] == 1.0
    assert [(l["cost_class"], l["n_sims"]) for l in got["fleet"]["launches"]
            ] == [("blocking", 2), ("ebf", 2)]


def test_failures_match_reference(roots, monkeypatch, capsys):
    for mod in (ref_failures, bench_failures):
        monkeypatch.setattr(mod, "SCALE_JOBS_QUICK", 2000)
        monkeypatch.setattr(mod, "GRID_JOBS_QUICK", FLEET_JOBS)
    (got, got_names), (want, want_names) = _both(
        roots, capsys, "failures",
        lambda out: ref_failures.run(out, quick=True),
        lambda out: bench_failures.run(out, quick=True, device="cpu"))
    assert got_names == want_names
    assert_same(got, want)
    assert got["scale_cell"]["failures"]["requeued_jobs"] > 0
    assert len(got["crosscheck"]["outcomes"]) == 2


def _profile_setup(monkeypatch):
    for mod in (ref_fleet, bench_fleet, ref_profile, bench_profile):
        monkeypatch.setattr(mod, "JOBS_QUICK", FLEET_JOBS)
    monkeypatch.setattr(ref_runner_mod, "time", CountingClock())
    monkeypatch.setattr(port_runner_mod, "time", CountingClock())


def test_profile_matches_reference(roots, monkeypatch, capsys):
    _profile_setup(monkeypatch)
    (got, got_names), (want, want_names) = _both(
        roots, capsys, "profile",
        lambda out: ref_profile.run(out, quick=True),
        lambda out: bench_profile.run(out, quick=True, device="cpu"))
    assert got_names == want_names
    assert_same(got, want)
    assert got["phase_attribution"]["EBF-BF"]["shadow_trips"] > 0
    for name in ("ref", "port"):
        with open(roots / name / "out" / "profile_report.txt") as fh:
            report = fh.read()
        assert "telemetry overhead: 0.0% (budget 15%) -> OK" in report
        with open(roots / name / "out" / "FIFO-FF-s29-telemetry.jsonl") as fh:
            assert fh.readline()


def test_profile_refuses_telemetry_over_budget(roots, monkeypatch, capsys):
    """Telemetry-on launches made twice as slow: both packages exit with
    the same refusal, after writing their JSON with ``overhead_ok``
    false."""
    _profile_setup(monkeypatch)
    msgs = {}
    for name, mod, kw in (("ref", ref_profile, {}),
                          ("port", bench_profile, {"device": "cpu"})):
        timed_run = mod._timed_run

        def slow_telemetry(runner, rows, n_seeds, n_jobs, stride,
                           timed_run=timed_run):
            res, tags, comp, wall, events = timed_run(runner, rows, n_seeds,
                                                      n_jobs, stride)
            return res, tags, comp, wall * (2 if stride else 1), events
        monkeypatch.setattr(mod, "_timed_run", slow_telemetry)
        with pytest.raises(SystemExit) as exc:
            mod.run(str(roots / name / "out"), quick=True, **kw)
        msgs[name] = str(exc.value.code)
        fname = "BENCH_profile.json" if name == "ref" else \
            "BENCH_torch_profile.json"
        with open(roots / name / fname) as fh:
            result = json.load(fh)
        assert result["overhead_fraction"] == 0.5
        assert result["overhead_ok"] is False
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"].startswith("telemetry overhead 50.0% exceeds the "
                                   "15% budget")


# ----------------------------------------------------------------------
# bench_kernels
# ----------------------------------------------------------------------
def _reference_draws(sizes):
    """The reference's ``rng`` calls, in its order (bench_kernels.run)."""
    rng = np.random.default_rng(0)
    out = []
    for n_nodes in sizes:
        r = 4
        cap = rng.integers(1, 8, (n_nodes, r)).astype(np.int32)
        avail = rng.integers(0, 8, (n_nodes, r)).clip(0, cap).astype(
            np.int32)
        req = rng.integers(0, 4, (r,)).astype(np.int32)
        m = 64
        deltas = rng.integers(0, 2, (m, n_nodes, r)).astype(np.int32)
        out.append((avail, cap, req, deltas))
    return out


def test_kernels_draw_the_reference_inputs():
    rng = np.random.default_rng(0)
    for want in _reference_draws(bench_kernels.SIZES):
        got = bench_kernels.draw(rng, want[0].shape[0])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("n_nodes", [256, 1024])
def test_kernels_alloc_score_equals_reference(n_nodes):
    avail, cap, req, _ = bench_kernels.draw(np.random.default_rng(n_nodes),
                                            n_nodes)
    bits, score = k_alloc.alloc_score(*(torch.from_numpy(x)
                                        for x in (avail, cap, req)))
    fit_want, score_want = jref.alloc_score_ref(
        jnp.asarray(avail), jnp.asarray(cap), jnp.asarray(req))
    assert np.array_equal(tref.unpack_bits(bits, n_nodes).numpy(),
                          np.asarray(fit_want))
    assert np.array_equal(score.numpy().view(np.int32),
                          np.asarray(score_want).view(np.int32))


@pytest.mark.parametrize("n_nodes", [256, 1024])
def test_kernels_sparse_ebf_shadow_equals_dense_reference(n_nodes):
    avail, _, req, deltas = bench_kernels.draw(
        np.random.default_rng(n_nodes), n_nodes)
    node_ptr, entry_m, entry_vec = bench_kernels.sparse_deltas(deltas)
    assert entry_m.shape[0] == int(deltas.any(axis=2).sum())
    fits = k_ebf.ebf_shadow(*(torch.from_numpy(x) for x in (
        avail, node_ptr, entry_m, entry_vec, req)), bench_kernels.M)
    want = jref.ebf_shadow_ref(jnp.asarray(avail), jnp.asarray(deltas),
                               jnp.asarray(req))
    assert fits.dtype == torch.int32
    assert np.array_equal(fits.numpy(), np.asarray(want))


def test_kernels_keys_match_reference(tmp_path, capsys):
    out = {}
    for name, call in (("ref", lambda d: ref_kernels.run(d)),
                       ("port", lambda d: bench_kernels.run(d, "cpu"))):
        capsys.readouterr()
        rows = call(str(tmp_path / name))
        with open(tmp_path / name / "bench_kernels.json") as fh:
            assert json.load(fh) == rows
        out[name] = rows, _names(capsys.readouterr().out)
    (got, got_names), (want, want_names) = out["port"], out["ref"]
    assert got_names == want_names
    assert_same(got, want)


# ----------------------------------------------------------------------
# fig_generator
# ----------------------------------------------------------------------
def test_fig_generator_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "SCALE", 0.05)
    monkeypatch.setattr(ref_common, "SCALE", 0.05)
    out = {}
    for name, mod in (("ref", ref_fig), ("port", fig_generator)):
        capsys.readouterr()
        res = mod.run(str(tmp_path / name))
        assert os.path.getsize(tmp_path / name / "fig_generator.png") > 0
        out[name] = res, _names(capsys.readouterr().out)
    (got, got_names), (want, want_names) = out["port"], out["ref"]
    assert got_names == want_names == ["fig_generator/gen"]
    assert list(got) == list(want)
    for key in ("hourly_corr", "daily_corr", "work_logmean_real",
                "work_logmean_gen", "work_logstd_real", "work_logstd_gen"):
        assert got[key] == want[key], key


# ----------------------------------------------------------------------
# run.py
# ----------------------------------------------------------------------
def _main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    capsys.readouterr()
    code = None
    try:
        mod.main()
    except SystemExit as exc:
        code = exc.code
    cap = capsys.readouterr()
    return code, cap.out, re.sub(r"[0-9.]+s$", "Ns", cap.err.strip(),
                                 flags=re.M)


def test_run_table1_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(common, "SCALE", 0.002)
    monkeypatch.setattr(ref_common, "SCALE", 0.002)
    out = {}
    for name, mod, extra in (("ref", ref_run, []),
                             ("port", port_run, ["--device", "cpu"])):
        out[name] = _main(mod, ["--only", "table1", "--out",
                                str(tmp_path / name)] + extra,
                          monkeypatch, capsys)
    (code, text, err), (ref_code, ref_text, ref_err) = out["port"], \
        out["ref"]
    assert code is None and ref_code is None
    assert _names(text) == _names(ref_text)
    assert text.splitlines()[0] == "name,us_per_call,derived"
    assert err == ref_err == "# table1 done in Ns"


def test_run_refuses_roofline(tmp_path, monkeypatch, capsys):
    """``roofline`` was refused until the dry-run was ported; it now runs
    as the reference's does (here on an empty ``results/dryrun``), and
    ``MODULES`` is the reference's."""
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, mod, extra in (("ref", ref_run, []),
                             ("port", port_run, ["--device", "cpu"])):
        out[name] = _main(mod, ["--only", "roofline", "--out",
                                str(tmp_path / name)] + extra,
                          monkeypatch, capsys)
    assert out["port"] == out["ref"] == (
        None, "name,us_per_call,derived\n", "# roofline done in Ns")
    assert port_run.MODULES == ref_run.MODULES


# ----------------------------------------------------------------------
# no fallback
# ----------------------------------------------------------------------
@pytest.mark.parametrize("call", [
    lambda out: bench_dispatch.run(out, quick=True),
    lambda out: bench_fleet.run(out, quick=True),
    lambda out: bench_failures.run(out, quick=True),
    lambda out: bench_profile.run(out, quick=True),
    lambda out: bench_kernels.run(out)],
    ids=["dispatch", "fleet", "failures", "profile", "kernels"])
def test_device_modes_raise_without_a_card(call, roots):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(str(roots / "out"))
    assert not list((roots / "port").glob("BENCH_*"))


# ----------------------------------------------------------------------
# examples: workload_generation
# ----------------------------------------------------------------------
def _load_example(folder):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_workload_generation",
        ROOT / folder / "workload_generation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_workload_generation_matches_reference(tmp_path, monkeypatch,
                                               capsys):
    out = {}
    for folder in ("examples", "examples_torch"):
        mod = _load_example(folder)
        (tmp_path / folder).mkdir()
        monkeypatch.chdir(tmp_path / folder)
        monkeypatch.setattr(sys, "argv", [mod.__file__, "300"])
        capsys.readouterr()
        mod.main()
        text = capsys.readouterr().out
        blocks = [json.loads(b) for b in
                  re.split(r"(?<=\})\n(?=\{)", text.strip())]
        out[folder] = blocks
        assert os.path.getsize(tmp_path / folder / "results" /
                               "workload_generation" / "new_workload.swf")
    got, want = out["examples_torch"], out["examples"]
    assert len(got) == len(want) == 2
    assert [list(b) for b in got] == [list(b) for b in want]
    assert "fleet" not in got[1]
    assert got[0] == want[0]
    for key in want[1]:
        if key != "mem_max_mb":
            assert got[1][key] == want[1][key], key
