"""The Experiment layer of the port against the reference.

First the checks of the reference's ``test_experimentation.py`` (all but
``test_hlo_analyzer_known_costs``, whose analyzer is not ported)
restated against ``repro_torch`` with ``device="cpu"``: the fleet rows
run through the plain PyTorch version.  Then the port held against the
reference on the same inputs (Jobs built in each package from one
``random.Random`` seed, or each package's ``SyntheticWorkload`` with one
seed):

* ``summaries.json`` equal key for key, except the timing and memory
  fields (``TIMED``), which must be present with the same type;
* every ``-output.jsonl`` (and ``-telemetry.jsonl``) byte-equal;
* every ``-bench.jsonl`` equal in ``t``, ``queue``, ``running`` and
  ``kernel_launches`` line by line, and in its summary line less the
  timing fields;
* every ``metrics`` function equal on the same files (the mean dispatch
  seconds of ``dispatch_time_by_queue_size`` are timings: its buckets
  and counts must be equal).

Also: every plot kind writes its PNG; without matplotlib the layer
imports and runs, and only a plot raises; without a card the default
device raises on a fleet row.
"""
import json
import os
import random
import subprocess
import sys

import pytest
import torch

import repro.cluster.failures as ref_failures
import repro.core as ref_core
import repro.core.dispatchers as ref_disp
import repro.experimentation as ref_exp
from repro.workloads.synthetic import SyntheticWorkload as RefWorkload
from repro_torch.cluster import failures as port_failures
from repro_torch import core as port_core
from repro_torch.core import dispatchers as port_disp
from repro_torch import experimentation as port_exp
from repro_torch.experimentation import Experiment, PlotFactory, metrics
from repro_torch.experimentation.plot_factory import (
    DECISION_PLOTS, PERFORMANCE_PLOTS, TELEMETRY_PLOTS, utilization_heatmap)
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"compute": {"core": 4, "mem": 1024}}, "nodes": {"compute": 8}}
CPU = "cpu"
WL = dict(mean_interarrival_s=30.0, duration_median_s=400.0,
          resources={"core": (1, 4), "mem": (64, 512)})
# summary fields that are timings or memory readings of the run
TIMED = ("cpu_time_s", "wall_time_s", "dispatch_time_s", "mem_avg_mb",
         "mem_max_mb")
PKG = {"ref": (ref_core, ref_disp, ref_exp, ref_failures, RefWorkload),
       "port": (port_core, port_disp, port_exp, port_failures,
                SyntheticWorkload)}


def make_jobs(n=120, seed=2, job_cls=port_core.Job):
    rng = random.Random(seed)
    return [job_cls(id=str(i), user_id=1, submission_time=i * 11,
                    duration=rng.randint(10, 400),
                    expected_duration=rng.randint(10, 500),
                    requested_nodes=rng.randint(1, 2),
                    requested_resources={"core": rng.randint(1, 4),
                                         "mem": rng.randint(64, 512)})
            for i in range(n)]


# ----------------------------------------------------------------------
# the reference's checks, restated against the port
# ----------------------------------------------------------------------
def test_experiment_cross_product_and_plots(tmp_path):
    exp = Experiment("exp1", make_jobs(), SYS, output_dir=str(tmp_path),
                     device=CPU)
    exp.gen_dispatchers([port_disp.FirstInFirstOut,
                         port_disp.ShortestJobFirst],
                        [port_disp.FirstFit, port_disp.BestFit])
    assert len(exp.dispatchers) == 4
    results = exp.run_simulation(produce_plots=True)
    assert set(results) == {"FIFO-FF", "FIFO-BF", "SJF-FF", "SJF-BF"}
    for kind in ("slowdown", "queue_size", "dispatch_time"):
        assert os.path.exists(os.path.join(str(tmp_path), "exp1",
                                           f"plot_{kind}.png"))
    assert os.path.exists(os.path.join(str(tmp_path), "exp1",
                                       "summaries.json"))


def test_metrics_pipeline(tmp_path):
    exp = Experiment("exp2", make_jobs(80), SYS, output_dir=str(tmp_path),
                     device=CPU)
    exp.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    res = exp.run_simulation(produce_plots=False)
    out = res["FIFO-FF"]["output"]
    bench = res["FIFO-FF"]["bench"]
    sl = metrics.slowdowns(out)
    assert len(sl) == 80 and all(s >= 1.0 for s in sl)
    series = metrics.bench_series(bench)
    assert series["summary"]["completed"] == 80
    pts = metrics.dispatch_time_by_queue_size(bench)
    assert pts and all(c > 0 for _, _, c in pts)
    pct = metrics.percentiles(sl)
    assert pct["p50"] <= pct["p95"] <= pct["max"]


def test_batch_planner_partitions_fleet_vs_host(tmp_path):
    """Compilable grid rows lower onto the fleet engine, the rest run on
    the host, every summary tagged with ``engine`` and
    ``fallback_reason``, and the per-repeat seeds are ``base_seed +
    rep``."""

    class TweakedFIFO(port_disp.FirstInFirstOut):
        """Subclass -> not exactly FirstInFirstOut -> host only."""
        name = "TFIFO"

    wl = SyntheticWorkload(60, seed=40, **WL)
    exp = Experiment("mix", wl, SYS, output_dir=str(tmp_path), repeats=2,
                     device=CPU)
    exp.gen_dispatchers([port_disp.FirstInFirstOut,
                         port_disp.ShortestJobFirst],
                        [port_disp.FirstFit, port_disp.BestFit])
    exp.add_dispatcher(TweakedFIFO(port_disp.FirstFit()))
    res = exp.run_simulation(produce_plots=False)
    assert set(res) == {"FIFO-FF", "FIFO-BF", "SJF-FF", "SJF-BF",
                        "TFIFO-FF"}
    for name, entry in res.items():
        engines = {s["engine"] for s in entry["summaries"]}
        reasons = {s["fallback_reason"] for s in entry["summaries"]}
        if name == "TFIFO-FF":
            assert engines == {"host"}, (name, engines)
            assert reasons == {"non-compilable-dispatcher"}
        else:
            assert engines == {"fleet"}, (name, engines)
            assert reasons == {None}
        assert [s["seed"] for s in entry["summaries"]] == [40, 41]
        assert os.path.exists(entry["output"])
        assert os.path.exists(entry["bench"])
    # reseeded repeats draw independent streams -> different end times
    ends = [s["sim_end_time"] for s in res["FIFO-FF"]["summaries"]]
    assert ends[0] != ends[1]
    with open(os.path.join(str(tmp_path), "mix", "summaries.json")) as fh:
        assert set(json.load(fh)) == set(res)


def test_fallback_reason_reports_host_only_knobs(tmp_path):
    """Host-only run knobs are named in ``fallback_reason``; ``device``
    is the constructor's, not a simulator knob."""
    wl = SyntheticWorkload(40, seed=11, mean_interarrival_s=30.0,
                           duration_median_s=300.0,
                           resources={"core": (1, 4), "mem": (64, 512)})
    exp = Experiment("knob", wl, SYS, output_dir=str(tmp_path),
                     use_fleet=False, device=CPU)
    exp.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    res = exp.run_simulation(produce_plots=False)
    s = res["FIFO-FF"]["summaries"][0]
    assert s["engine"] == "host"
    assert s["fallback_reason"] == "fleet-disabled"

    exp2 = Experiment("knob2", wl, SYS, output_dir=str(tmp_path), device=CPU)
    exp2.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    res2 = exp2.run_simulation(produce_plots=False,
                               start_kwargs={"max_events": 10 ** 9})
    s2 = res2["FIFO-FF"]["summaries"][0]
    assert s2["engine"] == "host"
    assert s2["fallback_reason"] == "custom-start-kwargs"

    exp3 = Experiment("knob3", wl, SYS, output_dir=str(tmp_path),
                      device=CPU, lookahead_jobs=64, other_knob=1)
    exp3.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    assert exp3._fallback_reason(exp3.dispatchers[0], {}) == \
        "host-only-sim-kwargs:other_knob"
    assert exp2._fallback_reason(exp2.dispatchers[0], {}) is None


def test_batch_planner_fleet_and_host_agree(tmp_path):
    """Same grid row through both engines -> identical simulation
    outcome (counters + end time)."""
    wl = SyntheticWorkload(60, seed=40, **WL)
    out = {}
    for flag in (True, False):
        exp = Experiment(f"uf{flag}", wl, SYS, output_dir=str(tmp_path),
                         use_fleet=flag, device=CPU)
        exp.gen_dispatchers([port_disp.ShortestJobFirst],
                            [port_disp.FirstFit])
        out[flag] = exp.run_simulation(produce_plots=False)[
            "SJF-FF"]["summaries"][0]
    assert out[True]["engine"] == "fleet"
    assert out[False]["engine"] == "host"
    for key in ("submitted", "completed", "rejected", "sim_end_time"):
        assert out[True][key] == out[False][key], key


def test_plot_factory_group_validation(tmp_path):
    pf = PlotFactory("decision", SYS)
    with pytest.raises(ValueError):
        pf.produce_plot("dispatch_time")   # performance plot, wrong group
    with pytest.raises(ValueError):
        PlotFactory("nonsense", SYS)


# ----------------------------------------------------------------------
# the port against the reference on the same inputs
# ----------------------------------------------------------------------
def _grid(pkg, root):
    """The 8 Table-2 policies x 2 repeats of a synthetic workload, plus
    a subclassed (host-only) FIFO."""
    core, disp, exp_mod, _, workload = PKG[pkg]

    class TweakedFIFO(disp.FirstInFirstOut):
        name = "TFIFO"

    kw = {"device": CPU} if pkg == "port" else {}
    exp = exp_mod.Experiment("grid", workload(60, seed=40, **WL), SYS,
                             output_dir=root, repeats=2, **kw)
    exp.gen_dispatchers([disp.FirstInFirstOut, disp.ShortestJobFirst,
                         disp.LongestJobFirst, disp.EasyBackfilling],
                        [disp.FirstFit, disp.BestFit])
    exp.add_dispatcher(TweakedFIFO(disp.FirstFit()))
    return exp


def _host_only(pkg, root):
    """The 8 policies on the host (``use_fleet=False``), one list of
    Jobs."""
    core, disp, exp_mod, _, _ = PKG[pkg]
    kw = {"device": CPU} if pkg == "port" else {}
    exp = exp_mod.Experiment("host", make_jobs(80, job_cls=core.Job), SYS,
                             output_dir=root, use_fleet=False, **kw)
    exp.gen_dispatchers([disp.FirstInFirstOut, disp.ShortestJobFirst,
                         disp.LongestJobFirst, disp.EasyBackfilling],
                        [disp.FirstFit, disp.BestFit])
    return exp


def _failures(pkg, root):
    """FIFO-FF and EBF-BF under a FAIL/REPAIR schedule with checkpoint
    credit, a quarantine and telemetry, on the fleet."""
    core, disp, exp_mod, failures, workload = PKG[pkg]
    kw = {"device": CPU} if pkg == "port" else {}
    inj = failures.FailureInjector(8, mtbf_s=3000.0, repair_s=900.0,
                                  horizon_s=4000, seed=3)
    exp = exp_mod.Experiment(
        "fail", workload(80, seed=7, mean_interarrival_s=25.0,
                         duration_median_s=900.0,
                         resources={"core": (1, 4), "mem": (64, 512)}),
        SYS, output_dir=root, failures=inj,
        checkpoint=failures.CheckpointRestartPolicy(600), quarantine_s=1800,
        telemetry_stride=5, **kw)
    exp.add_dispatcher(disp.FirstInFirstOut(disp.FirstFit()))
    exp.add_dispatcher(disp.EasyBackfilling(disp.BestFit()))
    return exp


def _read_lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _assert_summary_equal(got, want, where):
    assert set(got) == set(want), where
    for key in want:
        if key in TIMED:
            assert type(got[key]) is type(want[key]), (where, key)
        else:
            assert got[key] == want[key], (where, key)


def _assert_same_run(port_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    with open(os.path.join(port_dir, "summaries.json")) as fh:
        got = json.load(fh)
    with open(os.path.join(ref_dir, "summaries.json")) as fh:
        want = json.load(fh)
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            _assert_summary_equal(g, w, name)
    for f in names:
        p, r = os.path.join(port_dir, f), os.path.join(ref_dir, f)
        if f.endswith(("-output.jsonl", "-telemetry.jsonl")):
            with open(p, "rb") as a, open(r, "rb") as b:
                assert a.read() == b.read(), f
        if f.endswith("-output.jsonl"):
            assert metrics.slowdowns(p) == ref_exp.metrics.slowdowns(r)
            assert metrics.waiting_times(p) == \
                ref_exp.metrics.waiting_times(r)
            assert list(metrics.job_records(p)) == \
                list(ref_exp.metrics.job_records(r))
            assert metrics.percentiles(metrics.slowdowns(p)) == \
                ref_exp.metrics.percentiles(ref_exp.metrics.slowdowns(r))
        if f.endswith("-telemetry.jsonl"):
            assert metrics.telemetry_series(p) == \
                ref_exp.metrics.telemetry_series(r), f
        if f.endswith("-bench.jsonl"):
            g, w = _read_lines(p), _read_lines(r)
            assert len(g) == len(w), f
            for a, b in zip(g[:-1], w[:-1]):
                assert {k: a[k] for k in ("t", "queue", "running",
                                          "kernel_launches")} == \
                    {k: b[k] for k in ("t", "queue", "running",
                                       "kernel_launches")}, f
                assert set(a) == set(b), f
            _assert_summary_equal(g[-1]["summary"], w[-1]["summary"], f)
            gs, ws = metrics.bench_series(p), ref_exp.metrics.bench_series(r)
            assert set(gs) == set(ws)
            for k in ("t", "queue", "running"):
                assert gs[k] == ws[k], (f, k)
            assert len(gs["dispatch_s"]) == len(ws["dispatch_s"])
            assert [(b, c) for b, _, c in
                    metrics.dispatch_time_by_queue_size(p)] == \
                [(b, c) for b, _, c in
                 ref_exp.metrics.dispatch_time_by_queue_size(r)], f


@pytest.mark.parametrize("case", [_grid, _host_only, _failures],
                         ids=["table2_grid_x2_and_host_row", "use_fleet_off",
                              "failures_checkpoint_telemetry"])
def test_experiment_matches_reference(tmp_path, case):
    runs = {}
    for pkg in ("ref", "port"):
        exp = case(pkg, str(tmp_path / pkg))
        runs[pkg] = exp.run_simulation(produce_plots=False)
    assert list(runs["port"]) == list(runs["ref"])
    engines = {s["engine"] for v in runs["port"].values()
               for s in v["summaries"]}
    if case is _host_only:
        assert engines == {"host"}
    elif case is _grid:
        assert engines == {"fleet", "host"}
        assert runs["port"]["TFIFO-FF"]["summaries"][0]["engine"] == "host"
    else:
        assert engines == {"fleet"}
        assert any(s["failures"]["requeued_jobs"] > 0
                   for v in runs["port"].values() for s in v["summaries"])
    name = os.listdir(tmp_path / "ref")[0]
    _assert_same_run(str(tmp_path / "port" / name),
                     str(tmp_path / "ref" / name))
    for k in runs["ref"]:
        for key in ("output", "bench"):
            assert os.path.basename(runs["port"][k][key]) == \
                os.path.basename(runs["ref"][k][key])


# ----------------------------------------------------------------------
# plots, matplotlib, the device
# ----------------------------------------------------------------------
def test_every_plot_kind_writes_its_png(tmp_path):
    exp = Experiment("plots", SyntheticWorkload(40, seed=5, **WL), SYS,
                     output_dir=str(tmp_path), device=CPU,
                     telemetry_stride=4)
    exp.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    exp.add_dispatcher(port_disp.EasyBackfilling(port_disp.BestFit()))
    res = exp.run_simulation(produce_plots=False)
    outs = [res[k]["output"] for k in res]
    for group, kinds in (("decision", DECISION_PLOTS),
                         ("performance", PERFORMANCE_PLOTS),
                         ("telemetry", TELEMETRY_PLOTS)):
        pf = PlotFactory(group, SYS)
        pf.set_files(outs, list(res))
        for kind in kinds:
            png = pf.produce_plot(kind)
            assert png == os.path.join(os.path.dirname(outs[0]),
                                       f"plot_{kind}.png")
            assert os.path.getsize(png) > 0, kind
    png = utilization_heatmap(outs[0], 8, str(tmp_path / "heat.png"))
    assert os.path.getsize(png) > 0


def test_without_matplotlib_only_the_plots_raise(tmp_path):
    code = f"""
import sys
sys.modules["matplotlib"] = None
from repro_torch.core.dispatchers import EasyBackfilling, FirstFit, FirstInFirstOut
from repro_torch.experimentation import Experiment, PlotFactory, metrics
from repro_torch.workloads.synthetic import SyntheticWorkload
wl = SyntheticWorkload(40, seed=5, mean_interarrival_s=30.0,
                       duration_median_s=400.0,
                       resources={{"core": (1, 4), "mem": (64, 512)}})
sys_cfg = {SYS!r}
exp = Experiment("nomp", wl, sys_cfg, output_dir={str(tmp_path)!r},
                 device="cpu")
exp.add_dispatcher(FirstInFirstOut(FirstFit()))
exp.add_dispatcher(EasyBackfilling(FirstFit()))
res = exp.run_simulation(produce_plots=False)
print("ran", sorted(res), len(metrics.slowdowns(res["FIFO-FF"]["output"])))
try:
    exp.run_simulation(produce_plots=True)
except ImportError:
    print("plots raise ImportError")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["ran ['EBF-FF', 'FIFO-FF'] 40",
                                       "plots raise ImportError"]


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exp = Experiment("nocard", SyntheticWorkload(40, seed=5, **WL), SYS,
                     output_dir=str(tmp_path))
    exp.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run_simulation(produce_plots=False)
    assert not os.path.exists(tmp_path / "nocard" / "summaries.json")
    # a host row needs no card
    host = Experiment("host", SyntheticWorkload(40, seed=5, **WL), SYS,
                      output_dir=str(tmp_path), use_fleet=False)
    host.gen_dispatchers([port_disp.FirstInFirstOut], [port_disp.FirstFit])
    assert host.run_simulation(produce_plots=False)["FIFO-FF"][
        "summaries"][0]["engine"] == "host"
