"""The port's benchmark utilities and its Table-2 study, on the CPU.

* ``benchmarks_torch.common.seth_jobs`` draws the reference's Seth
  stream job for job;
* ``bench_metadata`` stamps a positive peak RSS and the torch fields,
  and ``peak_rss_mb`` reads ``getrusage`` where the status file has no
  ``VmHWM:`` line (the card's machine has none) and raises where
  neither gives a reading;
* ``table2_dispatchers.run(device="cpu")`` gives the reference's
  ``table2.json`` keys, rows and ``emit`` lines, equal but for the
  timing and memory fields.
"""
import json
import os
import pathlib
import resource
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import table2_dispatchers as ref_table2  # noqa: E402
from benchmarks_torch import common  # noqa: E402
from benchmarks_torch import table2_dispatchers as table2  # noqa: E402
from repro_torch.utils import sysinfo  # noqa: E402

JOB_FIELDS = ("id", "user_id", "submission_time", "duration",
              "expected_duration", "requested_nodes", "requested_resources")
TIMED = ("total_cpu_s", "dispatch_cpu_s", "mem_avg_mb", "mem_max_mb")


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_seth_stream_equals_reference(seed):
    got = [tuple(getattr(j, k) for k in JOB_FIELDS)
           for j in common.seth_jobs(3000, seed=seed)]
    want = [tuple(getattr(j, k) for k in JOB_FIELDS)
            for j in ref_common.seth_jobs(3000, seed=seed)]
    assert got == want
    assert common.SETH == ref_common.SETH


def test_bench_metadata_reports_peak_rss_and_torch():
    meta = common.bench_metadata()
    assert meta["peak_rss_mb"] > 0
    assert meta["cpu_time_s"] > 0
    for key in ("torch", "cuda", "device_count", "device_kind",
                "nvidia_smi"):
        assert key in meta
    assert sysinfo.peak_rss_mb() >= sysinfo.rss_mb() * 0.9


def test_peak_rss_reads_getrusage_without_a_vmhwm_line(tmp_path,
                                                       monkeypatch):
    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmHWM:\t  204800 kB\n"
                      "VmRSS:\t  102400 kB\n")
    monkeypatch.setattr(sysinfo, "STATUS_PATH", str(status))
    assert sysinfo.peak_rss_mb() == 200.0
    assert sysinfo.rss_mb() == 100.0

    # no VmHWM line (as on a machine whose kernel omits it), or no file
    status.write_text("Name:\tpython\nVmRSS:\t  102400 kB\n")
    for path in (str(status), str(tmp_path / "missing")):
        monkeypatch.setattr(sysinfo, "STATUS_PATH", path)
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        got = sysinfo.peak_rss_mb()
        after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        assert 0 < before <= got <= after

    class NoReading:
        ru_maxrss = 0

    monkeypatch.setattr(resource, "getrusage", lambda who: NoReading())
    with pytest.raises(RuntimeError, match="no peak resident set size"):
        sysinfo.peak_rss_mb()


def test_table2_matches_reference(tmp_path, capsys):
    out = {}
    for name, mod, kw in (("ref", ref_table2, {}),
                          ("port", table2, {"device": "cpu"})):
        capsys.readouterr()
        rows = mod.run(out_dir=str(tmp_path / name), n_jobs=300, **kw)
        lines = capsys.readouterr().out.strip().splitlines()
        with open(tmp_path / name / "table2" / "table2.json") as fh:
            assert json.load(fh) == rows
        assert os.path.exists(tmp_path / name / "table2" /
                              "plot_slowdown.png")
        out[name] = rows, [ln.split(",")[0] for ln in lines], \
            [ln.split(",")[2] for ln in lines]
    (got, got_names, got_derived), (want, want_names, want_derived) = \
        out["port"], out["ref"]
    assert list(got) == list(want)
    assert len(want) == 8
    assert got_names == want_names and got_derived == want_derived
    for name in want:
        assert list(got[name]) == list(want[name])
        for key in want[name]:
            if key in TIMED:
                assert type(got[name][key]) is type(want[name][key])
            else:
                assert got[name][key] == want[name][key], (name, key)
    with open(tmp_path / "port" / "table2" / "summaries.json") as fh:
        assert {s["engine"] for v in json.load(fh).values()
                for s in v} == {"fleet"}
