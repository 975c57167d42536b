"""The port's ``Simulator`` end to end against the JAX reference's.

On a seeded ``SyntheticWorkload``, with and without telemetry (and once
with a seeded node-failure schedule), the port's summary equals the
reference's in every field but the timing and memory ones, and the
port's telemetry trace passes ``assert_parity`` against the reference's
in both directions.  The vectorized row runs on the CPU through the
kernels' plain versions.
"""
import pytest

from repro.cluster import FailureInjector
from repro.core import Simulator as RSimulator
from repro.core.dispatchers import (BestFit as RBestFit,
                                    EasyBackfilling as REasyBackfilling,
                                    FirstFit as RFirstFit,
                                    FirstInFirstOut as RFirstInFirstOut)
from repro.core.dispatchers.vectorized import (
    VectorizedAllocator as RVectorizedAllocator,
    VectorizedEasyBackfilling as RVectorizedEasyBackfilling)
from repro.core.job import JobFactory as RJobFactory
from repro.workloads.synthetic import SyntheticWorkload as RSyntheticWorkload

from repro_torch.core import Simulator
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut)
from repro_torch.core.job import JobFactory
from repro_torch.core.dispatchers.vectorized import (
    VectorizedAllocator, VectorizedEasyBackfilling)
from repro_torch.telemetry import TelemetryTrace
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
WL = dict(seed=11, mean_interarrival_s=25.0, duration_median_s=900.0,
          duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
          resources={"core": (1, 4), "mem": (64, 1024)})
UNTIMED = {"cpu_time_s", "wall_time_s", "dispatch_time_s", "mem_avg_mb",
           "mem_max_mb"}

ROWS = {
    "FIFO-FF": (lambda: FirstInFirstOut(FirstFit()),
                lambda: RFirstInFirstOut(RFirstFit())),
    "EBF-BF": (lambda: EasyBackfilling(BestFit()),
               lambda: REasyBackfilling(RBestFit())),
    "vEBF-vBF": (lambda: VectorizedEasyBackfilling(
                     VectorizedAllocator("BF", device="cpu")),
                 lambda: RVectorizedEasyBackfilling(
                     RVectorizedAllocator("BF"))),
}


def _failures():
    return FailureInjector(10, mtbf_s=4000.0, repair_s=900.0,
                           horizon_s=6000, seed=3).arrays()


def _pair(row, tmp_path, stride, failures=False, n=150):
    kw = dict(failures=_failures(), quarantine_s=1800) if failures else {}
    port_sched, ref_sched = ROWS[row]
    port = Simulator(SyntheticWorkload(n, **WL), SYS, port_sched(),
                     job_factory=JobFactory(), output_dir=str(tmp_path),
                     name=f"port-{row}", telemetry_stride=stride, **kw)
    ref = RSimulator(RSyntheticWorkload(n, **WL), SYS, ref_sched(),
                     job_factory=RJobFactory(), output_dir=str(tmp_path),
                     name=f"ref-{row}", telemetry_stride=stride, **kw)
    port.start_simulation()
    ref.start_simulation()
    return port, ref


def _untimed(summary):
    return {k: v for k, v in summary.items() if k not in UNTIMED}


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("stride", [0, 5])
def test_summary_matches_reference(row, stride, tmp_path):
    port, ref = _pair(row, tmp_path, stride)
    got, want = _untimed(port.summary), _untimed(ref.summary)
    assert got.pop("dispatcher") == row
    want.pop("dispatcher")
    assert got == want
    assert set(port.summary) == set(ref.summary)
    if stride:
        port.telemetry.assert_parity(ref.telemetry)
        ref.telemetry.assert_parity(port.telemetry)
    else:
        assert port.telemetry is None and ref.telemetry is None


@pytest.mark.parametrize("row", ["FIFO-FF", "vEBF-vBF"])
def test_failures_summary_and_telemetry_match_reference(row, tmp_path):
    port, ref = _pair(row, tmp_path, stride=3, failures=True)
    assert port.summary["failures"]["requeued_jobs"] > 0
    assert _untimed(port.summary) == _untimed(ref.summary)
    port.telemetry.assert_parity(ref.telemetry)
    # the JSONL trace the port wrote reads back to the same samples
    back = TelemetryTrace.read_jsonl(
        str(tmp_path / f"port-{row}-telemetry.jsonl"))
    back.assert_parity(ref.telemetry)
