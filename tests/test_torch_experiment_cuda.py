"""The Experiment layer on the card against the same grid on the CPU.

A small grid (the 8 Table-2 policies x 2 repeats of a synthetic
workload, a subclassed host-only row, and a vectorized row) runs once
with the default device (the card: the ``fleet_engine`` kernel for the
fleet rows, ``alloc_score`` for the vectorized one) and once with
``device="cpu"`` (their plain PyTorch versions): every job record is
equal byte for byte, and the summaries agree but for the timing
fields.  Imports no JAX and nothing of the reference, so it runs on a
GPU machine with the port alone::

    python -m pytest -q -m cuda tests/test_torch_experiment_cuda.py
"""
import json
import os

import pytest
import torch

from repro_torch.core.dispatchers import (BestFit, EasyBackfilling, FirstFit,
                                          FirstInFirstOut, LongestJobFirst,
                                          ShortestJobFirst)
from repro_torch.core.dispatchers.vectorized import VectorizedAllocator
from repro_torch.experimentation import Experiment
from repro_torch.kernels import counters
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"compute": {"core": 4, "mem": 1024}}, "nodes": {"compute": 8}}
TIMED = ("cpu_time_s", "wall_time_s", "dispatch_time_s", "mem_avg_mb",
         "mem_max_mb")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(root, device):
    class TweakedFIFO(FirstInFirstOut):
        name = "TFIFO"

    wl = SyntheticWorkload(120, seed=40, mean_interarrival_s=30.0,
                           duration_median_s=400.0,
                           resources={"core": (1, 4), "mem": (64, 512)})
    exp = Experiment("grid", wl, SYS, output_dir=root, repeats=2,
                     device=device)
    exp.gen_dispatchers([FirstInFirstOut, ShortestJobFirst, LongestJobFirst,
                         EasyBackfilling], [FirstFit, BestFit])
    exp.add_dispatcher(TweakedFIFO(FirstFit()))
    exp.add_dispatcher(FirstInFirstOut(VectorizedAllocator(
        "BF", device=device)))
    return exp.run_simulation(produce_plots=False)


@pytest.mark.cuda
def test_experiment_on_the_card_equals_cpu(cuda_dev, tmp_path):
    counters.reset_device_launches()
    card = _run(str(tmp_path / "card"), None)
    launches = counters.device_launch_stats()
    assert launches.get("fleet_engine") == 2          # blocking, EBF
    assert launches.get("alloc_score_batch", 0) > 0   # the FIFO-vBF row
    cpu = _run(str(tmp_path / "cpu"), "cpu")
    assert list(card) == list(cpu)
    for name in cpu:
        for got, want in zip(card[name]["summaries"], cpu[name]["summaries"]):
            assert set(got) == set(want)
            for key in want:
                if key not in TIMED:
                    assert got[key] == want[key], (name, key)
    names = sorted(os.listdir(tmp_path / "cpu" / "grid"))
    assert sorted(os.listdir(tmp_path / "card" / "grid")) == names
    for f in names:
        if f.endswith("-output.jsonl"):
            assert (tmp_path / "card" / "grid" / f).read_bytes() == \
                (tmp_path / "cpu" / "grid" / f).read_bytes(), f
    with open(tmp_path / "card" / "grid" / "summaries.json") as fh:
        assert {s["engine"] for v in json.load(fh).values()
                for s in v} == {"fleet", "host"}
