"""The benchmark modes' kernels and quick dispatch sweep on the card.

``bench_kernels``' inputs at N 16384 (the widest it draws) go through
``alloc_score.cu`` and ``ebf_shadow.cu`` and through their plain
PyTorch versions on the same card: fit bits, score bits and fit counts
must be equal.  ``bench_dispatch.run(quick=True)`` runs its three
engines on the card, where its own check that they agree on
``sim_end_time`` must hold.  Imports no JAX and nothing of the
reference, so it runs on a GPU machine with the port alone::

    python -m pytest -q -m cuda tests/test_torch_bench_cuda.py
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks_torch import bench_dispatch, bench_kernels  # noqa: E402
from repro_torch.kernels import alloc_score as k_alloc  # noqa: E402
from repro_torch.kernels import counters, ref  # noqa: E402
from repro_torch.kernels import ebf_shadow as k_ebf  # noqa: E402


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _widest_inputs():
    rng = np.random.default_rng(0)
    for n_nodes in bench_kernels.SIZES:
        drawn = bench_kernels.draw(rng, n_nodes)
    return drawn


@pytest.mark.cuda
def test_bench_kernels_widest_inputs_equal_plain(cuda_dev):
    avail, cap, req, deltas = _widest_inputs()
    assert avail.shape == (16384, 4)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
    a, c, q = put(avail), put(cap), put(req)
    counters.reset_device_launches()
    bits, score = k_alloc.alloc_score(a, c, q)
    want_bits, want_score = ref.alloc_score_packed_ref(a, c, q.view(1, -1))
    assert torch.equal(bits, want_bits[0])
    assert torch.equal(score.view(torch.int32), want_score.view(torch.int32))

    sparse = [put(x) for x in bench_kernels.sparse_deltas(deltas)]
    fits = k_ebf.ebf_shadow(a, *sparse, q, bench_kernels.M)
    want = ref.ebf_shadow_sparse_ref(a, *sparse, q, bench_kernels.M)
    assert torch.equal(fits, want)
    dense = ref.ebf_shadow_ref(a, put(deltas), q)
    assert torch.equal(fits, dense)
    assert counters.device_launch_stats() == {"alloc_score": 1,
                                              "ebf_shadow": 1}


@pytest.mark.cuda
def test_bench_dispatch_quick_on_the_card(cuda_dev, tmp_path, monkeypatch):
    monkeypatch.setattr(bench_dispatch, "REPO_ROOT", str(tmp_path))
    counters.reset_device_launches()
    result = bench_dispatch.run(str(tmp_path / "out"), quick=True)
    launches = counters.device_launch_stats()
    assert result["mode"] == "cuda"
    assert len({c["sim_end_time"] for c in result["cells"]}) == 1
    with open(tmp_path / "BENCH_torch_dispatch.json") as fh:
        assert json.load(fh)["env"]["nvidia_smi"]
    for name in ("alloc_score", "alloc_score_batch", "ebf_shadow"):
        assert launches.get(name, 0) > 0, name
