"""The models' sharding annotations and the dry-run against the card.

* Every smoke config's train-mode logits on the card are bitwise the same
  with sharding rules active as without (``shard`` acts only on
  DTensors, so the card path is unchanged), and within 1e-4 of the CPU's
  (float32, TF32 off).
* The falcon-mamba-7b and Jamba cells dry-run on the fake 4 × 2 mesh
  under the card machine's torch.
* ``chip_smoke.py`` phase 17's check at the qwen3-1.7b smoke config: a
  train step at 16 × 2048 tokens dry-run on a 1 × 1 mesh of the fake
  world, then the same step on the card (2 warm, 5 timed): the measured
  step is not shorter than the dry-run's ``compute_s``, and the
  predicted per-device bytes (4.3 GB) are at least half the measured
  peak.  At a few hundred tokens the card's fixed allocations (cuBLAS
  workspaces, the allocator's blocks: ~0.1 GB) outweigh the step's, which
  the dry-run does not model.

Imports no JAX and nothing of the reference, so it runs on a GPU machine
with the port alone::

    python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py
"""
import copy
import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import build_model
from repro_torch.sharding import use_rules
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  make_batch_for, make_train_step)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


class _Mesh:
    axis_names = ("data", "model")
    devices = np.zeros((4, 2))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_annotations_leave_card_logits_alone(arch, cuda_dev):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    shape = ShapeSpec("train", 64, 2, "train")
    outs = {}
    weights = build_model(cfg, "cpu").init_params(seed=0)
    data = make_batch_for(cfg, shape, 0, device="cpu")
    for dev in (torch.device("cpu"), cuda_dev):
        model = build_model(cfg, dev)
        params = copy.deepcopy(weights).to(dev)
        batch = {k: v.to(dev) for k, v in data.items()}
        with torch.no_grad():
            plain, _ = model.apply(params, batch, mode="train")
            with use_rules(_Mesh(), "baseline"):
                ruled, _ = model.apply(params, batch, mode="train")
        assert torch.equal(plain, ruled), dev
        outs[dev.type] = plain.cpu()
    scale = outs["cpu"].abs().max()
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-4 * max(scale, 1)


def test_dryrun_bounds_a_smoke_train_step_on_the_card(cuda_dev):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    arch = "qwen3-1.7b"
    shape = ShapeSpec("train_16x2048", 2048, 16, "train")
    rec = dryrun.run_cell(arch, shape, "1x1", "baseline", microbatches=1,
                          smoke=True, remat="full",
                          mesh=make_mesh((1, 1), ("data", "model")))
    assert rec["ok"], rec.get("traceback")
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, cuda_dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg,
                           TrainStepConfig(microbatches=1, remat="full"))
    batch = make_batch_for(cfg, shape, 0, device=cuda_dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(7):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        assert np.isfinite(float(met["loss"]))          # synchronises
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    assert statistics.median(secs[2:]) >= rec["roofline"]["compute_s"]
    assert rec["memory"]["per_device_bytes"] >= peak / 2


#: the Mamba and hybrid cells of the dry-run on its 4 x 2 mesh: train,
#: prefill and decode (where the SSM's dt product runs on local shards)
MAMBA_CELLS = [("falcon-mamba-7b", "train_4k", "stub"),
               ("falcon-mamba-7b", "prefill_32k", "ref"),
               ("falcon-mamba-7b", "decode_32k", "ref"),
               ("jamba-1.5-large-398b", "train_4k", "ref"),
               ("jamba-1.5-large-398b", "prefill_32k", "ref"),
               ("jamba-1.5-large-398b", "decode_32k", "ref")]


@pytest.mark.parametrize("arch,shape,scan", MAMBA_CELLS)
def test_mamba_cells_dry_run_on_the_small_mesh(arch, shape, scan, cuda_dev):
    """The falcon-mamba-7b and Jamba smoke cells trace on the fake 4 x 2
    mesh under the torch of the machine with the card (the dry-run runs
    on ``meta`` tensors; it launches nothing there)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, "debug", "baseline", smoke=True,
                          scan_impl=scan)
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 8 and rec["hlo"]["flops_per_device"] > 0
