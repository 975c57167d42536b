"""Training on the card against the same step on the CPU.

* One train step (2 micro-batches, float32, TF32 off) of the smollm-360m
  and falcon-mamba-7b smoke models on the card against the port on the
  CPU, from one set of parameters (drawn on the CPU, copied) and one
  batch: loss within 1e-4, grads within 1e-3 of each leaf's max |g|,
  parameters after the step within 1e-4.
* ``selective_scan`` CUDA launches per falcon-mamba step: layers x
  micro-batches with ``remat="none"``, twice that with ``"full"`` and
  ``"dots"`` (the recomputed forward), and ``selective_scan_bwd``
  layers x micro-batches; the step's gradients against the CPU's.
* The scan's batch chunks past 65535 rows, forward and backward, against
  the plain versions.

Imports no JAX and nothing of the reference, so it runs on a GPU machine
with the port alone::

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""
import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counters, ref
from repro_torch.kernels import selective_scan as k_scan
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  copy_task_batch, make_train_step)
from repro_torch.training.train_step import make_grad_fn


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b"])
def test_train_step_on_the_card_equals_cpu(cuda_dev, arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = TrainStepConfig(microbatches=2)
    ocfg = AdamWConfig(lr=1e-3)
    sides = {}
    for dev in ("cpu", cuda_dev):
        model = build_model(cfg, dev)
        if dev == "cpu":
            params = model.init_params(seed=0)
            start = copy.deepcopy(params)
        else:
            params = copy.deepcopy(start).to(dev)
        batch = copy_task_batch(cfg, 4, 32, 0, device=dev)
        grads, loss = make_grad_fn(model, tcfg)(params, batch)
        params, _, met = make_train_step(model, ocfg, tcfg)(
            params, adamw_init(params, ocfg), batch)
        sides[str(dev)] = (loss, grads, met, dict(params.named_parameters()))
    (loss, grads, met, new), (dloss, dgrads, dmet, dnew) = sides.values()
    assert abs(float(loss) - float(dloss)) < 1e-4
    assert abs(float(met["loss"]) - float(dmet["loss"])) < 1e-4
    for n, g in grads.items():
        bound = 1e-3 * max(float(g.abs().max()), 1e-30)
        assert float((dgrads[n].cpu() - g).abs().max()) <= bound, n
        assert float((dnew[n].detach().cpu() - new[n].detach()).abs().max()
                     ) <= 1e-4, n


@pytest.mark.cuda
@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2),
                                             ("dots", 2)])
def test_scan_launches_per_train_step(cuda_dev, remat, per_layer):
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    model = build_model(cfg, cuda_dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig()
    tcfg = TrainStepConfig(microbatches=2, remat=remat)
    step = make_train_step(model, ocfg, tcfg)
    opt = adamw_init(params, ocfg)
    start = copy.deepcopy(params).to("cpu")
    batch = copy_task_batch(cfg, 4, 32, 0, device=cuda_dev)
    counters.reset_device_launches()
    grads, _ = make_grad_fn(model, tcfg)(params, batch)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {
        "selective_scan": cfg.n_layers * per_layer * 2,
        "selective_scan_bwd": cfg.n_layers * 2}
    want, _ = make_grad_fn(build_model(cfg, "cpu"), tcfg)(
        start, copy_task_batch(cfg, 4, 32, 0, device="cpu"))
    for n, g in want.items():
        bound = 1e-3 * max(float(g.abs().max()), 1e-30)
        assert float((grads[n].cpu() - g).abs().max()) <= bound, n
    counters.reset_device_launches()
    params, opt, met = step(params, opt, batch)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {
        "selective_scan": cfg.n_layers * per_layer * 2,
        "selective_scan_bwd": cfg.n_layers * 2}
    assert bool(torch.isfinite(met["loss"]))


@pytest.mark.cuda
def test_selective_scan_chunks_the_batch_past_65535(cuda_dev):
    g = torch.Generator().manual_seed(0)
    bt, length, di, s = k_scan.MAX_BT + 2, 3, 5, 2
    u, B, C = (torch.randn(shape, generator=g) for shape in (
        (bt, length, di), (bt, length, s), (bt, length, s)))
    delta = torch.rand((bt, length, di), generator=g) * 0.1
    A = -torch.rand((di, s), generator=g)
    D = torch.randn((di,), generator=g)
    args = [t.to(cuda_dev).requires_grad_() for t in (u, delta, A, B, C, D)]
    gy = torch.randn((bt, length, di), generator=g).to(cuda_dev)
    gh = torch.randn((bt, di, s), generator=g).to(cuda_dev)
    counters.reset_device_launches()
    y, h = k_scan.selective_scan(*args)
    torch.autograd.backward((y, h), (gy, gh))
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"selective_scan": 2,
                                              "selective_scan_bwd": 2}
    plain = [t.detach() for t in args]
    want_y, want_h = ref.selective_scan_ref(*plain)
    assert y.shape == (bt, length, di) and h.shape == (bt, di, s)
    torch.testing.assert_close(y.detach(), want_y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h.detach(), want_h, atol=1e-5, rtol=1e-5)
    for x, w in zip(args, ref.selective_scan_bwd_ref(*plain, gy, gh)):
        bound = 1e-4 * max(float(w.abs().max()), 1e-30)
        assert float((x.grad - w).abs().max()) <= bound
