"""The MoE FFN on the card against the same computation on the CPU.

* The MoE layer in float32 (TF32 off) on the card against the CPU, with
  and without capacity drops: the top-k sets of every token are
  recorded on both sides and must agree; outputs within 1e-5.
* The bf16 combine adds each token's contributions in expert order with
  no atomics: two runs at qwen3-moe's routing (top-8 of 128, groups of
  1024) give equal bits.
* One train step (2 micro-batches, float32) of the qwen3-moe and Jamba
  smoke models on the card against the CPU: loss within 1e-4, grads
  within 1e-3 of each leaf's max |g|, parameters within 1e-4, and the
  top-k sets of every routed token equal.

Imports no JAX and nothing of the reference, so it runs on a GPU machine
with the port alone::

    python -m pytest -q -m cuda tests/test_torch_moe_cuda.py
"""
import contextlib
import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
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


@contextlib.contextmanager
def routes(monkeypatch):
    """Records the expert ids each ``moe.route`` call picks, as sorted
    top-k sets on the CPU."""
    seen, route = [], moe.route

    def observed(*args):
        top_p, top_i = route(*args)
        seen.append(top_i.sort(dim=-1).values.cpu())
        return top_p, top_i
    with monkeypatch.context() as m:
        m.setattr(moe, "route", observed)
        yield seen


def _weights(gen, d, e, f, dev, dtype=torch.float32):
    p = moe.MoEParams(
        router=torch.randn((d, e), generator=gen) * d ** -0.5,
        w_in=torch.randn((e, d, f), generator=gen) * d ** -0.5,
        w_gate=torch.randn((e, d, f), generator=gen) * d ** -0.5,
        w_out=torch.randn((e, f, d), generator=gen) * f ** -0.5,
        shared_w_in=torch.randn((d, 2 * f), generator=gen) * d ** -0.5,
        shared_w_gate=torch.randn((d, 2 * f), generator=gen) * d ** -0.5,
        shared_w_out=torch.randn((2 * f, d), generator=gen) * f ** -0.5)
    return moe.MoEParams(*(t.to(dev, dtype) for t in p))


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 100.0], ids=["drops", "no_drops"])
def test_moe_layer_on_the_card_equals_cpu(cuda_dev, monkeypatch, cf):
    gen = torch.Generator().manual_seed(0)
    d, e, k, f = 256, 64, 4, 128
    p = _weights(gen, d, e, f, "cpu")
    x = torch.randn((2, 512, d), generator=gen)
    kw = dict(k=k, n_experts=e, group_size=512, capacity_factor=cf)
    outs, sets = [], []
    for dev in ("cpu", cuda_dev):
        with routes(monkeypatch) as seen:
            outs.append(moe.moe_ffn(x.to(dev), moe.MoEParams(
                *(t.to(dev) for t in p)), **kw).cpu())
        sets.append(torch.cat(seen))
    agree = (sets[0] == sets[1]).all(-1)
    print(f"top-k sets agree for {int(agree.sum())} of {agree.numel()} "
          "tokens")
    assert bool(agree.all())
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_moe_bf16_combine_is_bitwise_repeatable(cuda_dev):
    gen = torch.Generator().manual_seed(1)
    d, e, k, f = 512, 128, 8, 192
    p = _weights(gen, d, e, f, cuda_dev, torch.bfloat16)
    x = torch.randn((2, 1024, d), generator=gen).to(cuda_dev, torch.bfloat16)
    kw = dict(k=k, n_experts=e, group_size=1024, capacity_factor=1.25)
    first = moe.moe_ffn(x, p, **kw)
    for _ in range(3):
        assert torch.equal(moe.moe_ffn(x, p, **kw), first)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b"])
def test_moe_train_step_on_the_card_equals_cpu(cuda_dev, monkeypatch, arch):
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
        with routes(monkeypatch) as seen:
            grads, loss = make_grad_fn(model, tcfg)(params, batch)
        params, _, met = make_train_step(model, ocfg, tcfg)(
            params, adamw_init(params, ocfg), batch)
        sides[str(dev)] = (loss, grads, met, dict(params.named_parameters()),
                           seen)
    (loss, grads, met, new, sets), (dloss, dgrads, dmet, dnew, dsets) = \
        sides.values()
    assert len(sets) == len(dsets) > 0
    assert all(torch.equal(a, b) for a, b in zip(sets, dsets))
    assert abs(float(loss) - float(dloss)) < 1e-4
    assert abs(float(met["loss"]) - float(dmet["loss"])) < 1e-4
    for n, g in grads.items():
        bound = 1e-3 * max(float(g.abs().max()), 1e-30)
        assert float((dgrads[n].cpu() - g).abs().max()) <= bound, n
        assert float((dnew[n].detach().cpu() - new[n].detach()).abs().max()
                     ) <= 1e-4, n
