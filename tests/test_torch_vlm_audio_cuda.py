"""The vlm and audio families on the card against the same computation on
the CPU, at their smoke configs in float32 (TF32 off).

* Prefill and 4 decode steps of internvl2-76b (patches early-fused) and
  whisper-medium (frames through the encoder): logits and every cache
  leaf on the card within 1e-4 of the CPU's, and greedy tokens equal.
* One train step (2 micro-batches) of each family on
  ``make_batch_for``'s shapes: loss within 1e-4, grads within 1e-3 of
  each leaf's max |g|, parameters after AdamW within 1e-4.

Neither family reaches a CUDA kernel of the port: they run the plain
PyTorch attention, MLP and products.  Imports no JAX and nothing of the
reference, so it runs on a GPU machine with the port alone::

    python -m pytest -q -m cuda tests/test_torch_vlm_audio_cuda.py
"""
import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import build_model
from repro_torch.serving import greedy_generate
from repro_torch.serving.serve_step import pad_kv
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  make_batch_for, make_train_step)
from repro_torch.training.train_step import make_grad_fn

ARCHS = ("internvl2-76b", "whisper-medium")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _batch(cfg, seq, b=2):
    """A prefill batch of ``seq`` positions (patches included for vlm;
    frames for audio, with ``max(seq // 8, 8)`` decoder tokens)."""
    return make_batch_for(cfg, ShapeSpec("t", seq, b, "prefill"), 0,
                          device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_the_card_equal_cpu(cuda_dev, arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    batch = _batch(cfg, 64)
    max_seq = 80
    sides = []
    for dev in ("cpu", cuda_dev):
        model = build_model(cfg, dev)
        if dev == "cpu":
            params = model.init_params(seed=0)
            start = copy.deepcopy(params)
        else:
            params = copy.deepcopy(start).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        logits = []
        with torch.no_grad():
            lg, cache = model.apply(params, b, mode="prefill")
            logits.append(lg[:, -1].cpu())
            cache = pad_kv(cache, max_seq)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            for _ in range(4):
                lg, cache = model.apply(params, {"tokens": tok},
                                        mode="decode", cache=cache)
                logits.append(lg[:, -1].cpu())
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        tokens = greedy_generate(model, params, b, 6, max_seq=max_seq)
        sides.append((logits, cache, tokens.cpu()))
    (logits, cache, tokens), (dlogits, dcache, dtokens) = sides
    for a, b in zip(logits, dlogits):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
    for blk, dblk in zip(cache["blocks"], dcache["blocks"]):
        assert blk.keys() == dblk.keys()
        for name in blk:
            torch.testing.assert_close(dblk[name].cpu(), blk[name],
                                       atol=1e-4, rtol=1e-4)
    assert torch.equal(dcache["index"].cpu(), cache["index"])
    assert torch.equal(dtokens, tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_card_equals_cpu(cuda_dev, arch):
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = TrainStepConfig(microbatches=2)
    ocfg = AdamWConfig(lr=1e-3)
    shape = ShapeSpec("t", 64, 4, "train")
    sides = []
    for dev in ("cpu", cuda_dev):
        model = build_model(cfg, dev)
        if dev == "cpu":
            params = model.init_params(seed=0)
            start = copy.deepcopy(params)
        else:
            params = copy.deepcopy(start).to(dev)
        batch = make_batch_for(cfg, shape, 0, task="copy", device=dev)
        grads, loss = make_grad_fn(model, tcfg)(params, batch)
        params, _, met = make_train_step(model, ocfg, tcfg)(
            params, adamw_init(params, ocfg), batch)
        sides.append((loss, grads, met, dict(params.named_parameters())))
    (loss, grads, met, new), (dloss, dgrads, dmet, dnew) = sides
    assert abs(float(loss) - float(dloss)) < 1e-4
    assert abs(float(met["loss"]) - float(dmet["loss"])) < 1e-4
    for n, g in grads.items():
        bound = 1e-3 * max(float(g.abs().max()), 1e-30)
        assert float((dgrads[n].cpu() - g).abs().max()) <= bound, n
        assert float((dnew[n].detach().cpu() - new[n].detach()).abs().max()
                     ) <= 1e-4, n
