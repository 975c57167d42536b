"""The port's training substrate against the JAX reference, on the CPU:
the reference's ``tests/test_training.py`` restated (loss descent,
micro-batch equivalence, optimizer options, checkpoint restart, data
determinism, generation, the batcher), plus the learning-rate schedule,
the AdamW update on both sides of the weight-decay rule, one train step
per micro-batch and remat setting, and the checkpoint's on-disk layout.

Parameters are the reference's smollm-360m smoke model in float32
(``init_params(PRNGKey(0))``), carried into the port; updated leaves are
held within the reference's own 1e-4.
"""
import json
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving import greedy_generate as jgenerate
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainStepConfig as JStep
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro.training import cosine_lr as jcosine_lr
from repro.training import make_train_step as jmake_train_step

from repro_torch.checkpoint import Checkpointer, save_checkpoint
from repro_torch.checkpoint.checkpointer import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import Request, RequestBatcher, greedy_generate
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  adamw_update, copy_task_batch, cosine_lr,
                                  make_batch_for, make_train_step,
                                  synthetic_lm_batch)
from repro_torch.training.optimizer import reference_ndim

ARCH = "smollm-360m"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    """(port cfg, port model, reference model, reference params, their
    numpy tree); port parameters come from ``fresh``."""
    jcfg = jget(ARCH, smoke=True).replace(dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    return cfg, build_model(cfg, "cpu"), jm, jp, jax.tree.map(np.asarray, jp)


def fresh(setup):
    """The reference's parameters as a new port parameter module."""
    return setup[1].params_from_reference(setup[4])


def _leaves_close(got, want_tree, model, tol=TOL):
    want = model.params_from_reference(jax.tree.map(np.asarray, want_tree))
    for (n, a), (_, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   err_msg=n, **tol)


@pytest.fixture(scope="module")
def ref_steps(setup):
    """One reference train step (lr 1e-3) at micro-batches 1 and 2 on a
    batch of synthetic tokens: {mb: (tokens, new params, metrics)}."""
    _, _, jm, jp, _ = setup
    toks = np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int32)
    out = {}
    for mb in (1, 2):
        ocfg = JAdamW(lr=1e-3)
        p2, _, met = jax.jit(jmake_train_step(
            jm, ocfg, JStep(microbatches=mb)))(jp, jadamw_init(jp, ocfg),
                                               {"tokens": jnp.asarray(toks)})
        out[mb] = (toks, p2, {k: float(v) for k, v in met.items()})
    return out


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(setup, ref_steps, mb, remat):
    """Loss, grad norm, lr, step and every updated leaf of one step, for
    each micro-batch count and remat setting (remat changes nothing but
    what is recomputed)."""
    cfg, model, *_ = setup
    toks, want, wmet = ref_steps[mb]
    params = fresh(setup)
    ocfg = AdamWConfig(lr=1e-3)
    params, opt, met = make_train_step(model, ocfg, TrainStepConfig(
        microbatches=mb, remat=remat))(params, adamw_init(params, ocfg),
                                       {"tokens": torch.from_numpy(toks)})
    assert abs(float(met["loss"]) - wmet["loss"]) < 1e-4
    assert abs(float(met["grad_norm"]) - wmet["grad_norm"]) \
        < 1e-4 * wmet["grad_norm"]
    assert float(met["lr"]) == pytest.approx(wmet["lr"], rel=1e-6)
    assert int(met["step"]) == int(opt.step) == 1
    _leaves_close(params, want, model)


def test_microbatch_grad_equivalence(setup, ref_steps):
    """mb=4 gives the update of the reference's mb=1 step within 1e-4."""
    cfg, model, *_ = setup
    toks, want, wmet = ref_steps[1]
    params = fresh(setup)
    ocfg = AdamWConfig(lr=1e-3)
    params, _, met = make_train_step(model, ocfg, TrainStepConfig(
        microbatches=4))(params, adamw_init(params, ocfg),
                         {"tokens": torch.from_numpy(toks)})
    assert abs(float(met["loss"]) - wmet["loss"]) < 1e-4
    _leaves_close(params, want, model)


def test_loss_decreases(setup):
    cfg, model, *_ = setup
    params = fresh(setup)
    ocfg = AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=400)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, TrainStepConfig(remat="none"))
    losses = []
    for i in range(60):
        params, opt, met = step(params, opt,
                                copy_task_batch(cfg, 8, 64, i, device="cpu"))
        losses.append(float(met["loss"]))
    early = sum(losses[:10]) / 10
    late = sum(losses[-10:]) / 10
    assert late < early - 0.05, (early, late)
    assert all(np.isfinite(losses))


# ------------------------------------------------------------ optimizer
def test_cosine_lr_matches_reference():
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    steps = np.arange(0, 12_001, 7, dtype=np.int32)
    want = np.asarray(jcosine_lr(JAdamW(lr=3e-4, warmup_steps=100,
                                        total_steps=10_000),
                                 jnp.asarray(steps)))
    got = cosine_lr(ocfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
    assert float(cosine_lr(ocfg, 0)) == 0.0


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compression", ["none", "bf16_ef"])
def test_adamw_update_matches_reference(setup, compression, state_dtype):
    """Two updates from random gradients, every leaf and the state
    against the reference's: weight decay on every block leaf (stacked
    in the reference, so rank >= 2 there) and on ``embed``, not on
    ``final_norm``; lr 1e-2, so a missed decay would show at 1e-3."""
    cfg, model, _, jp, tree = setup
    kw = dict(lr=1e-2, warmup_steps=0, grad_compression=compression,
              state_dtype=state_dtype)
    rng = np.random.default_rng(4)
    jgrads = [jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), tree)
        for _ in range(2)]
    jparams, jstate = jp, jadamw_init(jp, JAdamW(**kw))
    params = fresh(setup)
    state = adamw_init(params, AdamWConfig(**kw))
    for g in jgrads:
        jparams, jstate, jlr = jadamw_update(g, jstate, jparams,
                                             JAdamW(**kw))
        grads = dict(model.params_from_reference(
            jax.tree.map(np.asarray, g)).named_parameters())
        params, state, lr = adamw_update(
            {n: t.detach() for n, t in grads.items()}, state, params,
            AdamWConfig(**kw))
    assert float(lr) == pytest.approx(float(jlr), rel=1e-6)
    assert int(state.step) == 2
    _leaves_close(params, jparams, model, dict(atol=1e-6, rtol=1e-5))
    assert all(m.dtype == getattr(torch, state_dtype)
               for m in state.m.values())
    # bfloat16 state may round one ulp (2**-8 relative) apart
    for name, sub in (("m", jstate.m), ("v", jstate.v)) + (
            (("ef", jstate.ef),) if compression == "bf16_ef" else ()):
        want = model.params_from_reference(jax.tree.map(
            lambda a: np.asarray(a, np.float32), sub))
        for n, w in want.named_parameters():
            np.testing.assert_allclose(
                getattr(state, name)[n].float().numpy(),
                w.detach().numpy(), atol=1e-6, err_msg=name + n,
                rtol=8e-3 if state_dtype == "bfloat16" and name != "ef"
                else 1e-5)
    assert (state.ef is not None) == (compression == "bf16_ef")


def test_weight_decay_rule_follows_reference_rank(setup):
    """With zero gradients only decay moves a leaf: a block norm (rank 1
    in the port, stacked to rank 2 in the reference) decays, the
    top-level ``final_norm`` (rank 1 in both) does not."""
    cfg, model, _, jp, tree = setup
    kw = dict(lr=1e-2, warmup_steps=0)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, jlr = jadamw_update(zeros, jadamw_init(jp, JAdamW(**kw)), jp,
                                 JAdamW(**kw))
    params = fresh(setup)
    named = dict(params.named_parameters())
    assert reference_ndim("blocks.0.ln1", named["blocks.0.ln1"]) == 2
    assert reference_ndim("final_norm", named["final_norm"]) == 1
    params, _, lr = adamw_update(
        {n: torch.zeros_like(p) for n, p in named.items()},
        adamw_init(params, AdamWConfig(**kw)), params, AdamWConfig(**kw))
    named = dict(params.named_parameters())
    decayed = 1 - float(lr) * 0.1
    np.testing.assert_allclose(named["blocks.0.ln1"].detach().numpy(),
                               np.asarray(jnew["blocks"]["L0"]["ln1"][0]),
                               rtol=1e-7)
    np.testing.assert_allclose(named["blocks.0.ln1"].detach().numpy(),
                               decayed, rtol=1e-7)
    assert torch.equal(named["final_norm"].detach(),
                       torch.ones(cfg.d_model))
    np.testing.assert_array_equal(np.asarray(jnew["final_norm"]),
                                  np.ones(cfg.d_model, np.float32))


def test_grad_compression_error_feedback(setup):
    """bf16+EF compression still trains (loss decreases) and the error
    buffers are populated."""
    cfg, model, *_ = setup
    params = fresh(setup)
    ocfg = AdamWConfig(lr=2e-3, grad_compression="bf16_ef")
    opt = adamw_init(params, ocfg)
    assert opt.ef is not None
    step = make_train_step(model, ocfg, TrainStepConfig(remat="none"))
    l0 = None
    for i in range(25):
        params, opt, met = step(params, opt,
                                copy_task_batch(cfg, 8, 64, i, device="cpu"))
        if l0 is None:
            l0 = float(met["loss"])
    assert float(met["loss"]) < l0
    assert max(float(e.abs().max()) for e in opt.ef.values()) > 0


def test_bf16_optimizer_state(setup):
    opt = adamw_init(fresh(setup), AdamWConfig(state_dtype="bfloat16"))
    assert all(t.dtype == torch.bfloat16 for t in opt.m.values())
    assert all(t.dtype == torch.bfloat16 for t in opt.v.values())


# ------------------------------------------------------------ checkpoint
def test_checkpoint_restart_exact(setup, tmp_path):
    """Kill-and-restart: the resumed run reproduces the uninterrupted run
    exactly, every parameter and optimizer leaf (deterministic data keyed
    by step + checkpoint round trip)."""
    cfg, model, *_ = setup
    ocfg = AdamWConfig(lr=1e-3)
    step = make_train_step(model, ocfg, TrainStepConfig(remat="none"))
    batch = lambda i: copy_task_batch(cfg, 4, 32, i, device="cpu")

    p = fresh(setup)
    o = adamw_init(p, ocfg)
    for i in range(6):
        p, o, _ = step(p, o, batch(i))

    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    p2 = fresh(setup)
    o2 = adamw_init(p2, ocfg)
    for i in range(3):
        p2, o2, _ = step(p2, o2, batch(i))
    ck.save(3, {"params": p2, "opt": o2})             # async
    p3 = fresh(setup)                                  # a new process's
    restored, mani = ck.restore({"params": p3, "opt": adamw_init(p3, ocfg)})
    assert mani["step"] == 3
    p3, o3 = restored["params"], restored["opt"]
    for i in range(3, 6):
        p3, o3, _ = step(p3, o3, batch(i))
    for (n, a), (_, b) in zip(p.named_parameters(), p3.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=0, rtol=0, err_msg=n)
    for n in o.m:
        assert torch.equal(o.m[n], o3.m[n]) and torch.equal(o.v[n], o3.v[n])
    assert int(o3.step) == int(o.step) == 6


def test_checkpoint_retention(tmp_path):
    ck = Checkpointer(str(tmp_path / "r"), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones((4,)) * s}, blocking=True)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path / "r")))
    assert steps == [3, 4]


class _State(NamedTuple):
    step: object
    m: dict
    ef: Optional[dict]


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same tree saved by both packages: the same files, manifests
    and bytes (float32 and int32 leaves, a NamedTuple with a None
    field); the port restores the reference's checkpoint."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.integers(-5, 5, (2,)).astype(np.int32)
    tree = lambda to: {"w": {"a": to(a), "b": to(b)},
                       "opt": _State(step=to(np.int32(7)), m={"a": to(a)},
                                     ef=None)}
    jsave(str(tmp_path / "ref"), 5, tree(jnp.asarray), {"k": 1})
    save_checkpoint(str(tmp_path / "port"), 5, tree(torch.tensor), {"k": 1})
    ref, port = tmp_path / "ref" / "step_5", tmp_path / "port" / "step_5"
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port))
    assert json.loads((ref / "manifest.json").read_text()) == json.loads(
        (port / "manifest.json").read_text())
    for f in os.listdir(ref):
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(ref / f), np.load(port / f))
    got, mani = restore_checkpoint(str(tmp_path / "ref"),
                                   tree(torch.tensor))
    assert mani["metadata"] == {"k": 1}
    assert torch.equal(got["w"]["a"], torch.from_numpy(a))
    assert int(got["opt"].step) == 7 and got["opt"].ef is None


def test_checkpoint_bf16_leaves_bit_exact(tmp_path):
    """bfloat16 leaves (parameters and optimizer state) go to disk as
    their uint16 bits and come back bit for bit, on the skeleton's
    device and type."""
    cfg = get_config(ARCH, smoke=True)               # bf16 parameters
    model = build_model(cfg, "cpu")
    params = model.init_params(seed=3)
    opt = adamw_init(params, AdamWConfig(state_dtype="bfloat16"))
    for t in opt.m.values():
        t.copy_(torch.randn(t.shape, dtype=torch.float32))
    ck = Checkpointer(str(tmp_path / "bf"))
    ck.save(1, {"params": params, "opt": opt}, blocking=True)
    mani = json.loads((tmp_path / "bf" / "step_1" /
                       "manifest.json").read_text())
    assert mani["leaves"]["params__embed"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "bf" / "step_1" /
                   "params__embed.npy").dtype == np.uint16
    other = model.init_params(seed=4)
    restored, _ = ck.restore({"params": other,
                              "opt": adamw_init(other, AdamWConfig(
                                  state_dtype="bfloat16"))})
    for (n, a), (_, b) in zip(params.named_parameters(),
                              restored["params"].named_parameters()):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    for n, t in opt.m.items():
        assert torch.equal(t.view(torch.int16),
                           restored["opt"].m[n].view(torch.int16)), n


# ------------------------------------------------------------ data
def test_data_determinism(setup):
    cfg = setup[0]
    a = synthetic_lm_batch(cfg, 4, 16, step=7, device="cpu")
    b = synthetic_lm_batch(cfg, 4, 16, step=7, device="cpu")
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    c = synthetic_lm_batch(cfg, 4, 16, step=8, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    d = synthetic_lm_batch(cfg, 4, 16, step=7, seed=18, device="cpu")
    assert not torch.equal(a["tokens"], d["tokens"])
    copy = copy_task_batch(cfg, 2, 9, step=7, device="cpu")["tokens"]
    assert torch.equal(copy[:, :4], copy[:, 4:8])
    assert bool((copy[:, :8] >= 2).all()) and bool((copy[:, 8] == 1).all())
    from repro_torch.configs.base import ShapeSpec
    shape = ShapeSpec("t", 16, 4, "train")
    assert torch.equal(make_batch_for(cfg, shape, 7, device="cpu")["tokens"],
                       a["tokens"])
    # the audio family, refused until it was ported, takes frames and
    # decoder tokens of max(s // 8, 8)
    audio = make_batch_for(get_config("whisper-medium", smoke=True), shape,
                           7, device="cpu")
    assert audio["frames"].shape == (4, 16, 64)
    assert audio["tokens"].shape == (4, 8)


# ------------------------------------------------------------ serving
def test_greedy_generate(setup):
    """Tokens equal to the reference's with the KV cache padded to
    ``max_seq``."""
    cfg, model, jm, jp, _ = setup
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 8)
                                             ).astype(np.int32)
    want = np.asarray(jgenerate(jm, jp, {"tokens": jnp.asarray(toks)},
                                max_new_tokens=5, max_seq=16))
    out = greedy_generate(model, fresh(setup),
                          {"tokens": torch.from_numpy(toks)},
                          max_new_tokens=5, max_seq=16)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())
    np.testing.assert_array_equal(out.numpy(), want)


def test_request_batcher():
    rb = RequestBatcher(n_slots=2)
    for i in range(4):
        rb.submit(Request(id=str(i), prompt=[1, 2], max_new_tokens=2))
    admitted = rb.admit()
    assert len(admitted) == 2
    rb.record_tokens({0: 5, 1: 6})
    rb.record_tokens({0: 5, 1: 6})      # both complete (2 tokens each)
    assert len(rb.completed) == 2
    admitted = rb.admit()               # refill from queue
    assert len(admitted) == 2
    rb.record_tokens({0: 1, 1: 1})
    rb.record_tokens({0: 1, 1: 1})
    assert rb.idle
