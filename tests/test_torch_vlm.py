"""The port's vlm family (internvl2-76b: a dense decoder with early-fused
patch embeddings) against the JAX reference, on the CPU.

Weights are the reference's ``init_params`` of the internvl2-76b smoke
config in float32 (4 layers, 16 patches), carried into the port with
``Model.params_from_reference``; patches and token ids come from a numpy
seed.  Tolerances are the reference's own (``tests/test_models.py``):
1e-4 for train and prefill logits and caches, 5e-4 for decode against
teacher forcing; greedy tokens must be equal.  One train step is held to
1e-5 in the loss, 1e-4 of each leaf's largest grad, and 1e-5 in every
parameter after AdamW.

The reference's ``greedy_generate`` leaves the patches out of its
default ``max_seq`` (a quirk, tested as one), so the port is held
against it at an explicit ``max_seq``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving import greedy_generate as jgenerate
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainStepConfig as JStep
from repro.training import adamw_init as jadamw_init
from repro.training import make_loss_fn as jmake_loss_fn
from repro.training import make_train_step as jmake_train_step

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.params import count_params
from repro_torch.serving import Request, RequestBatcher, greedy_generate
from repro_torch.serving.serve_step import pad_kv
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  make_batch_for, make_train_step)
from repro_torch.training.train_step import make_grad_fn

ARCH = "internvl2-76b"
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def ref():
    """(reference model with a jitted ``apply``, its params, their numpy
    tree, port model, port params) of the float32 smoke config."""
    jm = jbuild(jget(ARCH, smoke=True).replace(dtype="float32"))
    jm.apply = jax.jit(jm.apply, static_argnames=("mode", "remat"))
    jp = jm.init_params(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    model = build_model(get_config(ARCH, smoke=True).replace(
        dtype="float32"), "cpu")
    return jm, jp, tree, model, model.params_from_reference(tree)


def _inputs(b, s, cfg, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.vision_patches, cfg.d_model))
            .astype(np.float32),
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))


def _jbatch(patches, toks):
    return {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks)}


def _batch(patches, toks):
    return {"patches": torch.from_numpy(patches),
            "tokens": torch.from_numpy(toks)}


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _ref_pad(cache, s_total):
    blocks = {}
    for name, sub in cache["blocks"].items():
        blocks[name] = {k: jnp.pad(v, [(0, 0), (0, 0), (0, s_total
                                                        - v.shape[2])]
                                   + [(0, 0)] * (v.ndim - 3))
                        for k, v in sub.items()}
    return {"blocks": blocks, "index": cache["index"]}


# ---------------------------------------------------------------- model
def test_train_logits_match_reference(ref):
    """Logits over the patch positions and the tokens, [B, P + S, V]."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    patches, toks = _inputs(2, 20, cfg)
    want, _ = jm.apply(jp, _jbatch(patches, toks), mode="train")
    with torch.no_grad():
        got, cache = model.apply(params, _batch(patches, toks))
    assert cache is None
    assert got.shape == (2, cfg.vision_patches + 20, cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_reference(ref):
    """A prefill of the patches and 12 tokens: logits, KV cache and an
    ``index`` of P + S against the reference's; then 4 decode steps
    against the reference's decode and the port's own teacher forcing."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    p = cfg.vision_patches
    b, s, sp = 2, 16, 12
    patches, toks = _inputs(b, s, cfg, seed=4)
    full, _ = jm.apply(jp, _jbatch(patches, toks), mode="train",
                       remat="none")
    jpre, jcache = jm.apply(jp, _jbatch(patches, toks[:, :sp]),
                            mode="prefill", remat="none")
    with torch.no_grad():
        tfull, _ = model.apply(params, _batch(patches, toks))
        pre, cache = model.apply(params, _batch(patches, toks[:, :sp]),
                                 mode="prefill")
        _close(tfull, full)
        _close(pre, jpre)
        for i, blk in enumerate(cache["blocks"]):
            for name in ("k", "v"):
                _close(blk[name], jcache["blocks"]["L0"][name][i])
        assert cache["index"].tolist() == [p + sp] * b
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(jcache["index"]))
        cache, jcache = pad_kv(cache, p + s), _ref_pad(jcache, p + s)
        for t in range(sp, s):
            tok = toks[:, t:t + 1]
            jl, jcache = jm.apply(jp, {"tokens": jnp.asarray(tok)},
                                  mode="decode", cache=jcache, remat="none")
            tl, cache = model.apply(params, {"tokens": torch.from_numpy(tok)},
                                    mode="decode", cache=cache)
            _close(tl, jl)
            _close(tl[:, 0], tfull[:, p + t], DECODE_TOL)
    assert cache["index"].tolist() == [p + s] * b


def test_greedy_generate_matches_reference(ref):
    """Tokens equal to the reference's at an explicit ``max_seq``; the
    port's default ``max_seq`` (patches counted) gives the same tokens."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    patches, toks = _inputs(3, 8, cfg, seed=6)
    want = jgenerate(jm, jp, _jbatch(patches, toks), 20, max_seq=64)
    for max_seq in (64, None):
        got = greedy_generate(model, params, _batch(patches, toks), 20,
                              max_seq=max_seq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_greedy_generate_default_max_seq_leaves_out_patches(ref):
    """Reference quirk: its default ``max_seq`` is prompt + new tokens,
    without the patches.  With 8 prompt tokens and 20 new ones it pads
    the cache to 28 rows where 43 are needed, and its tokens part from
    its own at ``max_seq`` 64; with fewer new tokens than patches its pad
    width is negative and it raises.  The port's default counts the
    patches (the test above)."""
    jm, jp, _, model, _ = ref
    cfg = model.cfg
    patches, toks = _inputs(3, 8, cfg, seed=6)
    short = np.asarray(jgenerate(jm, jp, _jbatch(patches, toks), 20))
    right = np.asarray(jgenerate(jm, jp, _jbatch(patches, toks), 20,
                                 max_seq=64))
    assert (short != right).any()
    with pytest.raises(ValueError, match="negative"):
        jgenerate(jm, jp, _jbatch(patches, toks), cfg.vision_patches - 1)


@pytest.mark.parametrize("capacity", [None, 16.0],
                         ids=["own-capacity-drops", "no-drops"])
def test_moe_with_patches_runs_as_the_reference(ref, capacity):
    """Any decoder-only family takes patch embeddings, as in the
    reference: a qwen3-moe smoke model with 4 patches, train logits
    within 1e-4.  At the config's own capacity factor (1.25) slots drop,
    so the logits move away from a capacity of 16, where none drop."""
    over = dict(dtype="float32", vision_patches=4)
    if capacity is not None:
        over["capacity_factor"] = capacity
    cfg = jget("qwen3-moe-30b-a3b", smoke=True).replace(**over)
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(3))
    model = build_model(get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        **over), "cpu")
    params = model.params_from_reference(jax.tree.map(np.asarray, jp))
    patches, toks = _inputs(2, 12, model.cfg, seed=7)
    want, _ = jm.apply(jp, _jbatch(patches, toks), mode="train")
    with torch.no_grad():
        got, _ = model.apply(params, _batch(patches, toks))
    assert got.shape[1] == 16
    _close(got, want)
    if capacity is None:
        loose, _ = jbuild(cfg.replace(capacity_factor=16.0)).apply(
            jp, _jbatch(patches, toks), mode="train")
        assert np.abs(np.asarray(loose) - np.asarray(want)).max() > 1e-2


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_count_params(smoke):
    """The port's tree (meta tensors) has the reference tree's element
    count, in Python integers, equal to ``cfg.param_count()``."""
    model = build_model(get_config(ARCH, smoke=smoke), "cpu")
    shapes = model.param_shapes()
    ref_shapes = jbuild(jget(ARCH, smoke=smoke)).param_shapes()
    n = count_params(shapes)
    assert isinstance(n, int)
    assert n == sum(int(np.prod(x.shape, dtype=np.int64))
                    for x in jax.tree.leaves(ref_shapes))
    assert n == model.cfg.param_count()
    if not smoke:
        assert n == 70_553_706_496


# ---------------------------------------------------------------- training
def test_train_step_matches_reference(ref):
    """One step (lr 1e-3, 2 micro-batches) on ``make_batch_for``'s vlm
    shapes, the loss over the token positions only: loss within 1e-5,
    each leaf's grad within 1e-4 of its largest |g|, and every parameter
    after AdamW within 1e-5."""
    jm, jp, tree, model, _ = ref
    patches, toks = _inputs(4, 16, model.cfg, seed=8)
    jbatch, batch = _jbatch(patches, toks), _batch(patches, toks)
    tcfg, jtcfg = TrainStepConfig(microbatches=2), JStep(microbatches=2)
    (jloss, _), jgrads = jax.value_and_grad(jmake_loss_fn(jm, JStep()),
                                            has_aux=True)(jp, jbatch)
    jcfg = JAdamW(lr=1e-3)
    jp2, _, jmet = jax.jit(jmake_train_step(jm, jcfg, jtcfg))(
        jp, jadamw_init(jp, jcfg), jbatch)

    params = model.params_from_reference(tree)
    grads, loss = make_grad_fn(model, TrainStepConfig())(params, batch)
    assert abs(float(loss) - float(jloss)) < 1e-5
    want = dict(model.params_from_reference(
        jax.tree.map(np.asarray, jgrads)).named_parameters())
    for n, g in grads.items():
        w = want[n].detach()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n

    ocfg = AdamWConfig(lr=1e-3)
    params, opt, met = make_train_step(model, ocfg, tcfg)(
        params, adamw_init(params, ocfg), batch)
    assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-5
    assert int(opt.step) == 1
    want = model.params_from_reference(jax.tree.map(np.asarray, jp2))
    for (n, got), (_, w) in zip(params.named_parameters(),
                                want.named_parameters()):
        _close(got, w.detach(), dict(atol=1e-5, rtol=0))


def test_make_batch_for_vlm():
    """Tokens ``[b, s - P]`` and patches ``[b, P, d]`` in the model's type;
    a pure function of ``(seed, step)``."""
    cfg = get_config(ARCH, smoke=True)
    p = cfg.vision_patches
    shape = ShapeSpec("t", 48, 2, "train")
    a = make_batch_for(cfg, shape, 3, task="copy", device="cpu")
    assert set(a) == {"tokens", "patches"}
    assert a["tokens"].shape == (2, 48 - p)
    assert a["tokens"].dtype == torch.int32
    assert a["patches"].shape == (2, p, cfg.d_model)
    assert a["patches"].dtype == torch.bfloat16
    b = make_batch_for(cfg, shape, 3, task="copy", device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    for other in (dict(step=4), dict(step=3, seed=3)):
        c = make_batch_for(cfg, shape, task="copy", device="cpu", **other)
        assert not torch.equal(a["patches"], c["patches"])
        assert not torch.equal(a["tokens"], c["tokens"])
    full = make_batch_for(get_config(ARCH), ShapeSpec("t", 512, 1, "train"),
                          0, device="cpu")
    assert full["tokens"].shape == (1, 256)
    assert full["patches"].shape == (1, 256, 8192)


# ---------------------------------------------------------------- serving
def test_serve_loop_gives_each_request_its_greedy_tokens(ref):
    """7 requests, each with its own patches, through 3 reused slots:
    each request's tokens equal ``greedy_generate`` of its patches and
    prompt alone; the ``max_seq`` check counts the patches."""
    model, params = ref[3], ref[4]
    cfg = model.cfg
    p = cfg.vision_patches
    rng = np.random.default_rng(9)
    rb, inputs = RequestBatcher(3), {}
    lengths, news = (5, 1, 9, 3, 7, 2, 4), (6, 4, 1, 8, 5, 7, 3)
    for i, (n, k) in enumerate(zip(lengths, news)):
        rb.submit(Request(id=f"r{i}", max_new_tokens=k, prompt=rng.integers(
            2, cfg.vocab_size, n).tolist()))
        inputs[f"r{i}"] = {"patches": torch.from_numpy(rng.standard_normal(
            (1, p, cfg.d_model)).astype(np.float32))}
    max_seq = p + 16
    n_tok, steps = launch_serve.serve_requests(model, params, rb, max_seq,
                                               inputs)
    assert n_tok == sum(news) and len(rb.completed) == len(lengths)
    assert steps < sum(news)
    for req in rb.completed:
        want = greedy_generate(model, params, {
            "tokens": torch.tensor([req.prompt], dtype=torch.int32),
            **inputs[req.id]}, req.max_new_tokens, max_seq=max_seq)
        assert req.generated == want[0].tolist(), req.id

    rb = RequestBatcher(2)
    rb.submit(Request(id="long", prompt=[3] * 10, max_new_tokens=8))
    with pytest.raises(ValueError, match=f"{p} patches .* exceed max_seq"):
        launch_serve.serve_requests(model, params, rb, p + 16,
                                    {"long": inputs["r0"]})


def test_serve_main_prints_reference_line(capsys):
    """The serve launcher on the vlm smoke config: each request gets its
    own patches; the reference's line and the 97 tokens its 8 requests
    ask for."""
    launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    m = re.fullmatch(r"arch=internvl2-76b-smoke: 8 requests, (\d+) tokens, "
                     r"\d+ tok/s", out[-1])
    assert len(out) == 1 and m and int(m.group(1)) == 97
    inputs = launch_serve.request_inputs(get_config(ARCH, smoke=True), 7, 64,
                                         3)
    assert inputs["patches"].shape == (1, 16, 128)


# ---------------------------------------------------------------- launchers
def test_train_main_resumes(tmp_path, capsys):
    """``launch/train.py`` on the smoke config: the reference's first line
    (its parameter count), finite steps, then ``--resume`` from the saved
    step 2 to step 4."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", ARCH, "--batch", "2", "--seq", "32", "--ckpt-dir", ck,
            "--device", "cpu"]
    launch_train.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    jcfg = jget(ARCH, smoke=True)
    assert out[0] == (f"arch={jcfg.name} params={jcfg.param_count()/1e6:.1f}M"
                      " batch=2 seq=32")
    for i, line in zip((0, 1), out[1:3]):
        m = re.fullmatch(rf"step {i:4d} loss (\d+\.\d{{4}}) lr \S+", line)
        assert m and np.isfinite(float(m.group(1))), line
    launch_train.main(argv + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[1] == "resumed from step 2"
    assert re.fullmatch(r"step    3 loss \d+\.\d{4} lr \S+", out[2])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_2", "step_4"]
