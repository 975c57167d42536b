"""The port's audio family (whisper-medium's encoder-decoder) against the
JAX reference, on the CPU.

Weights are the reference's ``init_params`` of the whisper-medium smoke
config in float32, carried into the port with
``Model.params_from_reference``; frames and token ids come from a numpy
seed.  Tolerances are the reference's own (``tests/test_models.py``):
1e-4 for train and prefill logits and caches, 5e-4 for decode against
teacher forcing; greedy tokens must be equal.  One train step is held to
1e-5 in the loss, 1e-4 of each leaf's largest grad, and 1e-5 in every
parameter after AdamW.

The reference's two audio quirks are tested as quirks: its
``greedy_generate`` zero-pads the cross-attention rows whenever the
frames number the prompt's tokens, and its serve launcher never runs
the encoder.  The port is held against the reference only where the
reference is right.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jlaunch_serve
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
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
from repro_torch.models import build_model, encdec
from repro_torch.models.model_factory import WHISPER_CROSS_FRAMES
from repro_torch.models.params import count_params
from repro_torch.serving import Request, RequestBatcher, greedy_generate
from repro_torch.serving.serve_step import make_decode_step, pad_kv
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  make_batch_for, make_train_step)
from repro_torch.training.optimizer import reference_ndim
from repro_torch.training.train_step import make_grad_fn

ARCH = "whisper-medium"
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-4)
CACHE_LEAVES = ("k", "v", "ck", "cv")


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


def _inputs(b, f, s, d, vocab, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, f, d)).astype(np.float32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _stacked(cache, name):
    """Leaf ``name`` of the port's per-layer cache, stacked as the
    reference's."""
    return np.stack([blk[name].numpy() for blk in cache["blocks"]])


def _ref_pad(cache, s_total):
    """The reference's cache with its self-attention rows padded."""
    blocks = dict(cache["blocks"])
    for k in ("k", "v"):
        w = [(0, 0)] * blocks[k].ndim
        w[2] = (0, s_total - blocks[k].shape[2])
        blocks[k] = jnp.pad(blocks[k], w)
    return {"blocks": blocks, "index": cache["index"]}


# ---------------------------------------------------------------- model
def test_sinusoid_matches_reference():
    """Within 1e-4 in float32 (angles up to 447 rad, whose float32 ulp
    is 3e-5: the two libraries' ``pow`` round apart) and a bf16 ulp."""
    for length, d in ((1, 64), (37, 64), (448, 1024)):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = encdec.sinusoid(length, d, dt, "cpu").to(torch.float32)
            want = np.asarray(jencdec.sinusoid(length, d, jdt), np.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       rtol=0 if dt == torch.float32
                                       else 2 ** -7)


def test_train_logits_match_reference(ref):
    jm, jp, _, model, params = ref
    cfg = model.cfg
    frames, toks = _inputs(2, 48, 12, cfg.d_model, cfg.vocab_size)
    want, _ = jm.apply(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, cache = model.apply(params, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks)})
    assert cache is None and got.shape == (2, 12, cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_reference(ref):
    """Prefill logits and every cache leaf (``k``, ``v``, ``ck``, ``cv``,
    ``index``) against the reference's; then decode steps against the
    reference's decode and the port's own teacher forcing."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    b, f, s, sp = 2, 40, 16, 11
    frames, toks = _inputs(b, f, s, cfg.d_model, cfg.vocab_size, seed=4)
    jf = jnp.asarray(frames)
    full, _ = jm.apply(jp, {"frames": jf, "tokens": jnp.asarray(toks)},
                       mode="train", remat="none")
    jpre, jcache = jm.apply(jp, {"frames": jf,
                                 "tokens": jnp.asarray(toks[:, :sp])},
                            mode="prefill", remat="none")
    tf = torch.from_numpy(frames)
    with torch.no_grad():
        tfull, _ = model.apply(params, {"frames": tf,
                                        "tokens": torch.from_numpy(toks)})
        pre, cache = model.apply(
            params, {"frames": tf, "tokens": torch.from_numpy(toks[:, :sp])},
            mode="prefill")
        _close(tfull, full)
        _close(pre, jpre)
        for name in CACHE_LEAVES:
            _close(_stacked(cache, name), jcache["blocks"][name])
        assert cache["blocks"][0]["ck"].shape == (b, f, cfg.n_kv_heads,
                                                  cfg.hd)
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(jcache["index"]))
        cache, jcache = pad_kv(cache, s), _ref_pad(jcache, s)
        for t in range(sp, s):
            tok = toks[:, t:t + 1]
            jl, jcache = jm.apply(jp, {"tokens": jnp.asarray(tok)},
                                  mode="decode", cache=jcache, remat="none")
            tl, cache = model.apply(params, {"tokens": torch.from_numpy(tok)},
                                    mode="decode", cache=cache)
            _close(tl, jl)
            _close(tl[:, 0], tfull[:, t], DECODE_TOL)
        for name in CACHE_LEAVES:
            _close(_stacked(cache, name), jcache["blocks"][name])
    assert cache["index"].tolist() == [s] * b


def test_whisper_decode_consistency(ref):
    """The reference's ``test_whisper_decode_consistency`` restated on the
    port: 2 x 32 frames, 16 tokens, a prefill of 13 and 3 decode steps
    within 5e-4 of the train-mode forward."""
    model, params = ref[3], ref[4]
    cfg = model.cfg
    b, f, s = 2, 32, 16
    frames, toks = _inputs(b, f, s, cfg.d_model, cfg.vocab_size, seed=3)
    frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = model.apply(params, {"frames": frames, "tokens": toks},
                              mode="train", remat="none")
        sp = s - 3
        _, cache = model.apply(params, {"frames": frames,
                                        "tokens": toks[:, :sp]},
                               mode="prefill", remat="none")
        cache = pad_kv(cache, s)
        for t in range(sp, s):
            dl, cache = model.apply(params, {"tokens": toks[:, t:t + 1]},
                                    mode="decode", cache=cache,
                                    remat="none")
            _close(dl[:, 0], full[:, t], DECODE_TOL)


def test_greedy_generate_matches_reference(ref):
    """Tokens equal to the reference's where it is right: 24 frames, a
    prompt of 6 tokens (frames != prompt length), default and explicit
    ``max_seq``."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    frames, toks = _inputs(3, 24, 6, cfg.d_model, cfg.vocab_size, seed=6)
    for max_seq in (None, 32):
        want = jgenerate(jm, jp, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(toks)}, 10,
                         max_seq=max_seq)
        got = greedy_generate(model, params,
                              {"frames": torch.from_numpy(frames),
                               "tokens": torch.from_numpy(toks)}, 10,
                              max_seq=max_seq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_greedy_generate_pads_cross_rows_when_frames_equal_prompt(
        ref):
    """Reference quirk: its pad rule pads every cache leaf whose axis 2
    has the prompt's length, so with 8 frames and an 8-token prompt the
    cross-attention rows ``ck``/``cv`` get zero rows, which the
    unmasked cross-attention attends.  Its tokens then differ from its
    own model decoding against the right cache; the port pads only the
    self-attention rows and gives those tokens."""
    jm, jp, _, model, params = ref
    cfg = model.cfg
    b, f, sp, n_new = 4, 8, 8, 12
    frames, toks = _inputs(b, f, sp, cfg.d_model, cfg.vocab_size, seed=11)
    jf = jnp.asarray(frames)
    quirk = np.asarray(jgenerate(jm, jp, {"frames": jf,
                                          "tokens": jnp.asarray(toks)},
                                 n_new))
    logits, jcache = jm.apply(jp, {"frames": jf, "tokens": jnp.asarray(toks)},
                              mode="prefill", remat="none")
    jcache = _ref_pad(jcache, sp + n_new)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    right = [tok]
    for _ in range(n_new - 1):
        logits, jcache = jm.apply(jp, {"tokens": tok}, mode="decode",
                                  cache=jcache, remat="none")
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        right.append(tok)
    right = np.concatenate([np.asarray(t) for t in right], axis=1)
    got = greedy_generate(model, params, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks)},
                          n_new)
    np.testing.assert_array_equal(got.numpy(), right)
    assert (quirk != right).any()


# ---------------------------------------------------------------- weights
def test_params_from_reference_uses_every_leaf_exactly_once(ref):
    """The stacked ``enc_blocks``/``dec_blocks`` leaves (a leading layer
    axis, no period key) become one module per layer; a leftover row or
    leaf raises."""
    model, tree = ref[3], ref[2]
    got = dict(model.params_from_reference(tree).named_parameters())
    assert sum(p.numel() for p in got.values()) == sum(
        a.size for a in jax.tree.leaves(tree))
    for part in ("enc_blocks", "dec_blocks"):
        for name, arr in tree[part].items():
            for i in range(arr.shape[0]):
                np.testing.assert_array_equal(
                    got[f"{part}.{i}.{name}"].detach().numpy(), arr[i])
    extra = dict(tree["dec_blocks"])
    extra["c_wq"] = np.concatenate([extra["c_wq"], extra["c_wq"][:1]])
    with pytest.raises(ValueError, match="not used: dec_blocks/c_wq"):
        model.params_from_reference(dict(tree, dec_blocks=extra))
    with pytest.raises(KeyError, match="enc_final_norm"):
        model.params_from_reference({k: v for k, v in tree.items()
                                     if k != "enc_final_norm"})


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_count_params(smoke):
    """The port's tree (meta tensors) has the reference tree's element
    count, in Python integers, within 5 % of ``cfg.param_count()`` (which
    leaves out ``enc_final_norm``)."""
    model = build_model(get_config(ARCH, smoke=smoke), "cpu")
    shapes = model.param_shapes()
    assert shapes["dec_blocks"][0]["c_wq"].device.type == "meta"
    ref_shapes = jbuild(jget(ARCH, smoke=smoke)).param_shapes()
    n = count_params(shapes)
    assert isinstance(n, int)
    assert n == sum(int(np.prod(x.shape, dtype=np.int64))
                    for x in jax.tree.leaves(ref_shapes))
    assert n == model.cfg.param_count() + model.cfg.d_model
    if not smoke:
        assert n == 757_877_760


def test_init_params_and_cache():
    """Random weights by the reference's rules (norms one, ``c_wq`` at
    std ``d ** -0.5``); ``init_cache`` holds WHISPER_CROSS_FRAMES cross
    rows by default, in the model's type even with an int8 KV setting."""
    cfg = get_config(ARCH, smoke=True).replace(kv_cache_dtype="int8")
    model = build_model(cfg, "cpu")
    p = dict(model.init_params(0).named_parameters())
    assert torch.equal(p["dec_blocks.1.ln_cross"].detach(),
                       torch.ones(cfg.d_model, dtype=torch.bfloat16))
    std = float(p["dec_blocks.0.c_wq"].detach().float().std())
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.1
    cache = model.init_cache(3, 20)
    blk = cache["blocks"][1]
    assert len(cache["blocks"]) == cfg.n_layers
    assert blk["k"].shape == (3, 20, cfg.n_kv_heads, cfg.hd)
    assert blk["ck"].shape == (3, WHISPER_CROSS_FRAMES, cfg.n_kv_heads,
                               cfg.hd)
    assert {t.dtype for t in blk.values()} == {torch.bfloat16}
    assert model.init_cache(1, 4, n_frames=7)["blocks"][0]["cv"].shape[1] == 7
    with pytest.raises(ValueError, match="max_seq"):
        model.init_cache(1)


# ---------------------------------------------------------------- training
def test_train_step_matches_reference(ref):
    """One step (lr 1e-3, one micro-batch) on ``make_batch_for``'s audio
    shapes: loss within 1e-5, each leaf's grad within 1e-4 of its largest
    |g|, and every parameter after AdamW within 1e-5, the stacked
    leaves' norms decayed as the reference decays its rank-2 leaves."""
    jm, jp, tree, model, _ = ref
    cfg = model.cfg
    frames, toks = _inputs(4, 32, 8, cfg.d_model, cfg.vocab_size, seed=8)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)}
    (jloss, _), jgrads = jax.value_and_grad(jmake_loss_fn(jm, JStep()),
                                            has_aux=True)(jp, jbatch)
    jcfg = JAdamW(lr=1e-3)
    jp2, _, jmet = jax.jit(jmake_train_step(jm, jcfg, JStep()))(
        jp, jadamw_init(jp, jcfg), jbatch)

    params = model.params_from_reference(tree)
    grads, loss = make_grad_fn(model, TrainStepConfig())(params, batch)
    assert abs(float(loss) - float(jloss)) < 1e-5
    want = dict(model.params_from_reference(
        jax.tree.map(np.asarray, jgrads)).named_parameters())
    for n, g in grads.items():
        w = want[n].detach()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n
    assert reference_ndim("enc_blocks.0.ln1", params.enc_blocks[0].ln1) == 2
    assert reference_ndim("enc_final_norm", params.enc_final_norm) == 1

    ocfg = AdamWConfig(lr=1e-3)
    params, opt, met = make_train_step(model, ocfg)(
        params, adamw_init(params, ocfg), batch)
    assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-5
    assert int(opt.step) == 1
    want = model.params_from_reference(jax.tree.map(np.asarray, jp2))
    for (n, got), (_, w) in zip(params.named_parameters(),
                                want.named_parameters()):
        _close(got, w.detach(), dict(atol=1e-5, rtol=0))


def test_make_batch_for_audio():
    """Frames ``[b, s, d]`` in the model's type, decoder tokens ``[b,
    max(s // 8, 8)]``; a pure function of ``(seed, step)``."""
    cfg = get_config(ARCH, smoke=True)
    for s, sd in ((1024, 128), (32, 8)):
        shape = ShapeSpec("t", s, 3, "train")
        a = make_batch_for(cfg, shape, 5, task="copy", device="cpu")
        assert set(a) == {"frames", "tokens"}
        assert a["frames"].shape == (3, s, cfg.d_model)
        assert a["frames"].dtype == torch.bfloat16
        assert a["tokens"].shape == (3, sd)
        assert a["tokens"].dtype == torch.int32
        b = make_batch_for(cfg, shape, 5, task="copy", device="cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        c = make_batch_for(cfg, shape, 6, task="copy", device="cpu")
        assert not torch.equal(a["frames"], c["frames"])
        d = make_batch_for(cfg, shape, 5, seed=18, task="copy", device="cpu")
        assert not torch.equal(a["frames"], d["frames"])
    x = make_batch_for(cfg.replace(dtype="float32"), shape, 5,
                       device="cpu")["frames"]
    assert abs(float(x.std()) - 1) < 0.05


# ---------------------------------------------------------------- serving
def test_serve_loop_gives_each_request_its_greedy_tokens(ref):
    """7 requests, each with its own 20 frames, through 3 reused slots:
    each request's tokens equal ``greedy_generate`` of its frames and
    prompt alone; each prompt is prefilled once, encoder included."""
    model, params = ref[3], ref[4]
    cfg = model.cfg
    rng = np.random.default_rng(9)
    rb, inputs = RequestBatcher(3), {}
    lengths, news = (5, 1, 9, 3, 7, 2, 4), (6, 4, 1, 8, 5, 7, 3)
    for i, (n, k) in enumerate(zip(lengths, news)):
        rb.submit(Request(id=f"r{i}", max_new_tokens=k, prompt=rng.integers(
            2, cfg.vocab_size, n).tolist()))
        inputs[f"r{i}"] = {"frames": torch.from_numpy(rng.standard_normal(
            (1, 20, cfg.d_model)).astype(np.float32))}
    encodes = []
    orig = type(params).encode
    params.encode = lambda *a, **k: encodes.append(1) or orig(params, *a, **k)
    try:
        n_tok, steps = launch_serve.serve_requests(model, params, rb, 16,
                                                   inputs)
    finally:
        del params.encode
    assert n_tok == sum(news) and len(rb.completed) == len(lengths)
    assert len(encodes) == len(lengths) and steps < sum(news)
    for req in rb.completed:
        want = greedy_generate(model, params, {
            "tokens": torch.tensor([req.prompt], dtype=torch.int32),
            **inputs[req.id]}, req.max_new_tokens, max_seq=16)
        assert req.generated == want[0].tolist(), req.id


def test_serve_loop_refuses_frames_of_two_lengths(ref):
    model, params = ref[3], ref[4]
    rb = RequestBatcher(2)
    inputs = {}
    for i, f in enumerate((8, 9)):
        rb.submit(Request(id=f"r{i}", prompt=[3, 4], max_new_tokens=2))
        inputs[f"r{i}"] = {"frames": torch.zeros((1, f, model.cfg.d_model))}
    with pytest.raises(ValueError, match="frames of one length"):
        launch_serve.serve_requests(model, params, rb, 8, inputs)
    with pytest.raises(ValueError, match="frames of one length"):
        launch_serve.serve_requests(model, params, rb, 8)


def test_reference_launcher_never_runs_the_encoder(monkeypatch, capsys):
    """Reference quirk: its serve launcher feeds an audio model decode
    steps alone, against the zero cross-attention cache of
    ``init_cache``, so the encoder never runs.  The port's launcher
    prefills each request with its frames: one encoder pass a request.
    Both print the reference's line for the 97 tokens asked for."""
    calls = []
    orig = jencdec.encode
    monkeypatch.setattr(jencdec, "encode",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH])
    jlaunch_serve.main()
    want = capsys.readouterr().out.strip().splitlines()
    assert calls == []

    encodes = []
    orig_port = encdec.EncDec.encode
    monkeypatch.setattr(encdec.EncDec, "encode", lambda self, *a, **k:
                        encodes.append(1) or orig_port(self, *a, **k))
    launch_serve.main(["--arch", ARCH, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(encodes) == 8
    pattern = r"arch=whisper-medium-smoke: 8 requests, (\d+) tokens, \d+ tok/s"
    for lines in (want, out):
        m = re.fullmatch(pattern, lines[-1])
        assert len(lines) == 1 and m and int(m.group(1)) == 97


def test_decode_step_reads_cross_rows_from_the_cache(ref):
    """Decode needs no frames: it attends the cache's ``ck``/``cv``, and
    a slot whose cross rows change gives other logits."""
    model, params = ref[3], ref[4]
    cfg = model.cfg
    frames, toks = _inputs(1, 12, 4, cfg.d_model, cfg.vocab_size, seed=12)
    with torch.no_grad():
        _, cache = model.apply(params, {"frames": torch.from_numpy(frames),
                                        "tokens": torch.from_numpy(toks)},
                               mode="prefill")
    cache = pad_kv(cache, 8)
    decode = make_decode_step(model)
    tok = torch.tensor([[5]], dtype=torch.int32)
    other = {"blocks": [dict(b, ck=b["ck"] * 2, k=b["k"].clone(),
                             v=b["v"].clone()) for b in cache["blocks"]],
             "index": cache["index"].clone()}
    with torch.no_grad():
        a, _ = model.apply(params, {"tokens": tok}, mode="decode",
                           cache=cache)
        b, _ = model.apply(params, {"tokens": tok}, mode="decode",
                           cache=other)
    assert not torch.allclose(a, b)
    nxt, _ = decode(params, tok, cache)
    assert nxt.shape == (1, 1)


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
