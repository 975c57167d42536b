"""The port's falcon-mamba-7b serving path against the JAX reference.

Weights are made by the reference (``init_params``) and carried into the
port with ``Model.params_from_reference``; token ids come from a numpy
seed.  Everything runs in float32 on the CPU, where the port's scan is
its plain version and the reference's is the Pallas kernel in interpret
mode (``REPRO_KERNELS=interpret``, ``conftest.py``).  Logits, outputs
and caches are held within 1e-4 (the reference's own prefill tolerance,
``test_models.py``); greedy tokens must be equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counters, ops
from repro_torch.models import build_model
from repro_torch.models.mamba import MambaCache, mamba_mixer
from repro_torch.serving import (Request, RequestBatcher, greedy_generate,
                                 make_decode_step, make_prefill_step)

ARCH = "falcon-mamba-7b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke model in float32, its parameters, and the
    port's model on the CPU with those parameters carried across."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models.mamba import MambaCache as JCache
    from repro.models.mamba import mamba_mixer as jmixer
    from repro.serving import greedy_generate as jgenerate

    cfg = jget(ARCH, smoke=True).replace(dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    model = build_model(get_config(ARCH, smoke=True).replace(
        dtype="float32"), "cpu")

    class R:
        pass
    r = R()
    r.jnp, r.jm, r.jp, r.tree, r.cfg = jnp, jm, jp, tree, cfg
    r.JCache, r.jmixer, r.jgenerate = JCache, jmixer, jgenerate
    r.model, r.params = model, model.params_from_reference(tree)
    return r


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _stack_cache(cache):
    """The port's per-layer cache in the reference's stacked layout."""
    return {k: torch.stack([blk[k] for blk in cache["blocks"]]).detach()
            .numpy()
            for k in ("conv", "ssm")}


# ---------------------------------------------------------------- mixer
@pytest.mark.parametrize("t", [2, 16])
def test_mamba_mixer_prefill_and_decode_match_reference(ref, t):
    """Prefill (T = 2 is shorter than the conv window) and one decode step
    against the reference's mixer, on layer 0's weights."""
    cfg, jnp = ref.cfg, ref.jnp
    kw = dict(ssm_state=cfg.ssm_state, conv_width=cfg.conv_width,
              dt_rank=cfg.dtr)
    jpl = {k: v[0] for k, v in ref.jp["blocks"]["L0"].items()}
    tpl = dict(ref.params.blocks[0].named_parameters())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    jout, jc = ref.jmixer(jnp.asarray(x), jpl, cache=None,
                          return_cache=True, **kw)
    out, c = mamba_mixer(torch.from_numpy(x), tpl, cache=None,
                         return_cache=True, **kw)
    _close(out, jout)
    _close(c.conv, jc.conv)
    _close(c.ssm, jc.ssm)

    jout, jc = ref.jmixer(jnp.asarray(x1), jpl, cache=jc, **kw)
    out, c = mamba_mixer(torch.from_numpy(x1), tpl, cache=c, **kw)
    assert isinstance(c, MambaCache)
    _close(out, jout)
    _close(c.conv, jc.conv)
    _close(c.ssm, jc.ssm)


# ---------------------------------------------------------------- model
def test_smoke_model_train_prefill_decode_match_reference(ref):
    jnp, cfg = ref.jnp, ref.cfg
    b, s, sp = 2, 32, 28
    toks = _tokens(b, s, cfg.vocab_size)
    full, _ = ref.jm.apply(ref.jp, {"tokens": jnp.asarray(toks)},
                           mode="train", remat="none")
    tfull, none = ref.model.apply(ref.params,
                                  {"tokens": torch.from_numpy(toks)})
    assert none is None
    _close(tfull, full)

    jpre, jcache = ref.jm.apply(ref.jp, {"tokens": jnp.asarray(toks[:, :sp])},
                                mode="prefill", remat="none")
    before = ops.launch_stats().get("selective_scan", 0)
    pre, cache = ref.model.apply(ref.params,
                                 {"tokens": torch.from_numpy(toks[:, :sp])},
                                 mode="prefill")
    assert ops.launch_stats()["selective_scan"] - before == cfg.n_layers
    _close(pre, jpre)
    got = _stack_cache(cache)
    for k in ("conv", "ssm"):
        _close(got[k], jcache["blocks"]["L0"][k])
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(jcache["index"]))

    for t in range(sp, s):
        jl, jcache = ref.jm.apply(
            ref.jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            mode="decode", cache=jcache, remat="none")
        tl, cache = ref.model.apply(
            ref.params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            mode="decode", cache=cache)
        _close(tl, jl)
        _close(tl[:, 0], full[:, t])
    assert cache["index"].tolist() == [s] * b


@pytest.mark.parametrize("sp", [4, 16])
def test_greedy_generate_matches_reference(ref, sp):
    toks = _tokens(3, sp, ref.cfg.vocab_size, seed=sp)
    want = np.asarray(ref.jgenerate(ref.jm, ref.jp,
                                    {"tokens": ref.jnp.asarray(toks)}, 6))
    got = greedy_generate(ref.model, ref.params,
                          {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_at_prompt_length_conv_width_minus_one(ref):
    """A 3-token prompt (conv_width - 1), where the reference's cache
    padding breaks decode: the port's one prefill must agree with feeding
    the prompt token by token through decode from an empty cache, whose
    logits match the reference's train-mode forward."""
    model, params, cfg = ref.model, ref.params, ref.cfg
    sp, n_new = cfg.conv_width - 1, 5
    toks = _tokens(2, sp, cfg.vocab_size, seed=5)
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(toks)},
                          n_new)

    full, _ = ref.jm.apply(ref.jp, {"tokens": ref.jnp.asarray(toks)},
                           mode="train", remat="none")
    cache = model.init_cache(2)
    for t in range(sp):
        logits, cache = model.apply(
            params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            mode="decode", cache=cache)
        _close(logits[:, 0], full[:, t])
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    decode = make_decode_step(model)
    want = [tok]
    for _ in range(n_new - 1):
        tok, cache = decode(params, tok, cache)
        want.append(tok)
    assert torch.equal(got, torch.cat(want, dim=1))


def test_batcher_serves_requests_through_greedy_generate(ref):
    """8 requests of two prompt lengths through 4 slots, as
    ``chip_smoke.py`` serves them on the card; one prefill per batch."""
    model, params, vocab = ref.model, ref.params, ref.cfg.vocab_size
    batcher = RequestBatcher(n_slots=4)
    for i in range(8):
        prompt = _tokens(1, 5 if i < 4 else 3, vocab, seed=10 + i)[0]
        batcher.submit(Request(id=str(i), prompt=prompt.tolist(),
                               max_new_tokens=4))
    prefill = make_prefill_step(model)
    before = ops.launch_stats().get("selective_scan", 0)
    batches = 0
    while not batcher.idle:
        admitted = batcher.admit()
        prompts = torch.tensor([r.prompt for r in admitted],
                               dtype=torch.int32)
        out = greedy_generate(model, params, {"tokens": prompts}, 4)
        first, _ = prefill(params, {"tokens": prompts})
        assert torch.equal(out[:, 0], torch.argmax(first, -1).to(torch.int32))
        for step in range(out.shape[1]):
            batcher.record_tokens({r.slot: int(out[k, step])
                                   for k, r in enumerate(admitted)})
        batches += 1
    assert batches == 2
    assert ops.launch_stats()["selective_scan"] - before \
        == 2 * batches * ref.cfg.n_layers
    assert sorted(r.id for r in batcher.completed) == [str(i)
                                                       for i in range(8)]
    assert all(len(r.generated) == 4 for r in batcher.completed)


# ---------------------------------------------------------------- weights
def test_params_from_reference_uses_every_leaf_exactly_once(ref):
    model, tree = ref.model, ref.tree
    params = model.params_from_reference(tree)
    got = dict(params.named_parameters())
    n_ref = sum(a.size for a in (tree["embed"], tree["final_norm"]))
    n_ref += sum(a.size for a in tree["blocks"]["L0"].values())
    assert sum(p.numel() for p in got.values()) == n_ref
    np.testing.assert_array_equal(got["embed"].detach().numpy(),
                                  tree["embed"])
    for name, arr in tree["blocks"]["L0"].items():
        for i in range(arr.shape[0]):
            np.testing.assert_array_equal(
                got[f"blocks.{i}.{name}"].detach().numpy(), arr[i])

    extra = dict(tree, lm_head=tree["embed"].T)
    with pytest.raises(ValueError, match="not used: lm_head"):
        model.params_from_reference(extra)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        model.params_from_reference(missing)
    blocks = {k: v for k, v in tree["blocks"]["L0"].items()}
    blocks["D"] = np.concatenate([blocks["D"], blocks["D"][:1]])
    with pytest.raises(ValueError, match="not used: blocks/L0/D"):
        model.params_from_reference(dict(tree, blocks={"L0": blocks}))
    blocks["D"] = blocks["D"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        model.params_from_reference(dict(tree, blocks={"L0": blocks}))


def test_init_params_follows_reference_rules():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    p1 = dict(model.init_params(0).named_parameters())
    p2 = dict(model.init_params(0).named_parameters())
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    blk = "blocks.0."
    assert p1[blk + "in_proj"].dtype == torch.bfloat16
    assert p1[blk + "A_log"].dtype == p1[blk + "D"].dtype == torch.float32
    assert torch.equal(p1[blk + "A_log"][5], torch.log(
        torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)))
    assert torch.all(p1[blk + "D"] == 1) and torch.all(p1[blk + "ln1"] == 1)
    assert torch.all(p1[blk + "conv_b"] == 0)
    assert torch.all(p1[blk + "dt_proj_b"] == 0)
    std = p1[blk + "in_proj"].float().std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.1
    assert all(p.requires_grad for p in p1.values())


# ---------------------------------------------------------------- no fallback
def test_without_gpu_the_model_raises():
    cfg = get_config(ARCH, smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda:0")


# Named for the refusal it held until the vlm and audio families were
# ported; each case now runs as the reference runs it: a MoE model with
# patch embeddings (with no slot dropped, and at the config's own
# capacity factor, where slots drop), a hybrid one whose
# ``encoder_layers`` build no encoder outside the audio family, Whisper
# with frames and InternVL2 with patches.  Train logits within 1e-4 of
# the reference's.
@pytest.mark.parametrize("arch,over", [
    ("qwen3-moe-30b-a3b", {"vision_patches": 4, "capacity_factor": 16.0}),
    ("jamba-1.5-large-398b", {"encoder_layers": 2}),
    ("whisper-medium", {}), ("internvl2-76b", {}),
    ("qwen3-moe-30b-a3b", {"vision_patches": 4})],
    ids=["qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "whisper-medium",
         "internvl2-76b", "qwen3-moe-30b-a3b-capacity-drops"])
def test_other_families_raise(arch, over):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    jm = jbuild(jget(arch, smoke=True).replace(dtype="float32", **over))
    jp = jm.init_params(jax.random.PRNGKey(2))
    model = build_model(get_config(arch, smoke=True).replace(
        dtype="float32", **over), "cpu")
    params = model.params_from_reference(jax.tree.map(np.asarray, jp))
    cfg = model.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": _tokens(2, 12, cfg.vocab_size, seed=4)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, 24, cfg.d_model))
    elif cfg.vision_patches:
        batch["patches"] = rng.standard_normal(
            (2, cfg.vision_patches, cfg.d_model))
    batch = {k: v.astype(np.float32 if k != "tokens" else np.int32)
             for k, v in batch.items()}
    want, _ = jm.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = model.apply(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert got.shape == want.shape
    _close(got, want)


def test_cpu_serving_launches_no_cuda_kernel(ref):
    counters.reset_device_launches()
    greedy_generate(ref.model, ref.params,
                    {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 2)
    assert counters.device_launch_stats() == {}
