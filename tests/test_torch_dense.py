"""The port's dense, ssm, moe and hybrid models against the JAX
reference, on the CPU.

Weights are made by the reference (``init_params``) and carried into the
port with ``Model.params_from_reference``; token ids come from a numpy
seed.  Everything runs in float32 at the smoke sizes, with the
reference's own tolerances (``tests/test_models.py``): 1e-4 for train and
prefill logits, 5e-4 for decode against teacher forcing, 0.15 relative
for the int8 KV cache.  The reference's Mamba scan runs in Pallas
interpret mode (``conftest.py``).  The moe and hybrid smoke configs
(qwen3-moe, llama4-maverick with its period of 2 and shared expert,
Jamba with its period of 8) run at their capacity factor of 1.25, drops
included, but against teacher forcing, where the reference's own test
lifts capacity to 16 so that no token drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models.params import count_params as jcount
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainStepConfig as JStep
from repro.training import adamw_init as jadamw_init
from repro.training import make_train_step as jmake_train_step

from repro_torch.configs import get_config
from repro_torch.models import build_model, layers
from repro_torch.models.params import count_params
from repro_torch.serving.serve_step import pad_kv
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  make_train_step)

DENSE = ("smollm-360m", "qwen3-1.7b", "granite-34b", "internlm2-20b")
MOE = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
       "jamba-1.5-large-398b")
ARCHS = DENSE + ("falcon-mamba-7b",) + MOE
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, port params) of an arch's
    float32 smoke config, built once per (arch, overrides); the
    reference's ``apply`` is jitted, so each shape compiles once."""
    made = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in made:
            cfg = jget(arch, smoke=True).replace(dtype="float32", **over)
            jm = jbuild(cfg)
            jm.apply = jax.jit(jm.apply, static_argnames=("mode", "remat"))
            jp = jm.init_params(jax.random.PRNGKey(1))
            model = build_model(get_config(arch, smoke=True).replace(
                dtype="float32", **over), "cpu")
            made[key] = (jm, jp, model, model.params_from_reference(
                jax.tree.map(np.asarray, jp)))
        return made[key]
    return get


def _tokens(b, s, vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _ref_pad(cache, s_total):
    """The reference's cache with its KV leaves padded (its own test's
    ``_pad_cache``)."""
    blocks = {}
    for name, sub in cache["blocks"].items():
        blocks[name] = {
            k: jnp.pad(v, [(0, 0), (0, 0), (0, s_total - v.shape[2])]
                       + [(0, 0)] * (v.ndim - 3))
            if k in ("k", "v", "k_scale", "v_scale") else v
            for k, v in sub.items()}
    return {"blocks": blocks, "index": cache["index"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_forward(pair, arch):
    """One train-mode forward per arch: shapes, finite, and equal to the
    reference's logits within 1e-4 (MoE: the same tokens everywhere, so
    every group sends its tokens to the same experts and drops most)."""
    jm, jp, model, params = pair(arch)
    toks = np.ones((2, 64), np.int32)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
    with torch.no_grad():
        got, cache = model.apply(params, {"tokens": torch.from_numpy(toks)})
    assert cache is None
    assert got.shape == (2, 64, model.cfg.vocab_size)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-1.7b", "granite-34b",
                                  "falcon-mamba-7b"] + list(MOE))
def test_prefill_decode_matches_teacher_forcing(pair, arch):
    """Train, prefill and decode logits against the reference's, and
    decode against the port's own teacher forcing (qwen3: qk-norm;
    granite: MQA and the GELU MLP; MoE and hybrid at the reference's
    capacity factor of 16, so no token drops)."""
    over = {"capacity_factor": 16.0} if get_config(arch).n_experts else {}
    jm, jp, model, params = pair(arch, **over)
    b, s, sp = 2, 32, 28
    toks = _tokens(b, s, model.cfg.vocab_size)
    full, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train",
                       remat="none")
    jpre, jcache = jm.apply(jp, {"tokens": jnp.asarray(toks[:, :sp])},
                            mode="prefill", remat="none")
    jcache = _ref_pad(jcache, s)
    with torch.no_grad():
        tfull, _ = model.apply(params, {"tokens": torch.from_numpy(toks)})
        pre, cache = model.apply(
            params, {"tokens": torch.from_numpy(toks[:, :sp])},
            mode="prefill")
        _close(tfull, full)
        _close(pre, jpre)
        _close(pre, tfull[:, :sp])
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(jcache["index"]))
        cache = pad_kv(cache, s)
        for t in range(sp, s):
            step = {"tokens": toks[:, t:t + 1]}
            jl, jcache = jm.apply(jp, {"tokens": jnp.asarray(step["tokens"])},
                                  mode="decode", cache=jcache, remat="none")
            tl, cache = model.apply(
                params, {"tokens": torch.from_numpy(step["tokens"])},
                mode="decode", cache=cache)
            _close(tl, jl)
            _close(tl[:, 0], tfull[:, t], DECODE_TOL)
    assert cache["index"].tolist() == [s] * b


def test_int8_kv_cache_decode_close(pair):
    """qwen3 with the int8 KV cache: decode within the reference's 0.15
    relative error of the float forward, and the cache's leaves equal to
    the reference's but for rounding ties."""
    jm, jp, model, params = pair("qwen3-1.7b", kv_cache_dtype="int8")
    b, s, sp = 2, 32, 28
    toks = _tokens(b, s, model.cfg.vocab_size)
    full, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train",
                       remat="none")
    _, jcache = jm.apply(jp, {"tokens": jnp.asarray(toks[:, :sp])},
                         mode="prefill", remat="none")
    jcache = _ref_pad(jcache, s)
    with torch.no_grad():
        _, cache = model.apply(params,
                               {"tokens": torch.from_numpy(toks[:, :sp])},
                               mode="prefill")
        cache = pad_kv(cache, s)
        assert cache["blocks"][0]["k"].dtype == torch.int8
        assert tuple(cache["blocks"][0]["k_scale"].shape) == (
            b, s, model.cfg.n_kv_heads, 1)
        errs, jerrs = [], []
        for t in range(sp, s):
            tok = toks[:, t:t + 1]
            tl, cache = model.apply(params, {"tokens": torch.from_numpy(tok)},
                                    mode="decode", cache=cache)
            jl, jcache = jm.apply(jp, {"tokens": jnp.asarray(tok)},
                                  mode="decode", cache=jcache, remat="none")
            errs.append(float(np.abs(tl[:, 0].numpy() - full[:, t]).max()))
            jerrs.append(float(jnp.max(jnp.abs(jl[:, 0] - full[:, t]))))
    rel = max(errs) / float(jnp.std(full))
    assert rel < 0.15, f"int8 KV relative error too high: {rel}"
    for layer, blk in enumerate(cache["blocks"]):
        for name in ("k", "v"):
            got = blk[name].numpy().astype(np.int32)
            want = np.asarray(jcache["blocks"]["L0"][name][layer]).astype(
                np.int32)
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() < 1e-3
        for name in ("k_scale", "v_scale"):
            _close(blk[name], jcache["blocks"]["L0"][name][layer])
    assert max(errs) <= 2 * max(jerrs) + 1e-4


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_count_analytic_vs_actual(smoke):
    """The port's parameter tree (meta tensors) has exactly the element
    count of the reference's tree, within 5 % of the analytic count.  (The
    reference's ``count_params`` multiplies in int32, which wraps past
    2**31 at full size, so its tree is counted here in int64.)"""
    for arch in ARCHS:
        model = build_model(get_config(arch, smoke=smoke), "cpu")
        shapes = model.param_shapes()
        assert shapes["embed"].device.type == "meta"
        actual = count_params(shapes)
        ref = jbuild(jget(arch, smoke=smoke)).param_shapes()
        assert actual == sum(int(np.prod(leaf.shape, dtype=np.int64))
                             for leaf in jax.tree.leaves(ref)), arch
        if smoke:
            assert actual == jcount(ref), arch
        analytic = model.cfg.param_count()
        assert abs(actual - analytic) / analytic < 0.05, arch


def test_chunked_attention_at_1024():
    """Sq 1024 runs as two 512-query chunks against the full K/V, GQA with
    2 query heads per KV head, equal to the reference's; Sq 1000 is
    refused by both."""
    rng = np.random.default_rng(5)
    b, s, h, kv, d = 2, 1024, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kv, kv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = jlayers.attention(*map(jnp.asarray, (q, k, v, pos, pos)))
    got = layers.attention(*map(torch.from_numpy, (q, k, v)),
                           torch.from_numpy(pos.copy()),
                           torch.from_numpy(pos.copy()))
    _close(got, want, dict(atol=1e-5, rtol=1e-5))
    cut = [x[:, :1000] for x in (q, k, v)]
    with pytest.raises(ValueError, match="not divisible"):
        jlayers.attention(*map(jnp.asarray, cut + [pos[:, :1000]] * 2))
    with pytest.raises(ValueError, match="not divisible"):
        layers.attention(*map(torch.from_numpy, cut),
                         *[torch.from_numpy(pos[:, :1000].copy())] * 2)


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b"]
                         + list(MOE))
def test_arch_smoke_train_step(pair, arch):
    """One optimizer step with 2 micro-batches: loss finite and within
    1e-4 of the reference's, the grad norm within 1e-4 of it relative,
    the step counter at 1, and every updated leaf within 1e-4 of the
    reference's (MoE: capacity drops in the step)."""
    jm, jp, model, _ = pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    toks = np.ones((4, 32), np.int32)
    jcfg = JAdamW(lr=1e-3)
    jp2, jopt, jmet = jax.jit(jmake_train_step(
        jm, jcfg, JStep(microbatches=2)))(jp, jadamw_init(jp, jcfg),
                                          {"tokens": jnp.asarray(toks)})
    params = model.params_from_reference(tree)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    ocfg = AdamWConfig(lr=1e-3)
    params, opt, met = make_train_step(model, ocfg, TrainStepConfig(
        microbatches=2))(params, adamw_init(params, ocfg),
                         {"tokens": torch.from_numpy(toks)})
    assert bool(torch.isfinite(met["loss"]))
    assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-4
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) \
        < 1e-4 * float(jmet["grad_norm"])
    assert int(opt.step) == 1 == int(jopt.step)
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in params.named_parameters())
    assert moved > 0
    want = model.params_from_reference(jax.tree.map(np.asarray, jp2))
    for (n, got), (_, ref) in zip(params.named_parameters(),
                                  want.named_parameters()):
        _close(got.detach(), ref.detach())
