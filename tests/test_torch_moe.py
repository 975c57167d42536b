"""The port's MoE FFN against the JAX reference, on the CPU.

Inputs and weights come from a numpy seed and go through the reference's
``models/moe.py`` and the port's ``models/moe.py``.  float32 results are
held within 1e-5 (the reference's own tolerance for the grouped MoE
against its oracle, ``test_models.py``); the bf16 case, on the same
bf16-rounded inputs, within 2**-7 of the largest output (one bf16
rounding step at that magnitude: the reference rounds ``silu``'s two
products where the port rounds once).  The smoke models of the moe and
hybrid families (forward, teacher forcing, a train step, parameter
counts) are cases of ``test_torch_dense.py``'s model-generic tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.models import params as port_params

TOL = dict(atol=1e-5, rtol=1e-5)
# (k, E): top-k of every expert count, k <= E
ROUTES = ((1, 4), (2, 4), (1, 8), (2, 8), (8, 8), (1, 128), (2, 128),
          (8, 128))


def _weights(rng, d, e, f, shared, router_scale=0.3):
    w = {"router": rng.standard_normal((d, e)) * router_scale,
         "w_in": rng.standard_normal((e, d, f)) * 0.1,
         "w_gate": rng.standard_normal((e, d, f)) * 0.1,
         "w_out": rng.standard_normal((e, f, d)) * 0.1}
    if shared:
        w.update(shared_w_in=rng.standard_normal((d, 24)) * 0.1,
                 shared_w_gate=rng.standard_normal((d, 24)) * 0.1,
                 shared_w_out=rng.standard_normal((24, d)) * 0.1)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _pair(w, dtype=np.float32):
    """(reference MoEParams, port MoEParams) of the numpy weights ``w``,
    both in ``dtype`` (bf16: the same rounded values)."""
    jp = jmoe.MoEParams(**{k: jnp.asarray(v, dtype=dtype)
                           for k, v in w.items()})
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = moe.MoEParams(**{k: torch.from_numpy(v).to(tdt)
                          for k, v in w.items()})
    return jp, tp


_jit_ffn = jax.jit(jmoe.moe_ffn, static_argnames=(
    "k", "n_experts", "group_size", "capacity_factor", "gated"))
_jit_ref = jax.jit(jmoe.moe_ffn_ref, static_argnames=("k", "gated"))


def _both(x, w, *, k, e, group, cf, gated, dtype=np.float32):
    jp, tp = _pair(w, dtype)
    kw = dict(k=k, n_experts=e, group_size=group, capacity_factor=cf,
              gated=gated)
    want = _jit_ffn(jnp.asarray(x, dtype=dtype), jp, **kw)
    tx = torch.from_numpy(x)
    if dtype == jnp.bfloat16:
        tx = tx.to(torch.bfloat16)
    got = moe.moe_ffn(tx, tp, **kw)
    return got, want, tp


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
@pytest.mark.parametrize("k,e", ROUTES, ids=[f"k{k}-E{e}" for k, e in ROUTES])
def test_moe_ffn_matches_reference(k, e, gated, shared):
    """The port's grouped MoE equals the reference's within 1e-5, at a
    capacity factor that drops slots (0.5: each expert keeps half its
    even share) and at one that drops none (100), over 2 groups of 32."""
    rng = np.random.default_rng(100 * k + e)
    d, f = 16, 32
    w = _weights(rng, d, e, f, shared)
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    outs = {}
    for cf in (0.5, 100.0):
        got, want, tp = _both(x, w, k=k, e=e, group=32, cf=cf, gated=gated)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        outs[cf] = _np(got)
    oracle = _np(moe.moe_ffn_ref(torch.from_numpy(x), tp, k=k, gated=gated))
    np.testing.assert_allclose(outs[100.0], oracle, **TOL)
    if k == e:      # every expert takes every token: half of them drop
        assert np.abs(outs[0.5] - oracle).max() > 1e-3


def test_moe_group_shrinks_at_2000_tokens():
    """2000 tokens in groups of 1024 (qwen3-moe's top-8 of 128): the
    group halves to 16, so capacity is 4; the port mirrors the quirk,
    its drops included, within 1e-5."""
    assert moe.group_size_for(2000, 1024) == 16
    assert moe.capacity_for(16, 8, 128, 1.25) == 4
    assert moe.group_size_for(2048, 1024) == 1024
    assert moe.group_size_for(4, 1024) == 4
    rng = np.random.default_rng(3)
    d, e, k = 16, 128, 8
    w = _weights(rng, d, e, 8, shared=False, router_scale=1.0)
    x = rng.standard_normal((2, 1000, d)).astype(np.float32)
    got, want, tp = _both(x, w, k=k, e=e, group=1024, cf=1.25, gated=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    oracle = _np(moe.moe_ffn_ref(torch.from_numpy(x), tp, k=k))
    assert np.abs(_np(got) - oracle).max() > 1e-3      # slots dropped


def test_moe_ffn_bf16_matches_reference():
    """bf16 weights and activations (float32 routing) on the same rounded
    inputs, with drops: within 2**-7 of the largest output."""
    rng = np.random.default_rng(4)
    d, e, k = 32, 8, 2
    w = _weights(rng, d, e, 64, shared=True)
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    got, want, _ = _both(x, w, k=k, e=e, group=64, cf=1.25, gated=True,
                         dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_moe_ffn_ref_matches_reference(gated, shared):
    """The dense per-token oracle against the reference's, within 1e-5."""
    rng = np.random.default_rng(5)
    d, e, k = 16, 8, 2
    w = _weights(rng, d, e, 32, shared)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    jp, tp = _pair(w)
    want = _jit_ref(jnp.asarray(x), jp, k=k, gated=gated)
    got = moe.moe_ffn_ref(torch.from_numpy(x), tp, k=k, gated=gated)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _reference_case(seed_shape, scales, t_shape):
    """The weights and input of a reference test, drawn by the
    reference's own PRNG calls, as numpy arrays."""
    ks = jax.random.split(jax.random.PRNGKey(seed_shape[0]), 5)
    d, e, f = seed_shape[1:]
    w = {"router": jax.random.normal(ks[0], (d, e)) * scales[0],
         "w_in": jax.random.normal(ks[1], (e, d, f)) * 0.1,
         "w_gate": jax.random.normal(ks[2], (e, d, f)) * 0.1,
         "w_out": jax.random.normal(ks[3], (e, f, d)) * 0.1}
    x = jax.random.normal(ks[4], t_shape)
    return ({k: np.array(v) for k, v in w.items()}, np.array(x))


def test_moe_grouped_vs_dense_oracle():
    """The reference's test on the port: the sort-based grouped MoE
    equals the dense oracle when capacity does not bind (1e-5)."""
    w, x = _reference_case((7, 16, 8, 32), (0.3,), (2, 32, 16))
    _, tp = _pair(w)
    y1 = moe.moe_ffn(torch.from_numpy(x), tp, k=2, n_experts=8,
                     group_size=32, capacity_factor=100.0, gated=True)
    y2 = moe.moe_ffn_ref(torch.from_numpy(x), tp, k=2, gated=True)
    np.testing.assert_allclose(_np(y1), _np(y2), **TOL)


def test_moe_capacity_drops_tokens():
    """The reference's test on the port: a tight capacity factor drops
    tokens, so the output differs from the unconstrained one."""
    w, x = _reference_case((9, 8, 4, 16), (1.0,), (1, 64, 8))
    _, tp = _pair(w)
    kw = dict(k=2, n_experts=4, group_size=64, gated=True)
    tight = moe.moe_ffn(torch.from_numpy(x), tp, capacity_factor=0.5, **kw)
    loose = moe.moe_ffn(torch.from_numpy(x), tp, capacity_factor=100.0, **kw)
    assert float((tight - loose).abs().max()) > 1e-6


def test_topk_order_inside_a_token_does_not_matter(monkeypatch):
    """Only the top-k set decides the result: with each token's top-k
    handed over in reverse order (same gates), the output has the same
    bits, drops included (an expert's slots come in token order)."""
    rng = np.random.default_rng(6)
    w = _weights(rng, 16, 8, 32, shared=False, router_scale=1.0)
    _, tp = _pair(w)
    x = torch.from_numpy(rng.standard_normal((1, 64, 16)).astype(np.float32))
    kw = dict(k=4, n_experts=8, group_size=64, capacity_factor=0.75)
    want = moe.moe_ffn(x, tp, **kw)
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: tuple(
        t.flip(-1) for t in route(*a)))
    got = moe.moe_ffn(x, tp, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,period", [("llama4-maverick-400b-a17b", 2),
                                         ("jamba-1.5-large-398b", 8)])
def test_params_from_reference_unstacks_periods(arch, period):
    """Layer i of the port holds entry i // period of the reference's
    stacked sublayer L{i % period}, expert leaves included."""
    cfg = jget(arch, smoke=True).replace(dtype="float32")
    assert cfg.scan_period == period
    jp = jax.tree.map(np.asarray,
                      jbuild(cfg).init_params(jax.random.PRNGKey(2)))
    model = build_model(get_config(arch, smoke=True).replace(
        dtype="float32"), "cpu")
    params = model.params_from_reference(jp)
    n_moe = 0
    for i, blk in enumerate(params.blocks):
        ref = jp["blocks"][f"L{i % period}"]
        assert set(dict(blk.named_parameters())) == set(ref), i
        for name, p in blk.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          ref[name][i // period])
        n_moe += "moe_w_in" in ref
    assert n_moe == sum(cfg.ffn_kind(i) == "moe"
                        for i in range(cfg.n_layers))


def test_init_params_draws_expert_leaves_by_fan_in(monkeypatch):
    """Expert leaves [E, d, f] are normal with std d ** -0.5 (fan-in on
    axis 1, as the reference's stacked axis 2); a leaf past the draw
    limit is drawn in slices of its first axis with the same scale, and
    a leaf under it is drawn in one call, as before."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).replace(
        dtype="float32", d_model=128, n_experts=16, moe_d_ff=64)
    model = build_model(cfg, "cpu")
    p = dict(model.init_params(0).named_parameters())
    for name in ("moe_w_in", "moe_w_gate", "moe_w_out", "router"):
        leaf = p[f"blocks.0.{name}"]
        fan = leaf.shape[1] if leaf.ndim == 3 else leaf.shape[0]
        assert abs(float(leaf.detach().std()) * fan ** 0.5 - 1) < 0.05, name
    monkeypatch.setattr(port_params, "DRAW_ELEMENTS", 4096)
    q = dict(model.init_params(0).named_parameters())
    w = q["blocks.0.moe_w_in"]
    assert w.shape == (16, 128, 64)
    assert abs(float(w.detach().std()) * 128 ** 0.5 - 1) < 0.05
    gen = torch.Generator().manual_seed(1)
    small = port_params._normal((8, 16), 0.5, gen, torch.float32)
    gen.manual_seed(1)
    assert torch.equal(small, torch.randn((8, 16), generator=gen) * 0.5)


def test_check_supported_takes_moe_and_hybrid():
    """build_model runs the moe and hybrid families, and since they were
    ported the vlm and audio ones (a ``Transformer`` and an ``EncDec``);
    a family the repo does not have raises."""
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
                 "jamba-1.5-large-398b"):
        assert build_model(get_config(arch, smoke=True), "cpu").cfg.family \
            in ("moe", "hybrid")
    for arch, cls in (("internvl2-76b", "Transformer"),
                      ("whisper-medium", "EncDec")):
        model = build_model(get_config(arch, smoke=True), "cpu")
        assert type(model.init_params(0)).__name__ == cls
    with pytest.raises(ValueError, match="decoder-only"):
        build_model(get_config("smollm-360m", smoke=True).replace(
            family="diffusion"), "cpu")
