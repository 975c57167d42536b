"""The selective scan's backward: its plain version against the
reference, on the CPU.

* ``ref.selective_scan_bwd_ref`` (the explicit reverse recurrence)
  against the reference's ``jax.vjp`` of ``repro.kernels.ref.
  selective_scan_ref`` and against torch autograd of the port's
  ``selective_scan_ref``, within 1e-5 of each gradient's largest
  magnitude in float32: S 4, 16 and 17 (past the kernel's 16 states), L 1
  and 37, Di 1 and 33, Bt 1 and 3, ``gh`` zero (``h_last`` unused) and
  nonzero; and at the backward kernel's chunk, stage and tile edges (L 7,
  8, 9, 17; Di 63, 65; S 1, 16).
* Narrow inputs: each gradient comes back in its input's dtype, as
  autograd of the plain forward gives it.
* On the CPU the wrapper's gradient is autograd of the plain forward,
  bitwise, and launches nothing; ``selective_scan_bwd`` runs the plain
  backward there and refuses cotangents of another shape.

The backward kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``tests/test_torch_train_cuda.py``,
marker ``cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as t_scan


def _inputs(bt, length, di, s, gh_zero, seed=0):
    """Scan inputs as the reference's tests draw them (small positive
    delta, negative A) and the cotangents of y and h_last."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    u, B, C, D = f(bt, length, di), f(bt, length, s), f(bt, length, s), f(di)
    delta = (np.abs(f(bt, length, di)) * 0.1).astype(np.float32)
    A = -np.abs(f(di, s))
    gy = f(bt, length, di)
    gh = np.zeros((bt, di, s), np.float32) if gh_zero else f(bt, di, s)
    return (u, delta, A, B, C, D), (gy, gh)


def _close_to_largest(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD")


#: (S, L, Bt, Di, gh zero): every S of (4, 16, 17) with every L of (1, 37),
#: (Bt, Di) of (1, 1), (1, 33), (3, 1), (3, 33) and gh zero or not; then
#: the backward kernel's edges (its yardstick on the card is this plain
#: backward): L one short of, at and one past its 8-step chunk and one
#: past two stages (7, 8, 9, 17), Di one short of and past its 64-channel
#: tile (63, 65), S 1 and 16
PLAIN_CASES = [(s, length, bt, di, gh_zero)
               for s in (4, 16, 17) for length in (1, 37)
               for bt, di in ((1, 1), (1, 33), (3, 1), (3, 33))
               for gh_zero in (True, False)] + [
    (16, 7, 1, 63, False), (1, 7, 2, 65, True), (16, 8, 2, 65, False),
    (1, 8, 1, 63, True), (16, 9, 1, 65, True), (1, 9, 2, 63, False),
    (16, 17, 2, 63, False), (1, 17, 1, 65, False), (16, 17, 1, 65, True)]


@pytest.mark.parametrize(
    "s,length,bt,di,gh_zero", PLAIN_CASES,
    ids=[f"{s}-{length}-{bt}-{di}-{'gh0' if z else 'gh'}"
         for s, length, bt, di, z in PLAIN_CASES])
def test_plain_backward_matches_reference_vjp(s, length, bt, di, gh_zero):
    args, (gy, gh) = _inputs(bt, length, di, s, gh_zero)
    _, vjp = jax.vjp(jref.selective_scan_ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    got = tref.selective_scan_bwd_ref(*map(torch.from_numpy, args),
                                      torch.from_numpy(gy),
                                      torch.from_numpy(gh))
    xs = [torch.from_numpy(x).requires_grad_() for x in args]
    y, h = tref.selective_scan_ref(*xs)
    autograd = torch.autograd.grad((y, h), xs, (torch.from_numpy(gy),
                                                torch.from_numpy(gh)))
    for name, g, w, a, x in zip(NAMES, got, want, autograd, args):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        _close_to_largest(g, w, 1e-5, f"{name} vs jax.vjp")
        _close_to_largest(g, a, 1e-5, f"{name} vs autograd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_backward_returns_each_input_dtype(dtype):
    """u, delta, B, C narrow, A and D float32: every gradient in its own
    input's dtype, equal to autograd of the plain forward's (which
    computes in float32 and casts back) within one unit of the type."""
    args, (gy, gh) = _inputs(2, 9, 5, 3, False, seed=1)
    xs = [torch.from_numpy(x).to(torch.float32 if i in (2, 5) else dtype)
          for i, x in enumerate(args)]
    got = tref.selective_scan_bwd_ref(*xs, torch.from_numpy(gy),
                                      torch.from_numpy(gh))
    leaves = [x.detach().clone().requires_grad_() for x in xs]
    y, h = tref.selective_scan_ref(*leaves)
    want = torch.autograd.grad((y, h), leaves, (torch.from_numpy(gy),
                                                torch.from_numpy(gh)))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    for name, g, w, x in zip(NAMES, got, want, xs):
        assert g.dtype == x.dtype == w.dtype, name
        _close_to_largest(g.float(), w.float(), tol, name)


def test_cpu_gradient_is_autograd_of_the_plain_forward():
    """On CPU tensors ``selective_scan`` is the plain forward, so its
    gradient is autograd's, bitwise, and no kernel is launched."""
    args, (gy, gh) = _inputs(2, 19, 7, 17, False, seed=2)
    cot = (torch.from_numpy(gy), torch.from_numpy(gh))

    def grads(run):
        xs = [torch.from_numpy(x).requires_grad_() for x in args]
        torch.autograd.backward(run(*xs), cot)
        return [x.grad for x in xs]

    counters.reset_device_launches()
    got = grads(t_scan.selective_scan)
    assert counters.device_launch_stats() == {}
    for g, w in zip(got, grads(tref.selective_scan_ref)):
        assert torch.equal(g, w)


def test_wrapper_on_cpu_runs_the_plain_backward():
    """``selective_scan_bwd`` on CPU tensors is the plain backward, bitwise,
    and launches nothing."""
    args, (gy, gh) = _inputs(3, 21, 6, 5, False, seed=3)
    xs = [torch.from_numpy(x) for x in (*args, gy, gh)]
    counters.reset_device_launches()
    got = t_scan.selective_scan_bwd(*xs)
    assert counters.device_launch_stats() == {}
    for g, w in zip(got, tref.selective_scan_bwd_ref(*xs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("which", ["gy", "gh"])
def test_wrapper_refuses_cotangents_of_another_shape(which):
    args, (gy, gh) = _inputs(2, 4, 3, 2, False, seed=4)
    gy, gh = torch.from_numpy(gy), torch.from_numpy(gh)
    if which == "gy":
        gy = gy[:, :-1]
    else:
        gh = gh[..., :-1]
    with pytest.raises(ValueError, match="cotangents"):
        t_scan.selective_scan_bwd(*map(torch.from_numpy, args), gy, gh)
