"""Kernel layer of the PyTorch/CUDA port against the JAX reference.

Each plain PyTorch version (``repro_torch.kernels.ref``, what a wrapper
runs for a CPU tensor) is held against ``repro.kernels.ref`` and the
Pallas kernel in interpret mode, on the shape sweeps of
``test_kernels.py`` plus ragged N, J = 1, R in {1, 2, 4} and rows
floored to -1.  Tolerance is 0 everywhere: fit masks and fit counts are
integers, and Best-Fit ties depend on every bit of the score.

The ``cuda`` tests hold each CUDA kernel against its plain version on
the card and skip without one.  They need no JAX, so they also run on a
machine that has only the port: ``python -m pytest -q -m cuda
tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import alloc_score as t_alloc
from repro_torch.kernels import counters, ops
from repro_torch.kernels import ebf_shadow as t_ebf
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernels and oracles, imported on first use so
    that the ``cuda`` tests run where JAX is not installed."""
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.alloc_score import (alloc_score_batch_pallas,
                                           alloc_score_pallas)
    from repro.kernels.ebf_shadow import ebf_shadow_pallas

    def np_out(*xs):
        return tuple(np.asarray(x) for x in xs)

    class J:
        def alloc(self, avail, cap, req):
            a, c, q = map(jnp.asarray, (avail, cap, req))
            return (np_out(*ref.alloc_score_ref(a, c, q)),
                    np_out(*alloc_score_pallas(a, c, q, interpret=True)))

        def batch(self, avail, cap, req):
            a, c, q = map(jnp.asarray, (avail, cap, req))
            return (np_out(*ref.alloc_score_batch_ref(a, c, q)),
                    np_out(*alloc_score_batch_pallas(a, c, q,
                                                     interpret=True)))

        def ebf(self, avail, deltas, req):
            a, d, q = map(jnp.asarray, (avail, deltas, req))
            return (np.asarray(ref.ebf_shadow_ref(a, d, q)),
                    np.asarray(ebf_shadow_pallas(a, d, q, interpret=True)))
    return J()


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _system(n, r, rng=RNG, floor=0):
    cap = rng.integers(1, 16, (n, r)).astype(np.int32)
    avail = rng.integers(0, 16, (n, r)).clip(0, cap).astype(np.int32)
    if floor:
        # ineligible (down / quarantined) nodes: availability floored to -1
        avail[rng.choice(n, size=min(floor, n), replace=False)] = -1
    return avail, cap


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _assert_score_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------- alloc
ALLOC_SHAPES = [(1, 1), (7, 2), (128, 3), (1000, 4), (513, 2), (4096, 8),
                (129, 1), (300, 2), (257, 4)]


@pytest.mark.parametrize("n,r", ALLOC_SHAPES)
@pytest.mark.parametrize("floor", [0, 5])
def test_alloc_score_plain_matches_reference(jx, n, r, floor):
    avail, cap = _system(n, r, floor=floor)
    # a zero request column: floored rows must still not fit
    req = RNG.integers(0, 6, (r,)).astype(np.int32)
    req[0] = 0
    fit, score = tref.alloc_score_ref(_t(avail), _t(cap), _t(req))
    for f2, s2 in jx.alloc(avail, cap, req):
        np.testing.assert_array_equal(fit.numpy(), f2)
        _assert_score_bits(score.numpy(), s2)
    if floor:
        assert not fit.numpy()[avail[:, 0] < 0].any()


BATCH_SHAPES = [(1, 1, 1), (3, 7, 2), (8, 128, 3), (17, 513, 2),
                (64, 1000, 4), (256, 64, 2), (1, 300, 2), (1, 129, 4),
                (33, 257, 1)]


@pytest.mark.parametrize("j,n,r", BATCH_SHAPES)
@pytest.mark.parametrize("floor", [0, 4])
def test_alloc_score_batch_plain_matches_reference(jx, j, n, r, floor):
    avail, cap = _system(n, r, floor=floor)
    req = RNG.integers(0, 6, (j, r)).astype(np.int32)
    req[:, -1] = np.where(np.arange(j) % 2 == 0, 0, req[:, -1])
    fit, score = tref.alloc_score_batch_ref(_t(avail), _t(cap), _t(req))
    assert fit.shape == score.shape == (j, n)
    for f2, s2 in jx.batch(avail, cap, req):
        np.testing.assert_array_equal(fit.numpy(), f2)
        _assert_score_bits(score.numpy(), s2)


def test_batch_rows_equal_per_job_and_host_reconcile():
    """Row j of the batched version == the per-job version on request j,
    and the score equals the host's numpy float32 reconcile bit for bit
    (``BatchProbe.find``)."""
    n, r, j = 257, 2, 19
    avail, cap = _system(n, r, floor=3)
    req = RNG.integers(0, 5, (j, r)).astype(np.int32)
    fb, sb = tref.alloc_score_batch_ref(_t(avail), _t(cap), _t(req))
    for k in range(j):
        f1, s1 = tref.alloc_score_ref(_t(avail), _t(cap), _t(req[k]))
        np.testing.assert_array_equal(fb[k].numpy(), f1.numpy())
        _assert_score_bits(sb[k].numpy(), s1.numpy())
    host = ((cap.astype(np.int64) - avail).astype(np.float32)
            / np.maximum(cap, 1).astype(np.float32)).sum(axis=1,
                                                         dtype=np.float32)
    _assert_score_bits(sb[0].numpy(), host)


# ---------------------------------------------------------------- ebf
EBF_SHAPES = [(1, 16, 1), (5, 100, 2), (33, 257, 3), (64, 1024, 4),
              (7, 129, 2), (1, 1, 1)]


@pytest.mark.parametrize("m,n,r", EBF_SHAPES)
@pytest.mark.parametrize("floor", [0, 6])
def test_ebf_shadow_plain_matches_reference(jx, m, n, r, floor):
    avail, _ = _system(n, r, floor=floor)
    deltas = RNG.integers(0, 3, (m, n, r)).astype(np.int32)
    if floor:
        # released resources on ineligible nodes are filtered host-side
        deltas[:, avail[:, 0] < 0, :] = 0
    req = RNG.integers(0, 5, (r,)).astype(np.int32)
    req[0] = 0
    fits = tref.ebf_shadow_ref(_t(avail), _t(deltas), _t(req))
    assert fits.dtype == torch.int32 and fits.shape == (m,)
    for f2 in jx.ebf(avail, deltas, req):
        np.testing.assert_array_equal(fits.numpy(), f2)


def test_ebf_shadow_plain_is_monotone():
    n, r, m = 64, 2, 10
    avail = np.zeros((n, r), np.int32)
    deltas = RNG.integers(0, 2, (m, n, r)).astype(np.int32)
    req = np.array([3, 2], np.int32)
    fits = tref.ebf_shadow_ref(_t(avail), _t(deltas), _t(req)).numpy()
    assert np.all(np.diff(fits) >= 0)


# ---------------------------------------------------------------- wrappers
def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    avail, cap = _system(50, 2, floor=2)
    req = RNG.integers(0, 4, (9, 2)).astype(np.int32)
    deltas = RNG.integers(0, 2, (4, 50, 2)).astype(np.int32)
    counters.reset_device_launches()
    f, s = t_alloc.alloc_score_batch(_t(avail), _t(cap), _t(req))
    f1, s1 = t_alloc.alloc_score(_t(avail), _t(cap), _t(req[0]))
    fits = t_ebf.ebf_shadow(_t(avail), _t(deltas), _t(req[0]))
    assert counters.device_launch_stats() == {}
    want = tref.alloc_score_batch_ref(_t(avail), _t(cap), _t(req))
    assert torch.equal(f, want[0]) and torch.equal(s, want[1])
    assert torch.equal(f1, f[0]) and torch.equal(s1, s[0])
    assert torch.equal(fits, tref.ebf_shadow_ref(_t(avail), _t(deltas),
                                                 _t(req[0])))


def test_wrappers_refuse_bad_inputs():
    avail, cap = _system(8, 2)
    req = np.zeros((3, 2), np.int32)
    with pytest.raises(TypeError):
        t_alloc.alloc_score_batch(_t(avail).long(), _t(cap), _t(req))
    with pytest.raises(ValueError):
        t_alloc.alloc_score_batch(_t(avail), _t(cap), _t(req[:, :1]))
    with pytest.raises(ValueError):
        t_alloc.alloc_score_batch(_t(avail).t(), _t(cap).t(), _t(req))
    with pytest.raises(ValueError):
        t_ebf.ebf_shadow(_t(avail), _t(np.zeros((2, 8, 3), np.int32)),
                         _t(req[0]))
    with pytest.raises(ValueError):
        t_ebf.ebf_shadow(_t(avail).to("meta"),
                         _t(np.zeros((2, 8, 2), np.int32)).to("meta"),
                         _t(req[0]).to("meta"))


def test_ops_cast_int64_and_count_one_launch_per_call():
    avail, cap = _system(40, 2, floor=1)
    req = RNG.integers(0, 4, (6, 2))                 # int64, as in contexts
    before = ops.launch_stats()
    fit, score = ops.alloc_score_batch(avail.astype(np.int64),
                                       cap.astype(np.int64), req, "cpu")
    fits = ops.ebf_shadow_fits(avail, np.zeros((3, 40, 2), np.int64),
                               req[0], "cpu")
    after = ops.launch_stats()
    assert after.get("alloc_score_batch", 0) \
        - before.get("alloc_score_batch", 0) == 1
    assert after.get("ebf_shadow", 0) - before.get("ebf_shadow", 0) == 1
    assert isinstance(fit, np.ndarray) and fit.dtype == np.int32
    assert score.dtype == np.float32 and fit.shape == score.shape == (6, 40)
    assert fits.dtype == np.int32 and fits.shape == (3,)


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("j,n,r", [(1, 120, 2), (400, 120, 2), (4096, 1024, 2),
                                   (17, 513, 3), (3, 1, 1), (70000, 5, 2),
                                   (0, 16, 2)])
def test_alloc_score_batch_cuda_equals_plain(cuda, j, n, r):
    avail, cap = _system(n, r, floor=min(3, n))
    req = RNG.integers(0, 6, (j, r)).astype(np.int32)
    a, c, q = _t(avail), _t(cap), _t(req)
    f, s = t_alloc.alloc_score_batch(a.to(cuda), c.to(cuda), q.to(cuda))
    torch.cuda.synchronize()
    fw, sw = tref.alloc_score_batch_ref(a, c, q)
    np.testing.assert_array_equal(f.cpu().numpy(), fw.numpy())
    _assert_score_bits(s.cpu().numpy(), sw.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(120, 2), (1024, 2), (513, 4), (1, 1)])
def test_alloc_score_cuda_equals_plain(cuda, n, r):
    avail, cap = _system(n, r, floor=min(2, n))
    req = RNG.integers(0, 6, (r,)).astype(np.int32)
    a, c, q = _t(avail), _t(cap), _t(req)
    counters.reset_device_launches()
    f, s = t_alloc.alloc_score(a.to(cuda), c.to(cuda), q.to(cuda))
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"alloc_score": 1}
    fw, sw = tref.alloc_score_ref(a, c, q)
    np.testing.assert_array_equal(f.cpu().numpy(), fw.numpy())
    _assert_score_bits(s.cpu().numpy(), sw.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r", [(1, 120, 2), (200, 120, 2),
                                   (1000, 1024, 2), (33, 257, 8),
                                   (5, 100, 3), (0, 10, 2)])
def test_ebf_shadow_cuda_equals_plain(cuda, m, n, r):
    avail, _ = _system(n, r, floor=min(4, n))
    deltas = RNG.integers(0, 3, (m, n, r)).astype(np.int32)
    deltas[:, avail[:, 0] < 0, :] = 0
    req = RNG.integers(0, 5, (r,)).astype(np.int32)
    a, d, q = _t(avail), _t(deltas), _t(req)
    fits = t_ebf.ebf_shadow(a.to(cuda), d.to(cuda), q.to(cuda))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(fits.cpu().numpy(),
                                  tref.ebf_shadow_ref(a, d, q).numpy())


@pytest.mark.cuda
def test_ebf_shadow_cuda_refuses_wide_r(cuda):
    r = t_ebf.MAX_R + 1
    with pytest.raises(ValueError):
        t_ebf.ebf_shadow(torch.zeros((4, r), dtype=torch.int32, device=cuda),
                         torch.zeros((2, 4, r), dtype=torch.int32,
                                     device=cuda),
                         torch.zeros((r,), dtype=torch.int32, device=cuda))
