"""Kernel layer of the PyTorch/CUDA port against the JAX reference.

Each plain PyTorch version (``repro_torch.kernels.ref``, what a wrapper
runs for a CPU tensor) is held against ``repro.kernels.ref`` and the
Pallas kernel in interpret mode, on the shape sweeps of
``test_kernels.py`` plus ragged N, J = 1, R in {1, 2, 4} and rows
floored to -1.  The kernels' own layouts (fit bits and one score row;
releases grouped by node) are unpacked or densified and held against the
same reference, and the sparse ``shadow_from_releases`` against the
reference's dense one.  Tolerance is 0 for the dispatch kernels: fit masks and
fit counts are integers, and Best-Fit ties depend on every bit of the
score.  The selective scan is float32 and is held within 2e-4 (the
reference's own tolerance, ``test_kernels.py``) on the CPU and 1e-4 on
the card: the versions order their sums differently.  On the card its
bf16 and fp16 reads are held bitwise against the same values upcast to
float32: widening is exact.

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
from repro_torch.kernels import selective_scan as t_scan

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
    from repro.kernels.selective_scan import selective_scan_pallas

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

        def dense(self, avail, releases):
            from repro.kernels.ebf_shadow import group_releases
            return group_releases(avail, releases)[1]

        def shadow(self, avail, head, need, releases):
            from repro.kernels.ebf_shadow import shadow_from_releases
            return shadow_from_releases(avail, head, need, releases)

        def ebf(self, avail, deltas, req):
            a, d, q = map(jnp.asarray, (avail, deltas, req))
            return (np.asarray(ref.ebf_shadow_ref(a, d, q)),
                    np.asarray(ebf_shadow_pallas(a, d, q, interpret=True)))

        def scan_ref(self, *args):
            return np_out(*ref.selective_scan_ref(*map(jnp.asarray, args)))

        def scan_pallas(self, *args, chunk, block_d):
            return np_out(*selective_scan_pallas(
                *map(jnp.asarray, args), chunk=chunk, block_d=block_d,
                interpret=True))
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


def _release_tuples(rng, n, r, n_rel, n_times, k_max=3, low=0, high=3):
    """Sorted ``(time, nodes, vec)`` releases as a context gives them:
    each job's k <= n nodes distinct, times from a small range (ties)."""
    out = []
    for _ in range(n_rel):
        k = int(rng.integers(1, min(k_max, n) + 1))
        out.append((int(rng.integers(0, n_times)),
                    rng.choice(n, size=k, replace=False).astype(np.int64),
                    rng.integers(low, high, r).astype(np.int64)))
    out.sort(key=lambda e: e[0])
    return out


def _sparse_t(rel, r):
    """The kernel's sparse inputs of ``SparseReleases`` as int32 tensors."""
    return (_t(rel.node_ptr), _t(rel.entry_m),
            _t(np.reshape(rel.entry_vec, (-1, r))))


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


@pytest.mark.parametrize("n", [1, 31, 32, 33, 129, 1000])
@pytest.mark.parametrize("j", [1, 37])
def test_alloc_score_packed_plain_matches_reference(jx, n, j):
    """The kernel's layout (fit bits [J, ceil(N/32)], score [N]), unpacked,
    is the reference's [J, N] fit and score, with -1-floored rows and zero
    request columns; the tail bits past N are 0."""
    avail, cap = _system(n, 2, floor=min(3, n))
    req = RNG.integers(0, 6, (j, 2)).astype(np.int32)
    req[::2, 0] = 0
    bits, score = tref.alloc_score_packed_ref(_t(avail), _t(cap), _t(req))
    assert bits.dtype == torch.int32 and bits.shape == (j, -(-n // 32))
    assert score.shape == (n,)
    fit = tref.unpack_bits(bits, n).numpy()
    for f2, s2 in jx.batch(avail, cap, req):
        np.testing.assert_array_equal(fit, f2)
        for k in range(j):
            _assert_score_bits(score.numpy(), s2[k])
    words = bits.numpy().view(np.uint32)
    if n % 32:
        assert not np.any(words[:, -1] >> np.uint32(n % 32))
    for k in range(j):                         # the host's row unpacking
        np.testing.assert_array_equal(ops.fit_row(words[k], n),
                                      fit[k].astype(bool))


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


# releases: (n, r, releases, distinct-time range, nodes per job, low, high)
SPARSE_CASES = {
    "several_in_one_group": (40, 2, 30, 3, 6, 0, 3),
    "nodes_without_entries": (300, 2, 5, 4, 2, 0, 3),
    "one_group": (64, 3, 12, 1, 4, 0, 3),
    "negative_deltas": (50, 2, 25, 6, 4, -3, 3),
    "wide": (257, 4, 60, 20, 8, -1, 3),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_ebf_shadow_sparse_plain_matches_reference(jx, case):
    """The kernel's layout (releases grouped by node) through the port's
    wrapper on the CPU equals the reference's dense ref and Pallas kernel
    on the densified releases."""
    n, r, n_rel, n_times, k_max, low, high = SPARSE_CASES[case]
    rng = np.random.default_rng(len(case))
    avail, _ = _system(n, r, rng=rng, floor=3)
    releases = _release_tuples(rng, n, r, n_rel, n_times, k_max, low, high)
    if case == "several_in_one_group":      # node 0 twice in one group
        t0 = releases[0][0]
        releases[:2] = [(t0, np.array([0, 1]), v) for _, _, v in
                        releases[:2]]
    rel = t_ebf.sparse_releases(n, releases)
    m = rel.times.shape[0]
    if case == "one_group":
        assert m == 1
    if case == "nodes_without_entries":
        assert np.sum(np.diff(rel.node_ptr) == 0) > n // 2
    req = RNG.integers(0, 5, (r,)).astype(np.int32)
    fits = t_ebf.ebf_shadow(_t(avail), *_sparse_t(rel, r), _t(req), m)
    assert fits.dtype == torch.int32 and fits.shape == (m,)
    deltas = jx.dense(avail, releases)
    for f2 in jx.ebf(avail, deltas, req):
        np.testing.assert_array_equal(fits.numpy(), f2)


def test_ebf_shadow_sparse_plain_without_releases(jx):
    """No releases: M = 0 and an empty count, as the reference's plain
    version gives for an empty ``deltas`` (its Pallas grid needs M >= 1)."""
    from repro.kernels import ref as jref
    avail, _ = _system(10, 2, floor=2)
    rel = t_ebf.sparse_releases(10, [])
    req = np.ones(2, np.int32)
    fits = t_ebf.ebf_shadow(_t(avail), *_sparse_t(rel, 2), _t(req), 0)
    want = jref.ebf_shadow_ref(avail, np.zeros((0, 10, 2), np.int32), req)
    assert fits.dtype == torch.int32 and fits.shape == (0,)
    assert np.asarray(want).shape == (0,)


@pytest.mark.parametrize("seed", range(8))
def test_shadow_from_releases_matches_reference(jx, seed):
    """(shadow time, shadow availability) of the port's sparse host path
    == the reference's dense one (its kernels in the mode of its own CPU
    tests), on random running-job sets with k <= n nodes per job."""
    rng = np.random.default_rng(seed)
    n, r = int(rng.integers(2, 40)), int(rng.integers(1, 4))
    cap = rng.integers(2, 8, (n, r))
    avail = rng.integers(0, 3, (n, r)).clip(0, cap)
    avail[rng.random(n) < 0.1] = -1
    releases = _release_tuples(rng, n, r, int(rng.integers(0, 14)), 5)
    head = rng.integers(1, 4, r)
    need = int(rng.integers(1, max(2, n // 2)))
    got_t, got = t_ebf.shadow_from_releases(avail, head, need, releases,
                                            "cpu")
    want_t, want = jx.shadow(avail, head, need, releases)
    assert got_t == want_t
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- scan
def _scan_inputs(bt, length, di, s, rng=RNG):
    """The reference's scan inputs (``test_kernels.py``): small positive
    delta, negative A."""
    u = rng.standard_normal((bt, length, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((bt, length, di))) * 0.1
          ).astype(np.float32)
    A = (-np.abs(rng.standard_normal((di, s)))).astype(np.float32)
    B = rng.standard_normal((bt, length, s)).astype(np.float32)
    C = rng.standard_normal((bt, length, s)).astype(np.float32)
    D = rng.standard_normal((di,)).astype(np.float32)
    return u, dt, A, B, C, D


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bt,l,di,s,chunk,bd", [
    (1, 64, 32, 4, 32, 32),
    (2, 128, 64, 8, 64, 32),
    (3, 256, 128, 16, 128, 64),
])
def test_selective_scan_plain_matches_reference(jx, bt, l, di, s, chunk, bd):
    args = _scan_inputs(bt, l, di, s)
    y, h = tref.selective_scan_ref(*map(torch.from_numpy, args))
    for want in (jx.scan_ref(*args),
                 jx.scan_pallas(*args, chunk=chunk, block_d=bd)):
        _close(y, want[0], 2e-4)
        _close(h, want[1], 2e-4)


def test_selective_scan_plain_ragged_matches_reference(jx):
    """L = 37 and Di = 48 divide no block: the reference's oracle."""
    args = _scan_inputs(2, 37, 48, 5)
    y, h = tref.selective_scan_ref(*map(torch.from_numpy, args))
    want = jx.scan_ref(*args)
    _close(y, want[0], 2e-4)
    _close(h, want[1], 2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bt,l,di,s,chunk,bd", [
    (2, 64, 64, 16, 32, 32),
    (1, 128, 96, 5, 64, 32),
])
def test_selective_scan_serve_dtypes_match_reference(jx, dtype, bt, l, di, s,
                                                     chunk, bd):
    """The types the serve path hands ``ops.selective_scan``: narrow u,
    delta, B and C, float32 A and D.  The reference gets the same
    rounded values in float32."""
    u, dt, A, B, C, D = _scan_inputs(bt, l, di, s)
    narrow = [torch.from_numpy(x).to(dtype) for x in (u, dt, B, C)]
    y, h = ops.selective_scan(narrow[0], narrow[1], torch.from_numpy(A),
                              narrow[2], narrow[3], torch.from_numpy(D))
    assert y.dtype == h.dtype == torch.float32
    nu, ndt, nb, nc = (x.float().numpy() for x in narrow)
    args = (nu, ndt, A, nb, nc, D)
    for want in (jx.scan_ref(*args),
                 jx.scan_pallas(*args, chunk=chunk, block_d=bd)):
        _close(y, want[0], 2e-4)
        _close(h, want[1], 2e-4)


def test_selective_scan_cpu_wrapper_casts_and_counts():
    args = [torch.from_numpy(x) for x in _scan_inputs(2, 9, 24, 3)]
    half = [x.to(torch.bfloat16) for x in args]
    counters.reset_device_launches()
    before = ops.launch_stats().get("selective_scan", 0)
    y, h = ops.selective_scan(*half)
    assert ops.launch_stats()["selective_scan"] - before == 1
    assert counters.device_launch_stats() == {}
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (2, 9, 24) and h.shape == (2, 24, 3)
    want = tref.selective_scan_ref(*[x.float() for x in half])
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


def test_selective_scan_refuses_bad_inputs():
    u, dt, A, B, C, D = [torch.from_numpy(x)
                         for x in _scan_inputs(1, 4, 8, 2)]
    with pytest.raises(TypeError):
        t_scan.selective_scan(u.int(), dt, A, B, C, D)
    with pytest.raises(ValueError):                     # rank
        t_scan.selective_scan(u[0], dt, A, B, C, D)
    with pytest.raises(ValueError):                     # Di of A
        t_scan.selective_scan(u, dt, A[:4], B, C, D)
    with pytest.raises(ValueError):                     # S of C
        t_scan.selective_scan(u, dt, A, B, C[..., :1], D)
    with pytest.raises(ValueError):                     # not contiguous
        t_scan.selective_scan(u, dt, A, B, torch.cat([C, C], -1)[..., ::2],
                              D)
    with pytest.raises(ValueError):                     # empty
        t_scan.selective_scan(u[:, :0], dt[:, :0], A, B[:, :0], C[:, :0],
                              D)
    with pytest.raises(ValueError):                     # no kernel there
        t_scan.selective_scan(*[x.to("meta") for x in (u, dt, A, B, C, D)])


# ---------------------------------------------------------------- wrappers
def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    avail, cap = _system(50, 2, floor=2)
    req = RNG.integers(0, 4, (9, 2)).astype(np.int32)
    rel = t_ebf.sparse_releases(50, _release_tuples(RNG, 50, 2, 8, 4))
    m = rel.times.shape[0]
    counters.reset_device_launches()
    f, s = t_alloc.alloc_score_batch(_t(avail), _t(cap), _t(req))
    f1, s1 = t_alloc.alloc_score(_t(avail), _t(cap), _t(req[0]))
    fits = t_ebf.ebf_shadow(_t(avail), *_sparse_t(rel, 2), _t(req[0]), m)
    assert counters.device_launch_stats() == {}
    want = tref.alloc_score_packed_ref(_t(avail), _t(cap), _t(req))
    assert torch.equal(f, want[0]) and torch.equal(s, want[1])
    assert torch.equal(f1, f[0]) and torch.equal(s1, s)
    assert torch.equal(fits, tref.ebf_shadow_sparse_ref(
        _t(avail), *_sparse_t(rel, 2), _t(req[0]), m))


def test_wrappers_refuse_bad_inputs():
    avail, cap = _system(8, 2)
    req = np.zeros((3, 2), np.int32)
    rel = _sparse_t(t_ebf.sparse_releases(8, [(1, np.array([2]),
                                                np.array([1, 1]))]), 2)
    with pytest.raises(TypeError):
        t_alloc.alloc_score_batch(_t(avail).long(), _t(cap), _t(req))
    with pytest.raises(ValueError):
        t_alloc.alloc_score_batch(_t(avail), _t(cap), _t(req[:, :1]))
    with pytest.raises(ValueError):
        t_alloc.alloc_score_batch(_t(avail).t(), _t(cap).t(), _t(req))
    with pytest.raises(ValueError):                     # rank of req
        t_alloc.alloc_score(_t(avail), _t(cap), _t(req))
    with pytest.raises(ValueError):                     # R of entry_vec
        t_ebf.ebf_shadow(_t(avail), rel[0], rel[1],
                         _t(np.zeros((1, 3), np.int32)), _t(req[0]), 1)
    with pytest.raises(ValueError):                     # node_ptr length
        t_ebf.ebf_shadow(_t(avail), rel[0][:-1], rel[1], rel[2],
                         _t(req[0]), 1)
    with pytest.raises(ValueError):
        t_ebf.ebf_shadow(*[x.to("meta") for x in (_t(avail), *rel,
                                                  _t(req[0]))], 1)
    with pytest.raises(ValueError):                     # node id >= n
        t_ebf.sparse_releases(8, [(1, np.array([8]), np.array([1, 1]))])


def test_ops_cast_int64_and_count_one_launch_per_call():
    avail, cap = _system(40, 2, floor=1)
    req = RNG.integers(0, 4, (6, 2))                 # int64, as in contexts
    rel = t_ebf.sparse_releases(40, _release_tuples(RNG, 40, 2, 5, 3))
    before = ops.launch_stats()
    bits, score = ops.alloc_score_batch(avail.astype(np.int64),
                                        cap.astype(np.int64), req, "cpu")
    fit1, score1 = ops.alloc_score(avail.astype(np.int64),
                                   cap.astype(np.int64), req[0], "cpu")
    fits = ops.ebf_shadow_fits(avail.astype(np.int64), rel, req[0], "cpu")
    after = ops.launch_stats()
    for name in ("alloc_score_batch", "alloc_score", "ebf_shadow"):
        assert after.get(name, 0) - before.get(name, 0) == 1, name
    assert isinstance(bits, np.ndarray) and bits.dtype == np.uint32
    assert bits.shape == (6, 2) and score.dtype == np.float32
    assert score.shape == (40,)
    assert fit1.dtype == bool and fit1.shape == (40,)
    np.testing.assert_array_equal(fit1, ops.fit_row(bits[0], 40))
    _assert_score_bits(score1, score)
    assert fits.dtype == np.int32 and fits.shape == rel.times.shape


MALFORMED = ["ptr_end", "ptr_order", "m_range", "m_order", "m_negative"]


def _malformed_releases(mutate):
    """(avail, good, bad): 6 nodes, two release groups, and the same
    releases broken as ``mutate`` says."""
    avail, _ = _system(6, 2)
    rel = t_ebf.sparse_releases(6, [(1, np.array([0, 2]), np.array([1, 1])),
                                    (4, np.array([2, 3]), np.array([1, 0]))])
    ptr, em = rel.node_ptr.copy(), rel.entry_m.copy()
    if mutate == "ptr_end":
        ptr[-1] += 1
    elif mutate == "ptr_order":
        ptr[1], ptr[2] = ptr[2] + 1, ptr[1]
    elif mutate == "m_range":
        em[-1] = 2
    elif mutate == "m_order":                        # node 2: m 0 then 1
        em[1], em[2] = 1, 0
    else:
        em[0] = -1
    return avail, rel, rel._replace(node_ptr=ptr, entry_m=em)


@pytest.mark.parametrize("mutate", MALFORMED)
def test_ops_refuse_malformed_sparse_releases(mutate):
    avail, rel, bad = _malformed_releases(mutate)
    ops.ebf_shadow_fits(avail, rel, np.ones(2, np.int64), "cpu")
    with pytest.raises(ValueError, match="malformed"):
        ops.ebf_shadow_fits(avail, bad, np.ones(2, np.int64), "cpu")
    fits = t_ebf.ebf_shadow(_t(avail), *_sparse_t(bad, 2),
                            _t(np.ones(2, np.int32)), 2)
    assert torch.equal(fits, torch.full((2,), -1, dtype=torch.int32))


# ---------------------------------------------------------------- on the card
def _assert_packed_equal(got, want):
    (bits, score), (wbits, wscore) = got, want
    assert bits.shape == wbits.shape and score.shape == wscore.shape
    assert torch.equal(bits.cpu(), wbits.cpu())
    _assert_score_bits(score.cpu().numpy(), wscore.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("j,n,r", [(1, 120, 2), (400, 120, 2), (4096, 1024, 2),
                                   (17, 513, 3), (3, 1, 1), (70000, 5, 2),
                                   (0, 16, 2), (70000, 4097, 2), (37, 33, 8)])
def test_alloc_score_batch_cuda_equals_plain(cuda, j, n, r):
    """Bits and score bitwise equal to the packed plain version (computed
    on the card: at J 70,000 x N 4097 its [J, N, R] compare is 0.6 GB)."""
    avail, cap = _system(n, r, floor=min(3, n))
    req = RNG.integers(0, 6, (j, r)).astype(np.int32)
    req[::3, 0] = 0
    a, c, q = (_t(x).to(cuda) for x in (avail, cap, req))
    counters.reset_device_launches()
    got = t_alloc.alloc_score_batch(a, c, q)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"alloc_score_batch": 1}
    assert got[0].shape == (j, -(-n // 32))
    _assert_packed_equal(got, tref.alloc_score_packed_ref(a, c, q))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(120, 2), (1024, 2), (513, 4), (1, 1),
                                 (33, 2)])
def test_alloc_score_cuda_equals_plain(cuda, n, r):
    avail, cap = _system(n, r, floor=min(2, n))
    req = RNG.integers(0, 6, (r,)).astype(np.int32)
    a, c, q = (_t(x).to(cuda) for x in (avail, cap, req))
    counters.reset_device_launches()
    bits, score = t_alloc.alloc_score(a, c, q)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"alloc_score": 1}
    wbits, wscore = tref.alloc_score_packed_ref(a, c, q.view(1, -1))
    _assert_packed_equal((bits, score), (wbits[0], wscore))
    fw, _ = tref.alloc_score_ref(a, c, q)
    assert torch.equal(tref.unpack_bits(bits, n), fw)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,n_rel,n_times,k_max,low", [
    (120, 2, 1, 1, 3, 0), (120, 2, 300, 200, 8, 0),
    (1024, 2, 400, 194, 32, 0), (257, 8, 80, 33, 8, -2),
    (100, 3, 20, 5, 4, -3), (10, 2, 0, 1, 3, 0),     # M = 0: no launch
    # past the shared-memory group limit, and more nodes than threads
    (2000, 2, 12000, 6000, 4, -1), (3000, 2, 9000, 9000, 2, 0)])
def test_ebf_shadow_cuda_equals_plain(cuda, n, r, n_rel, n_times, k_max,
                                      low):
    rng = np.random.default_rng(n + n_rel)
    avail, _ = _system(n, r, rng=rng, floor=min(4, n))
    rel = t_ebf.sparse_releases(n, _release_tuples(
        rng, n, r, n_rel, n_times, k_max, low))
    m = rel.times.shape[0]
    if n > 1024:                    # the last two cases
        assert m > t_ebf.shared_m()
    req = RNG.integers(0, 5, (r,)).astype(np.int32)
    args = [x.to(cuda) for x in (_t(avail), *_sparse_t(rel, r), _t(req))]
    counters.reset_device_launches()
    fits = t_ebf.ebf_shadow(*args, m)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == ({"ebf_shadow": 1} if m else {})
    assert fits.shape == (m,)
    assert torch.equal(fits.cpu(), tref.ebf_shadow_sparse_ref(*args, m).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mutate", MALFORMED)
def test_ebf_shadow_cuda_marks_malformed_releases(cuda, mutate):
    """Broken pointers or group indices are not followed: every count is
    -1, as in the plain version, and the card raises no fault."""
    avail, _, bad = _malformed_releases(mutate)
    args = [x.to(cuda) for x in (_t(avail), *_sparse_t(bad, 2),
                                 _t(np.ones(2, np.int32)))]
    fits = t_ebf.ebf_shadow(*args, 2)
    torch.cuda.synchronize()
    assert torch.equal(fits.cpu(), torch.full((2,), -1, dtype=torch.int32))
    assert torch.equal(fits.cpu(), tref.ebf_shadow_sparse_ref(*args, 2).cpu())


def _zeros_on(dev):
    return lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)


@pytest.mark.cuda
def test_ebf_shadow_cuda_refuses_wide_r(cuda):
    r, z = t_ebf.MAX_R + 1, _zeros_on(cuda)
    with pytest.raises(ValueError):
        t_ebf.ebf_shadow(z(4, r), z(5), z(0), z(0, r), z(r), 2)


@pytest.mark.cuda
def test_alloc_score_cuda_refuses_wide_r(cuda):
    r, z = t_alloc.MAX_R + 1, _zeros_on(cuda)
    with pytest.raises(ValueError):
        t_alloc.alloc_score_batch(z(4, r), z(4, r), z(2, r))


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,di,s", [(1, 1, 77, 16), (2, 3, 8190, 1),
                                       (1, 1000, 333, 16), (3, 37, 48, 5),
                                       (4, 1000, 8192, 16), (2, 130, 64, 8)])
def test_selective_scan_cuda_equals_plain(cuda, bt, l, di, s):
    args = [torch.from_numpy(x) for x in _scan_inputs(bt, l, di, s)]
    counters.reset_device_launches()
    y, h = t_scan.selective_scan(*[x.to(cuda) for x in args])
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"selective_scan": 1}
    yw, hw = tref.selective_scan_ref(*[x.to(cuda) for x in args])
    _close(y.cpu(), yw.cpu(), 1e-4)
    _close(h.cpu(), hw.cpu(), 1e-4)


def _scan_on(dev, args, dtype):
    """Scan inputs on ``dev``: u, delta, B, C in ``dtype``, A, D float32."""
    return [torch.from_numpy(x).to(dev).to(
        torch.float32 if i in (2, 5) else dtype) for i, x in enumerate(args)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bt,l,di,s", [(4, 1000, 8192, 16), (2, 37, 8190, 13),
                                       (1, 3, 77, 5), (3, 130, 4001, 1)])
def test_selective_scan_cuda_native_read_is_exact(cuda, dtype, bt, l, di, s):
    """Narrow inputs read as they lie give bitwise the result of the same
    values upcast to float32: the widening is exact."""
    narrow = _scan_on(cuda, _scan_inputs(bt, l, di, s), dtype)
    counters.reset_device_launches()
    y, h = t_scan.selective_scan(*narrow)
    yf, hf = t_scan.selective_scan(*[x.float() for x in narrow])
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"selective_scan": 2}
    assert torch.equal(y, yf) and torch.equal(h, hf)


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,di,s,dtype", [
    (2, 37, 64, 1, torch.float32),        # S below one state group
    (2, 3, 77, 5, torch.bfloat16),        # S not a multiple of 4
    (1, 1000, 4001, 13, torch.float32),
    (3, 1, 8190, 16, torch.bfloat16),     # L = 1
    (2, 37, 8190, 5, torch.float16),      # unaligned fp16 rows
    (1, 1000, 77, 16, torch.float16),
    (2, 3, 4001, 13, torch.float16),
    (2, 1000, 8190, 16, torch.bfloat16),
])
def test_selective_scan_cuda_ragged_tiling_equals_plain(cuda, bt, l, di, s,
                                                        dtype):
    """S, Di and L that cut across the state groups, the 64-channel tile,
    the 32-step chunk and the 16-byte rows, within 1e-4 of the plain
    version, in one launch."""
    args = _scan_on(cuda, _scan_inputs(bt, l, di, s), dtype)
    counters.reset_device_launches()
    y, h = t_scan.selective_scan(*args)
    torch.cuda.synchronize()
    assert counters.device_launch_stats() == {"selective_scan": 1}
    yw, hw = tref.selective_scan_ref(*args)
    _close(y.cpu(), yw.cpu(), 1e-4)
    _close(h.cpu(), hw.cpu(), 1e-4)


@pytest.mark.cuda
def test_selective_scan_cuda_refuses_wide_state(cuda):
    args = _scan_inputs(1, 4, 8, t_scan.MAX_S + 1)
    with pytest.raises(ValueError):
        t_scan.selective_scan(*[torch.from_numpy(x).to(cuda) for x in args])


# ------------------------------------------------------ scan gradients
def _scan_cotangents(bt, l, di, s):
    rng = np.random.default_rng(11)
    return (rng.standard_normal((bt, l, di)).astype(np.float32),
            rng.standard_normal((bt, di, s)).astype(np.float32))


def test_selective_scan_grad_matches_reference_vjp(jx):
    """The wrapper's gradient with respect to all six inputs equals the
    reference's ``jax.vjp`` through ``ops.selective_scan`` (the Pallas
    forward in interpret mode with its oracle's VJP) within 1e-4."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    bt, l, di, s = 2, 8, 8, 4
    args = _scan_inputs(bt, l, di, s)
    gy, gh = _scan_cotangents(bt, l, di, s)
    _, vjp = jax.vjp(jops.selective_scan, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    xs = [torch.from_numpy(x).requires_grad_() for x in args]
    y, h = t_scan.selective_scan(*xs)
    torch.autograd.backward((y, h), (torch.from_numpy(gy),
                                     torch.from_numpy(gh)))
    for x, w in zip(xs, want):
        _close(x.grad, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_cuda_carries_the_plain_gradient(cuda, dtype):
    """On the card the outputs have a ``grad_fn`` and the gradients equal
    the plain version's (computed under autograd on the same inputs)."""
    bt, l, di, s = 2, 37, 64, 5
    args = _scan_inputs(bt, l, di, s)
    gy, gh = (torch.from_numpy(c).to(cuda)
              for c in _scan_cotangents(bt, l, di, s))

    def grads(run):
        xs = [x.detach().clone().requires_grad_()
              for x in _scan_on(cuda, args, dtype)]
        y, h = run(*xs)
        torch.autograd.backward((y, h), (gy, gh))
        return y, [x.grad for x in xs]

    counters.reset_device_launches()
    y, got = grads(t_scan.selective_scan)
    assert y.grad_fn is not None
    assert counters.device_launch_stats() == {"selective_scan": 1}
    _, want = grads(tref.selective_scan_ref)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
