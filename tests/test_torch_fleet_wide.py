"""The port's plain versions against the reference at the system sizes the
CUDA kernels once refused.

The ``fleet_engine`` kernel keeps its node arrays in shared memory where
they fit and in global memory past that, holds Best-Fit keys in
registers up to 2048 nodes and unrolls up to 8 resource types; the
dispatch kernels unroll up to 8 types too.  On the card each is held
against its plain version at these shapes
(``tests/test_torch_fleet_kernel.py``, ``tests/test_torch_kernels.py``,
``cuda``).  Here, on the CPU, the plain versions are held against the
reference on the same inputs, all exactly:

* ``advance_plain`` against the reference's ``advance`` at 4096 nodes x
  2 types (EBF-BF and FIFO-FF, with and without the prefilter), at 64
  nodes x 10 types, and at 2048 nodes x 8 types under a failure schedule
  with telemetry;
* ``kernels/ref.py``'s ``alloc_score_batch`` (dense and packed) and
  ``ebf_shadow`` (dense and sparse) against the reference's plain
  versions and Pallas kernels in interpret mode at R 10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro.kernels import ref as jref
from repro.kernels.alloc_score import alloc_score_batch_pallas
from repro.kernels.ebf_shadow import ebf_shadow_pallas, group_releases
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SimState, advance_plain)
from repro_torch.kernels import ebf_shadow as t_ebf
from repro_torch.kernels import ref as tref
from test_torch_fleet_kernel import LARGE, assert_states_equal, large_states


def _plain_equals_reference(states, use_kernel, what):
    for s in states:
        got = advance_plain(SimState(*(torch.from_numpy(
            np.asarray(x, dtype=np.int32)) for x in s)), use_kernel)
        want = ref_fleet.advance(ref_fleet.SimState(*s), use_kernel)
        assert_states_equal(SimState(*(x.numpy() for x in got)), want, what)
        log_q = np.asarray(want.log_queue)[:int(want.n_events)]
        assert int(want.n_completed) == s.n_rows and log_q.max() > 5


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plain_matches_reference_past_the_register_keys(use_kernel):
    """4096 nodes: Best-Fit keys past the 2048 the kernel holds in
    registers (its block minimums and its bitonic sort both taken)."""
    states = large_states("n4096", [(SCHED_EBF, ALLOC_BF),
                                    (SCHED_FIFO, ALLOC_FF)])
    assert states[0].avail.shape == (4096, 2)
    _plain_equals_reference(states, use_kernel, "4096 nodes")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plain_matches_reference_past_the_unrolled_types(use_kernel):
    """10 resource types: the backfill's counts and the Best-Fit load
    past the 8 types the kernels unroll."""
    states = large_states("n64_r10", [(SCHED_EBF, ALLOC_BF),
                                      (SCHED_EBF, ALLOC_FF)])
    assert states[0].avail.shape == (64, 10)
    _plain_equals_reference(states, use_kernel, "10 types")


def test_plain_matches_reference_past_shared_memory_under_failures():
    """2048 nodes x 8 types, whose node arrays outgrow one block's shared
    memory: failures, requeues and telemetry."""
    states = large_states("n2048_r8", [(SCHED_EBF, ALLOC_BF)], failures=True)
    assert LARGE["n2048_r8"][:2] == states[0].avail.shape
    _plain_equals_reference(states, False, "2048 x 8, failures")
    got = advance_plain(SimState(*(torch.from_numpy(
        np.asarray(x, dtype=np.int32)) for x in states[0])))
    assert int(got.n_requeued) > 0 and int(got.tele_n) > 0


def _system(rng, n, r, j):
    cap = rng.integers(1, 16, (n, r)).astype(np.int32)
    avail = rng.integers(0, 16, (n, r)).clip(0, cap).astype(np.int32)
    avail[rng.choice(n, size=max(1, n // 10), replace=False)] = -1
    req = rng.integers(0, 6, (j, r)).astype(np.int32)
    req[::2, 0] = 0
    return avail, cap, req


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("j,n", [(1, 33), (37, 129), (64, 1000)])
def test_alloc_score_plain_matches_reference_at_ten_types(j, n):
    """Fit and score at R 10, bit for bit, dense and in the kernel's packed
    layout (fit bits unpacked, one score row)."""
    avail, cap, req = _system(np.random.default_rng(n), n, 10, j)
    fit, score = tref.alloc_score_batch_ref(_t(avail), _t(cap), _t(req))
    a, c, q = map(jnp.asarray, (avail, cap, req))
    for f2, s2 in (jref.alloc_score_batch_ref(a, c, q),
                   alloc_score_batch_pallas(a, c, q, interpret=True)):
        np.testing.assert_array_equal(fit.numpy(), np.asarray(f2))
        np.testing.assert_array_equal(_bits(score.numpy()), _bits(s2))
    bits, row = tref.alloc_score_packed_ref(_t(avail), _t(cap), _t(req))
    np.testing.assert_array_equal(tref.unpack_bits(bits, n).numpy(),
                                  fit.numpy())
    np.testing.assert_array_equal(_bits(row.numpy()), _bits(score[0]))


@pytest.mark.parametrize("n,n_rel,n_times", [(40, 30, 3), (257, 60, 20)])
def test_ebf_shadow_plain_matches_reference_at_ten_types(n, n_rel, n_times):
    """Fit counts at R 10: the dense plain version against the
    reference's plain version and Pallas kernel, and the sparse one (the
    kernel's layout, through the CPU wrapper) against the same on the
    densified releases."""
    r = 10
    rng = np.random.default_rng(n_rel)
    avail, _, req = _system(rng, n, r, 1)
    releases = []
    for _ in range(n_rel):
        k = int(rng.integers(1, 5))
        releases.append((int(rng.integers(0, n_times)),
                         rng.choice(n, size=k, replace=False),
                         rng.integers(-1, 3, r)))
    releases.sort(key=lambda e: e[0])
    deltas = group_releases(avail, releases)[1]
    want = np.asarray(jref.ebf_shadow_ref(*map(jnp.asarray,
                                               (avail, deltas, req[0]))))
    np.testing.assert_array_equal(np.asarray(ebf_shadow_pallas(
        *map(jnp.asarray, (avail, deltas, req[0])), interpret=True)), want)
    np.testing.assert_array_equal(tref.ebf_shadow_ref(
        _t(avail), _t(deltas), _t(req[0])).numpy(), want)
    rel = t_ebf.sparse_releases(n, releases)
    fits = t_ebf.ebf_shadow(_t(avail), _t(rel.node_ptr), _t(rel.entry_m),
                            _t(np.reshape(rel.entry_vec, (-1, r))),
                            _t(req[0]), rel.times.shape[0])
    np.testing.assert_array_equal(fits.numpy(), want)
