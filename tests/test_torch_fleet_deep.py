"""``advance_plain`` against the reference's ``advance`` on the cases that
work the fleet kernel's row lists hard.

The ``fleet_engine`` kernel keeps a running-row list and a rank-ordered
queue list across events and is held against ``advance_plain`` on the
card (``tests/test_torch_fleet_kernel.py``).  Here, on the CPU, the same
numpy states go through ``advance_plain`` and through the reference's
jitted loop, and the final states must be equal field by field: a queue
over a thousand deep on 10 nodes (EBF with FirstFit and BestFit, with
and without the prefilter), host snapshots whose rows are already
running and queued (EBF-BF and SJF-FF), failures re-ranking victims
behind a long queue, a host snapshot under failures (victims without a
rank), and 600 nodes.  So the oracle is right exactly
where the kernel changed.
"""
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro_torch.fleet import SimState, advance_plain
from test_torch_fleet_kernel import (assert_states_equal, deep_failure_states,
                                     deep_states, snapshot_failure_states,
                                     snapshot_states, wide_states)


def _plain_equals_reference(states, use_kernel, what):
    for s in states:
        got = advance_plain(SimState(*(torch.from_numpy(
            np.asarray(x, dtype=np.int32)) for x in s)), use_kernel)
        want = ref_fleet.advance(ref_fleet.SimState(*s), use_kernel)
        assert_states_equal(SimState(*(x.numpy() for x in got)), want, what)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plain_matches_reference_deep_queue(use_kernel):
    states = deep_states()
    assert states[0].n_rows >= 1500
    _plain_equals_reference(states, use_kernel, "deep queue")


def test_plain_matches_reference_midsim_snapshot(tmp_path):
    _plain_equals_reference(snapshot_states(tmp_path), False, "snapshot")


def test_plain_matches_reference_deep_queue_under_failures():
    _plain_equals_reference(deep_failure_states(), False,
                            "deep queue, failures")


def test_plain_matches_reference_midsim_snapshot_under_failures(tmp_path):
    states = snapshot_failure_states(tmp_path)
    _plain_equals_reference(states, False, "snapshot, failures")
    requeued = [int(advance_plain(SimState(*(torch.from_numpy(
        np.asarray(x, dtype=np.int32)) for x in s))).n_requeued)
        for s in states]
    assert min(requeued) > 0


def test_plain_matches_reference_more_nodes_than_threads():
    _plain_equals_reference(wide_states(), True, "600 nodes")
