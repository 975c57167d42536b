"""``FleetRunner``'s staged host batch: each sim written once, already
padded, into a host batch a launch (page-locked for a card), then copied
with one copy a field (``fleet.engine.stack`` of a staged ``SimState``).

On the CPU the staged batch must equal, bitwise in every field, the
numpy-list path it replaces (``stack([s.pad_to(m, k, fev, ts) ...])``)
at every kind of padding: rows, ``assigned`` width, failure schedules,
telemetry buffers, telemetry-off sims in a telemetry-on batch, one sim,
and the ``devices=["cpu", "cpu"]`` split.  A second grid of smaller sims
written into the first grid's host batch must give what a fresh runner
gives (no stale bytes), counter ``fleet.stage`` counts one host batch a
launch, and a runner holds none between launches.  On the card the
batches are page-locked, a later grid's are the blocks the first grid's
page-locked, ``fleet.h2d`` counts one copy a field, and a mixed grid's
finals equal the numpy-list path's::

    python -m pytest -q -m cuda tests/test_torch_fleet_stage.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.cluster import FailureInjector
from repro_torch.core.job import JobFactory
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, SCHED_EBF, SCHED_FIFO,
                               SCHED_SJF, FleetRunner, SimState)
from repro_torch.fleet.state import INF_I
from repro_torch.fleet import runner as rmod
from repro_torch.fleet.engine import advance, stack, unstack
from repro_torch.telemetry import spans
from repro_torch.workloads.synthetic import SyntheticWorkload

SYS = {"groups": {"a": {"core": 4, "mem": 1024}, "b": {"core": 8, "mem": 2048}},
       "nodes": {"a": 6, "b": 4}}
N_NODES = 10
WIDE = {1: 0.5, 2: 0.3, 4: 0.2}            # assigned width 4
NARROW = {1: 0.6, 2: 0.4}                  # assigned width 2
MID = {1: 0.5, 2: 0.3, 3: 0.2}             # assigned width 3, bucket 4


def _wl(n, seed, nodes=WIDE):
    return SyntheticWorkload(n, seed=seed, mean_interarrival_s=25.0,
                             duration_median_s=900.0, duration_sigma=1.1,
                             node_weights=nodes,
                             resources={"core": (1, 4), "mem": (64, 1024)})


def _sim(n, seed, sc=SCHED_FIFO, ac=ALLOC_FF, nodes=WIDE, fail=False,
         stride=0, horizon=6000):
    extra = dict(failures=FailureInjector(N_NODES, mtbf_s=4000.0,
                                          repair_s=900.0, horizon_s=horizon,
                                          seed=seed),
                 quarantine_s=1800, ckpt_every_s=600) if fail else {}
    return FleetRunner.build(f"s{n}-{seed}-{sc}", _wl(n, seed, nodes), SYS,
                             sc, alloc_id=ac, job_factory=JobFactory(),
                             telemetry_stride=stride, **extra)


# each case: (n jobs, seed, scheduler, node weights, failures, stride)
CASES = {
    "rows": [(30, 3, SCHED_FIFO, WIDE, False, 0),
             (90, 4, SCHED_SJF, WIDE, False, 0),
             (70, 5, SCHED_EBF, WIDE, False, 0)],
    "width": [(40, 6, SCHED_FIFO, NARROW, False, 0),
              (40, 7, SCHED_EBF, WIDE, False, 0)],
    "failures": [(50, 8, SCHED_FIFO, WIDE, True, 0),
                 (60, 9, SCHED_EBF, WIDE, False, 0),
                 (45, 10, SCHED_SJF, NARROW, True, 0)],
    "telemetry": [(50, 11, SCHED_FIFO, WIDE, False, 5),
                  (80, 12, SCHED_EBF, WIDE, False, 3)],
    "telemetry_off_in_on": [(50, 13, SCHED_FIFO, WIDE, False, 0),
                            (70, 14, SCHED_EBF, NARROW, True, 4),
                            (30, 15, SCHED_SJF, WIDE, False, 0)],
    "one_sim": [(55, 16, SCHED_EBF, WIDE, True, 5)],
}
DEVICES = {"cpu": ["cpu"], "cpu_cpu": ["cpu", "cpu"]}


def _grid(case):
    return [_sim(n, seed, sc, nodes=nodes, fail=fail, stride=stride)
            for n, seed, sc, nodes, fail, stride in CASES[case]]


def _shape(sims):
    """The launch shape ``FleetRunner._launch`` pads a batch to."""
    m = rmod._bucket_rows(max(s.state.n_rows for s in sims))
    k = rmod._bucket_width(max(s.state.assigned.shape[1] for s in sims))
    fev = max(s.state.fail_ev.shape[0] for s in sims)
    fev = -(-fev // 16) * 16 if fev else 0
    ts = max(s.state.tele_buf.shape[0] for s in sims)
    ts = -(-ts // rmod._BUCKET_ROWS) * rmod._BUCKET_ROWS if ts else 0
    return m, k, fev, ts


def _list_batch(sims):
    """The numpy-list path: every sim padded to fresh arrays, stacked."""
    m, k, fev, ts = _shape(sims)
    return stack([s.state.pad_to(m, k, fev, ts) for s in sims], "cpu")


def _assert_batches_equal(got, want):
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype == torch.int32, name
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name


def _staged_batches(runner, sims, monkeypatch):
    """What ``stack`` is handed and returns in ``runner.run(sims)`` (one
    launch), with ``advance`` a no-op so the batch stays as staged."""
    got = []
    stack_ = rmod.stack

    def stack_w(states, device):
        assert isinstance(states, SimState)
        batch = stack_(states, device)
        got.append(SimState(*(t.clone() for t in batch)))
        return batch
    monkeypatch.setattr(rmod, "stack", stack_w)
    monkeypatch.setattr(rmod, "advance", lambda batch, *a, **k: batch)
    runner.run(sims, group_by_cost=False)
    return SimState(*(torch.cat(ts) for ts in zip(*got)))


@pytest.mark.parametrize("devices", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_batch_equals_the_numpy_list_path(case, devices,
                                                 monkeypatch):
    sims = _grid(case)
    runner = FleetRunner(devices=DEVICES[devices])
    got = _staged_batches(runner, sims, monkeypatch)
    _assert_batches_equal(got, _list_batch(sims))


def test_pad_to_out_writes_every_element():
    """``pad_to(out=...)`` into a buffer full of junk gives ``pad_to``'s
    fresh arrays, and returns ``out``."""
    state = _grid("telemetry_off_in_on")[1].state
    m, k = state.n_rows + 64, state.assigned.shape[1] + 3
    fev, ts = state.fail_ev.shape[0] + 5, state.tele_buf.shape[0] + 7
    want = state.pad_to(m, k, fev, ts)
    out = SimState(*(np.full(np.shape(a), -7, np.int32) for a in want))
    assert state.pad_to(m, k, fev, ts, out=out) is out
    for name, a, b in zip(want._fields, out, want):
        assert np.array_equal(a, np.asarray(b).astype(np.int32)), name


def test_pad_to_out_refuses_other_shapes():
    state = _sim(40, 3).state
    m, k = state.n_rows, state.assigned.shape[1]
    want = state.pad_to(m + 64, k)
    out = SimState(*(np.zeros(np.shape(a), np.int32) for a in want))
    with pytest.raises(ValueError, match="out is not"):
        state.pad_to(m + 128, k, out=out)
    with pytest.raises(ValueError, match="cannot shrink"):
        state.pad_to(m - 1, k, out=out)


def test_pad_to_without_out_is_unchanged():
    """Without ``out``, an unpadded state is returned as is and a padded
    one gets fresh arrays that leave the state alone."""
    state = _sim(40, 3, fail=True, stride=5).state
    m, k = state.n_rows, state.assigned.shape[1]
    f, s = state.fail_ev.shape[0], state.tele_buf.shape[0]
    assert state.pad_to(m, k, f, s) is state
    before = [np.array(a, copy=True) for a in state]
    padded = state.pad_to(m + 64, k + 2, f + 16, s + 64)
    assert all(not np.shares_memory(a, b) for a, b in zip(padded, state))
    for a, b in zip(state, before):
        assert np.array_equal(a, b)
    assert padded.n_rows == m + 64 and padded.assigned.shape[1] == k + 2
    assert (padded.assigned[:, k:] == state.n_nodes).all()
    assert (padded.fail_ev[f:, 0] == INF_I).all()


@pytest.fixture
def kept_stages(monkeypatch):
    """``fleet.runner._stage`` handing the same host batch out again for
    a launch shape it has served, as the caching host allocator hands
    out a kept page-locked block on the card; yields the batches
    kept (``kept``, by shape) and served (``served``, in order)."""
    stage_ = rmod._stage
    st = SimpleNamespace(kept={}, served=[])

    def stage_w(*shape, pin):
        host = st.kept.get(shape)
        if host is None:
            host = st.kept[shape] = stage_(*shape, pin=pin)
        st.served.append(host)
        return host
    monkeypatch.setattr(rmod, "_stage", stage_w)
    return st


def test_a_reused_stage_keeps_no_stale_bytes(kept_stages):
    """Grid A then grid B through one runner, at one launch shape and
    into one host batch, B's sims with fewer rows and a narrower
    ``assigned``: B's result is a fresh runner's, field for field."""
    a = [_sim(120, 21, SCHED_FIFO), _sim(110, 22, SCHED_EBF, fail=True)]
    b = [_sim(70, 23, SCHED_SJF, nodes=MID),
         _sim(66, 24, SCHED_EBF, nodes=MID, fail=True, horizon=4000)]
    assert _shape(a) == _shape(b)
    assert all(sb.state.n_rows < sa.state.n_rows and
               sb.state.assigned.shape[1] < sa.state.assigned.shape[1]
               for sa, sb in zip(a, b))
    assert b[1].state.fail_ev.shape[0] < a[1].state.fail_ev.shape[0]
    runner = FleetRunner(device="cpu")
    runner.run(a, group_by_cost=False)
    reused = runner.run(b, group_by_cost=False)
    served = kept_stages.served
    assert len(served) == 2 and served[0] is served[1]
    kept_stages.kept.clear()
    fresh = FleetRunner(device="cpu").run(b, group_by_cost=False)
    assert served[2] is not served[0]
    for got, want in zip(reused.finals, fresh.finals):
        for name, x, y in zip(got._fields, got, want):
            assert np.array_equal(x, y), name
    assert [reused.summary(i)["events"] for i in range(2)] == \
        [fresh.summary(i)["events"] for i in range(2)]


def test_the_batch_never_aliases_the_stage(kept_stages):
    """A staged batch on the CPU is a copy: the kernel's in-place updates
    leave the host batch alone, and the finals outlive the next grid
    written into it."""
    sims = _grid("rows")
    runner = FleetRunner(device="cpu")
    first = runner.run(sims, group_by_cost=False)
    keep = [np.array(a, copy=True) for a in first.finals[0]]
    served = kept_stages.served
    for t in served[0]:
        for f in first.finals:
            assert not any(np.shares_memory(t.numpy(), np.asarray(a))
                           for a in f if np.ndim(a))
    runner.run(list(reversed(sims)), group_by_cost=False)
    assert served[1] is served[0]
    for a, b in zip(first.finals[0], keep):
        assert np.array_equal(a, b)


@pytest.fixture
def traced():
    spans.disable()
    spans.reset()
    spans.enable()
    yield
    spans.disable()
    spans.reset()


def _launch_bytes(sims):
    """The host batch's bytes of each cost class's launch."""
    out = []
    for group in ([s for s in sims if s.sched_id != SCHED_EBF],
                  [s for s in sims if s.sched_id == SCHED_EBF]):
        m, k, fev, ts = _shape(group)
        n, r = group[0].state.avail.shape
        out.append(4 * len(group) * sum(
            int(np.prod(shape)) for shape in
            SimState._shapes(m, n, r, k, fev, ts).values()))
    return out


@pytest.mark.parametrize("grids", [1, 3])
def test_stage_counts_one_allocation_then_reuses(traced, grids):
    """Two launch shapes (blocking and EBF, different sizes): counter
    ``fleet.stage`` counts one host batch a launch, grid after grid,
    with its bytes, and ``fleet.h2d`` copies those bytes.  On the card
    the caching host allocator serves every batch after the first
    grid's from the blocks it keeps (``test_card_stage_*``)."""
    sims = [_sim(40, 31, SCHED_FIFO), _sim(40, 32, SCHED_SJF, ALLOC_BF),
            _sim(40, 33, SCHED_EBF)]
    runner = FleetRunner(device="cpu")
    for _ in range(grids):
        runner.run(sims)
    tot = spans.totals()
    per_grid = _launch_bytes(sims)
    assert per_grid[0] != per_grid[1]
    assert tot["fleet.stage"]["count"] == 2 * grids
    assert tot["fleet.stage"]["bytes"] == sum(per_grid) * grids
    assert tot["fleet.stage"]["seconds"] > 0
    assert tot["fleet.h2d"]["bytes"] == sum(per_grid) * grids


def test_stages_held_stay_bounded(traced, monkeypatch):
    """A runner holds no host batch between launches: each is freed once
    its launch has copied it (on the card the caching host allocator
    keeps the block for the next launch of its size)."""
    import gc
    import weakref

    stage_ = rmod._stage
    refs = []

    def stage_w(*shape, pin):
        host = stage_(*shape, pin=pin)
        refs.extend(weakref.ref(t) for t in host)
        return host
    monkeypatch.setattr(rmod, "_stage", stage_w)
    runner = FleetRunner(device="cpu")
    sizes = [40, 100, 160]
    for n in sizes + sizes[:1]:
        res = runner.run([_sim(n, 40 + n, SCHED_FIFO)])
        gc.collect()
        assert refs and all(r() is None for r in refs)
        assert res.finals[0].n_rows >= n
    assert spans.totals()["fleet.stage"]["count"] == len(sizes) + 1


def test_off_the_stage_counts_nothing():
    spans.disable()
    spans.reset()
    FleetRunner(device="cpu").run(_grid("rows"))
    assert "fleet.stage" not in spans.totals()
    assert "fleet.h2d" not in spans.totals()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _mixed():
    return [_sim(300, 51, SCHED_FIFO), _sim(260, 52, SCHED_EBF, fail=True),
            _sim(200, 53, SCHED_SJF, ALLOC_BF, NARROW, stride=5),
            _sim(280, 54, SCHED_EBF, ALLOC_BF, stride=3),
            _sim(240, 55, SCHED_FIFO, nodes=NARROW, fail=True)]


@pytest.mark.cuda
def test_card_stage_is_pinned_and_copies_once_a_field(cuda_dev, traced,
                                                       monkeypatch):
    """The host batches are page-locked, ``fleet.h2d`` copies each field
    once a launch with the batch's bytes, and a grid after the first
    stages into blocks the first grid's launches page-locked (the
    caching host allocator's reuse)."""
    staged = []                  # (block, pinned), holding no tensor
    stack_ = rmod.stack

    def stack_w(states, device):
        staged.extend((t.untyped_storage().data_ptr(), t.is_pinned())
                      for t in states)
        return stack_(states, device)
    monkeypatch.setattr(rmod, "stack", stack_w)
    sims = _mixed()
    runner = FleetRunner()
    runner.run(sims)
    first = {ptr for ptr, _ in staged}
    spans.reset()
    staged.clear()
    for _ in range(2):
        FleetRunner().run(sims)
    assert all(pinned for _, pinned in staged)
    assert {ptr for ptr, _ in staged} <= first
    tot = spans.totals()
    n_fields = len(SimState._fields)
    n_dev = len(runner.devices)
    assert tot["fleet.launch"]["count"] == 4
    assert tot["fleet.h2d"]["count"] == n_fields * 4 * n_dev
    assert tot["fleet.stage"]["count"] == 4
    assert tot["fleet.h2d"]["bytes"] == tot["fleet.stage"]["bytes"] == \
        2 * sum(_launch_bytes(sims))
    assert tot["fleet.h2d"]["seconds"] > 0


@pytest.mark.cuda
def test_card_finals_equal_the_numpy_list_path(cuda_dev):
    sims = _mixed()
    got = FleetRunner(device="cuda").run(sims, group_by_cost=False)
    m, k, fev, ts = _shape(sims)
    want = unstack(advance(stack([s.state.pad_to(m, k, fev, ts)
                                  for s in sims], cuda_dev)))
    for i, (g, w) in enumerate(zip(got.finals, want)):
        for name, x, y in zip(g._fields, g, w):
            assert np.array_equal(x, y), (i, name)
