"""The fleet engine: the whole event loop of a simulation on the device.

The host simulator pays a host round trip per event; this engine runs
every event of a simulation with no host work in between: next-event
time, completion release, failure drain, submission batch and a full
dispatch round.  On the card it is ONE hand-written CUDA kernel
(``kernels/csrc/fleet_engine.cu``) that runs a whole simulation per
thread block, so a grid of dispatcher x seed sims is one launch and
every sim runs at its own pace.

Covered dispatchers: {FIFO, SJF, LJF, EBF} (``sched_code``) x {FirstFit,
BestFit} (``alloc_code``) — the paper's full Table-2 policy set.

**Scheduling.**  The blocking policies take queued jobs in priority
order and stop at the first allocation failure.  The order is the
host's lexicographic key, materialized as per-row positions by
:func:`_priority_order`:

    FIFO  fifo_rank
    SJF   (est,  queued_time, fifo_rank)
    LJF   (-est, queued_time, fifo_rank)
    EBF   fifo_rank                          # FIFO priority

**EASY-backfilling** extends the round: when the greedy phase hits its
first blocked job (the *head*), the shadow walk
(``kernels.ebf_shadow.shadow_walk``: one estimated release per trip,
tie-grouped exactly like the host scan) finds the earliest instant the
head fits, the allocator reserves the head's nodes at that instant, and
the round switches to a backfill phase: remaining queued jobs (FIFO
order, tracked by a rank cursor) start iff they fit *now* and either
finish (by estimate) before the shadow time or fit inside
``min(avail, extra)``, the resources the reservation leaves free.

**Allocation.**  FirstFit takes the first ``need`` fitting nodes by node
id; BestFit the first ``need`` fitting nodes busiest first: a per-node
load ``sum_r (cap - pool) / max(cap, 1)`` in float32, correctly rounded
and summed in r order (the ``alloc_score`` kernel's arithmetic, pinned
trace-equal to the host's float64), ordered by a stable descending sort
(ties by node id).  ``use_kernel=True`` ANDs each round's fit bits of
the whole queue against the round-start availability (the
``alloc_score`` kernel's device code) into every probe but the head's
reservation at shadow time, whose pool can exceed the round-start
availability.  Every other pool is at most the round-start
availability, so the live recheck binds and decisions do not change.

Everything is int32, with ``INF_I = 2**30`` as the masked-minimum
sentinel.  Without failures every outer iteration admits a submission or
retires a completion, so the loop runs at most ``2M + 8`` steps (the
runaway guard); a failure schedule adds ``F (M + 1)``.

:func:`advance_plain` is the plain PyTorch version, a step-by-step twin
of the reference's ``lax.while_loop`` body for one sim; it runs for CPU
tensors and is what the kernel is held against.  :func:`advance` runs a
batch: CUDA tensors launch the kernel, CPU tensors run the plain
version, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import build, counters, ref
from ..kernels.ebf_shadow import shadow_walk
from ..kernels.ops import resolve_device
from .state import (COMPLETED, INF_I, QUEUED, REJECTED, RUNNING, SimState,
                    UNSET_I)

SCHED_FIFO, SCHED_SJF, SCHED_LJF, SCHED_EBF = 0, 1, 2, 3
SCHED_NAMES = {SCHED_FIFO: "FIFO", SCHED_SJF: "SJF", SCHED_LJF: "LJF",
               SCHED_EBF: "EBF"}

ALLOC_FF, ALLOC_BF = 0, 1
ALLOC_NAMES = {ALLOC_FF: "FF", ALLOC_BF: "BF"}

INF = int(INF_I)


# ----------------------------------------------------------------------
# compilability contract
# ----------------------------------------------------------------------
def dispatch_code(scheduler) -> Optional[Tuple[int, int]]:
    """``(sched_code, alloc_code)`` for ``scheduler``, or None if it
    cannot be lowered onto the compiled loop.

    Compilable = exactly one of FIFO/SJF/LJF/EBF (subclasses may
    override ``plan`` arbitrarily, so only the exact types qualify) with
    exactly a ``FirstFit`` or ``BestFit`` allocator and no
    ``observe_completion`` hook (data-driven schedulers need the host
    callback stream).
    """
    from ..core.dispatchers.allocators import BestFit, FirstFit
    from ..core.dispatchers.schedulers import (EasyBackfilling,
                                               FirstInFirstOut,
                                               LongestJobFirst,
                                               ShortestJobFirst)

    scodes = {FirstInFirstOut: SCHED_FIFO, ShortestJobFirst: SCHED_SJF,
              LongestJobFirst: SCHED_LJF, EasyBackfilling: SCHED_EBF}
    acodes = {FirstFit: ALLOC_FF, BestFit: ALLOC_BF}
    sc = scodes.get(type(scheduler))
    if sc is None:
        return None
    ac = acodes.get(type(getattr(scheduler, "allocator", None)))
    if ac is None:
        return None
    if getattr(scheduler, "observe_completion", None) is not None:
        return None
    return sc, ac


def sched_code(scheduler) -> Optional[int]:
    """Engine scheduler code for a compilable ``scheduler`` (None if the
    dispatcher — scheduler OR allocator — cannot be lowered)."""
    pair = dispatch_code(scheduler)
    return None if pair is None else pair[0]


def alloc_code(scheduler) -> Optional[int]:
    """Engine allocator code for a compilable ``scheduler`` (None if the
    dispatcher cannot be lowered)."""
    pair = dispatch_code(scheduler)
    return None if pair is None else pair[1]


def compiles(scheduler) -> bool:
    """Whether ``scheduler`` can run on the compiled fleet engine."""
    return dispatch_code(scheduler) is not None


# ----------------------------------------------------------------------
# the plain version (one sim, torch ops)
# ----------------------------------------------------------------------
def _priority_order(s: Dict) -> torch.Tensor:
    """Per-row priority positions of the active policy.

    Rows already admitted keep their ``fifo_rank``/``queued_time``; rows
    still pending get the rank the admit loop will hand them
    (``rank_ctr + position - ptr``) and their submit time; other rows
    get rank 0.  FIFO and EBF use the ranks themselves; SJF and LJF the
    position of each row in the lexsort by (key, queued time, rank),
    stable by row.
    """
    submit = s["submit"]
    m = submit.shape[0]
    dev = submit.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    future = (pos >= s["ptr"]) & (pos < s["n_pending"])
    tgt = torch.where(future, s["pending"], m).long()
    rank = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    rank[tgt] = (s["rank_ctr"] + pos - s["ptr"]).to(torch.int32)
    rank = rank[:m]
    rank = torch.where(s["fifo_rank"] < INF, s["fifo_rank"], rank)
    sched = min(max(s["sched_id"], 0), 3)
    if sched in (SCHED_FIFO, SCHED_EBF):
        return rank
    qt = torch.where(s["queued_time"] >= 0, s["queued_time"], submit)
    key = s["est"] if sched == SCHED_SJF else -s["est"]
    order = torch.argsort(rank, stable=True)
    order = order[torch.argsort(qt[order], stable=True)]
    order = order[torch.argsort(key[order], stable=True)]
    pri = torch.empty(m, dtype=torch.int32, device=dev)
    pri[order] = pos
    return pri


def _load(pool: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Best-Fit load per node: float32, correctly rounded, r order."""
    used = (capacity - pool).to(torch.float32)
    cap = torch.clamp(capacity, min=1).to(torch.float32)
    frac = used / cap
    load = frac[:, 0].clone()
    for r in range(1, frac.shape[1]):
        load = load + frac[:, r]
    return load


def _select_nodes(alloc_id, pool, capacity, reqv, need, k_cap, pref=None,
                  elig=None):
    """Allocator probe against ``pool``: FirstFit (node-id order) or
    BestFit (busiest-first stable order).  Returns ``(ok, sel bool[N],
    nodes int32[K])`` with ``nodes`` padded with N; ``pref`` (bool[N])
    ANDs the round's fit prefilter, ``elig`` (bool[N]) the node
    eligibility of the failure schedule."""
    n = pool.shape[0]
    dev = pool.device
    fitn = (pool >= reqv[None, :]).all(dim=1)
    if pref is not None:
        fitn = fitn & pref
    if elig is not None:
        fitn = fitn & elig
    if alloc_id == ALLOC_BF:
        order = torch.argsort(-_load(pool, capacity), stable=True)
    else:
        order = torch.arange(n, device=dev)
    fit_o = fitn[order]
    csum = torch.cumsum(fit_o.to(torch.int32), 0)
    ok = int(csum[-1]) >= need
    sel_o = fit_o & (csum <= need)
    slots = torch.where(sel_o, csum - 1, k_cap).long()
    nodes = torch.full((k_cap + 1,), n, dtype=torch.int32, device=dev)
    nodes[slots] = order.to(torch.int32)
    sel = torch.zeros(n, dtype=torch.bool, device=dev)
    sel[order] = sel_o
    return ok, sel, nodes[:k_cap]


def _commit(s, w, idx, sel, nodes, reqv, t):
    """Start row ``idx`` at ``t`` on ``nodes``; returns the decrement."""
    dec = sel[:, None].to(torch.int32) * reqv[None, :]
    w["avail"] -= dec
    w["state"][idx] = RUNNING
    w["start"][idx] = t
    w["end"][idx] = t + int(s["duration"][idx])
    w["assigned"][idx] = nodes
    return dec


def _dispatch_round(s, w, t, fit_round, pri, q0, elig, stats):
    """One dispatch round at event time ``t``: greedy starts until the
    first blocked job; for EBF the shadow walk, the head's reservation
    and the backfill behind it.  Updates ``w`` (state, start, end,
    assigned, avail, n_started) and returns the jobs started; appends
    the four phase counters to ``stats`` when it is a list."""
    k_cap = w["assigned"].shape[1]
    alloc_id = s["alloc_id"]
    req, n_need, fifo_rank = s["req"], s["n_need"], s["fifo_rank"]
    pref_of = (lambda i: None) if fit_round is None else \
        (lambda i: fit_round[i])

    # phase 1: greedy starts until the first blocked candidate
    started_evt, q_cnt, idx_h = 0, q0, 0
    go = q0 > 0
    while go:
        queued = w["state"] == QUEUED
        idx = int(torch.argmin(torch.where(queued, pri, INF)))
        has_cand = q_cnt > 0
        reqv, need = req[idx], int(n_need[idx])
        ok_fit, sel, nodes = _select_nodes(
            alloc_id, w["avail"], s["capacity"], reqv, need, k_cap,
            pref_of(idx), elig)
        ok = has_cand and ok_fit
        if ok:
            _commit(s, w, idx, sel, nodes, reqv, t)
            w["n_started"] += 1
            started_evt += 1
            q_cnt -= 1
        idx_h = idx
        go = ok and q_cnt > 0

    # phase 2: EBF shadow walk + head reservation (once)
    state = w["state"]
    queued = state == QUEUED
    has_head = s["sched_id"] == SCHED_EBF and q_cnt > 0
    head_req, head_need = req[idx_h], int(n_need[idx_h])
    running = state == RUNNING
    rel = torch.where(running & has_head,
                      torch.clamp(w["start"] + s["est"], min=t + 1),
                      INF).to(torch.int32)
    found, shadow_t, sh_avail = shadow_walk(
        w["avail"], rel, w["assigned"], req, head_req, head_need,
        node_ok=elig)
    _, sel_h, _ = _select_nodes(alloc_id, sh_avail, s["capacity"],
                                head_req, head_need, k_cap, None, elig)
    enter_bf = has_head and found
    if enter_bf:
        extra = sh_avail - sel_h[:, None].to(torch.int32) * head_req[None, :]
    else:
        extra = torch.zeros_like(w["avail"])
    before_all = t + s["est"] <= shadow_t
    cursor = int(fifo_rank[idx_h])
    go = enter_bf and bool((queued & (fifo_rank > cursor)).any())

    # phase 3: backfill behind the reservation
    bf_admits = 0
    while go:
        avail = w["avail"]
        queued = w["state"] == QUEUED
        pool_b = torch.minimum(avail, extra)
        fit_a = (avail[None, :, :] >= req[:, None, :]).all(dim=2)
        fit_b = (pool_b[None, :, :] >= req[:, None, :]).all(dim=2)
        if elig is not None:
            fit_a = fit_a & elig[None, :]
            fit_b = fit_b & elig[None, :]
        cnt_a = fit_a.sum(dim=1, dtype=torch.int32)
        cnt_b = fit_b.sum(dim=1, dtype=torch.int32)
        can_start = torch.where(before_all, cnt_a, cnt_b) >= n_need
        bf_cand = queued & (fifo_rank > cursor) & can_start
        idx = int(torch.argmin(torch.where(bf_cand, fifo_rank, INF)))
        has_cand = bool(bf_cand.any())
        reqv, need = req[idx], int(n_need[idx])
        before_shadow = bool(before_all[idx])
        pool = avail if before_shadow else pool_b
        ok_fit, sel, nodes = _select_nodes(
            alloc_id, pool, s["capacity"], reqv, need, k_cap, pref_of(idx),
            elig)
        ok = has_cand and ok_fit
        if ok:
            dec = _commit(s, w, idx, sel, nodes, reqv, t)
            if not before_shadow:
                extra = extra - dec
            w["n_started"] += 1
            started_evt += 1
            bf_admits += 1
        if has_cand:
            cursor = int(fifo_rank[idx])
        more_bf = bool(((w["state"] == QUEUED) & (fifo_rank > cursor)
                        & can_start).any())
        go = has_cand and more_bf

    if isinstance(stats, list):
        # phase counters (the host planners count the same quantities)
        greedy_started = started_evt - bf_admits
        disp = greedy_started + int(q_cnt > 0)
        if has_head:
            sh = int(((rel <= shadow_t) & (rel < INF)).sum()) if found \
                else int((rel < INF).sum())
            mis = (q0 - greedy_started - 1) - bf_admits
        else:
            sh = mis = 0
        stats.extend((disp, sh, bf_admits, mis))
    return started_evt


def _fail_drain(s, w, t):
    """FAIL/REPAIR events with time <= t, one per trip: a FAIL preempts
    and requeues its node's running jobs (checkpoint credit, re-ranked
    behind the queue in their old rank order) and quarantines the node;
    a REPAIR brings it back."""
    m = w["state"].shape[0]
    f_cap = s["fail_ev"].shape[0]
    dev = w["state"].device
    req = s["req"]
    while True:
        fptr = w["fptr"]
        ev = s["fail_ev"][min(max(fptr, 0), f_cap - 1)]
        ev_t, v, kind = int(ev[0]), int(ev[1]), int(ev[2])
        if not (fptr < s["n_fail"] and ev_t <= t and t < INF):
            return
        up_v = int(w["node_up"][v]) > 0
        do_fail = kind == 1 and up_v
        do_rep = kind == 0 and not up_v
        state, assigned = w["state"], w["assigned"]
        vm = (state == RUNNING) & (assigned == v).any(dim=1) if do_fail \
            else torch.zeros(m, dtype=torch.bool, device=dev)
        nv = int(vm.sum())
        if nv:
            rows = torch.nonzero(vm).flatten()
            nodes = assigned[rows].long()
            vecs = req[rows][:, None, :].expand(-1, nodes.shape[1], -1)
            keep = nodes < w["avail"].shape[0]
            w["avail"].index_add_(0, nodes[keep], vecs[keep])
            ran = ev_t - w["start"]
            ck = s["ckpt_every_s"]
            dur = w["duration"]
            saved = (ran // max(ck, 1)) * ck if ck > 0 \
                else torch.zeros_like(ran)
            saved = torch.minimum(saved, torch.clamp(dur - 1, min=0))
            new_dur = torch.clamp(dur - saved, min=1)
            w["lost_work_s"] += int(torch.where(
                vm, ran - (dur - new_dur), 0).sum())
            w["duration"] = torch.where(vm, new_dur, dur).to(torch.int32)
            key = torch.where(vm, w["fifo_rank"], INF)
            order = torch.argsort(key, stable=True)
            pos = torch.arange(m, dtype=torch.int32, device=dev)
            newr = torch.where(pos < nv, w["rank_ctr"] + pos,
                               w["fifo_rank"][order]).to(torch.int32)
            w["fifo_rank"][order] = newr
            w["rank_ctr"] += nv
            w["state"] = torch.where(vm, QUEUED, state).to(torch.int32)
            w["start"] = torch.where(vm, UNSET_I, w["start"]).to(torch.int32)
            w["end"] = torch.where(vm, INF, w["end"]).to(torch.int32)
            w["assigned"] = torch.where(vm[:, None], w["avail"].shape[0],
                                        assigned).to(torch.int32)
            w["n_started"] -= nv
            w["n_requeued"] += nv
        if do_rep:
            w["node_downtime_s"] += ev_t - int(w["down_since"][v])
            w["node_up"][v] = 1
            w["down_since"][v] = -1
        if do_fail:
            w["node_up"][v] = 0
            w["quar_until"][v] = ev_t + s["quarantine_s"]
            w["down_since"][v] = ev_t
        w["fptr"] = fptr + 1


_VARYING = ("state", "queued_time", "start", "end", "fifo_rank", "assigned",
            "avail", "duration", "pri", "node_up", "quar_until",
            "down_since", "log_t", "log_queue", "log_running", "log_started",
            "tele_buf")


def advance_plain(state: SimState, use_kernel: bool = False) -> SimState:
    """Run ONE sim (a :class:`SimState` of unbatched tensors, on any
    device) to completion with torch ops; returns the final state.  The
    step-by-step twin of the reference's jitted loop, and the plain
    version the CUDA kernel is held against."""
    names = SimState._fields
    s = {k: (v if v.dim() else int(v)) for k, v in zip(names, state)}
    w = {k: (v.clone() if k in _VARYING else v) for k, v in s.items()}
    m = s["submit"].shape[0]
    n, r = s["avail"].shape
    e = s["log_t"].shape[0]
    f_cap = s["fail_ev"].shape[0]
    tele_cap = s["tele_buf"].shape[0]
    has_fail, has_tele = f_cap > 0, tele_cap > 0
    guard = 2 * m + 8 + (f_cap * (m + 1) if has_fail else 0)

    def view():
        return {**s, **w}

    w["pri"] = _priority_order(view())

    def alive():
        go = w["ptr"] < s["n_pending"] or bool((w["state"] == RUNNING).any())
        if has_fail:
            queued = w["n_submitted"] - w["n_rejected"] - w["n_started"]
            go = go or (queued > 0 and w["fptr"] < s["n_fail"])
        return w["steps"] < guard and go

    while alive():
        # ---- next event time: min(submission, completion, failure)
        pidx = int(s["pending"][min(max(w["ptr"], 0), m - 1)])
        t_sub = int(s["submit"][pidx]) if w["ptr"] < s["n_pending"] else INF
        running = w["state"] == RUNNING
        t = min(t_sub, int(torch.where(running, w["end"], INF).min()))
        if has_fail:
            n_live = w["n_submitted"] - w["n_rejected"] - w["n_completed"]
            if w["fptr"] < s["n_fail"] and n_live > 0:
                t = min(t, int(s["fail_ev"][min(max(w["fptr"], 0),
                                                 f_cap - 1), 0]))

        # ---- completions, one at a time (lowest row on ties)
        while True:
            ends = torch.where(w["state"] == RUNNING, w["end"], INF)
            idx = int(torch.argmin(ends))
            emin = int(ends[idx])
            if not (emin <= t and emin < INF):
                break
            nodes = w["assigned"][idx].long()
            nodes = nodes[nodes < n]
            w["avail"].index_add_(0, nodes,
                                  s["req"][idx].expand(nodes.shape[0], -1))
            w["state"][idx] = COMPLETED
            w["n_completed"] += 1

        # ---- failure drain, then the eligibility at t
        elig = None
        if has_fail:
            _fail_drain(s, w, t)
            w["pri"] = _priority_order(view())
            elig = (w["node_up"] > 0) & (w["quar_until"] <= t)

        # ---- submission batch, one row per trip in (T_sb, seq) order
        while True:
            row = int(s["pending"][min(max(w["ptr"], 0), m - 1)])
            if not (w["ptr"] < s["n_pending"] and int(s["submit"][row]) <= t):
                break
            unfit = int(s["unfit"][row]) > 0
            w["state"][row] = REJECTED if unfit else QUEUED
            if not unfit:
                w["queued_time"][row] = t
            w["fifo_rank"][row] = w["rank_ctr"]
            w["ptr"] += 1
            w["rank_ctr"] += 1
            w["n_submitted"] += 1
            w["n_rejected"] += int(unfit)

        # ---- dispatch round
        q0 = w["n_submitted"] - w["n_rejected"] - w["n_started"]
        fit_round = None
        if use_kernel:
            bits, _ = ref.alloc_score_packed_ref(w["avail"], s["capacity"],
                                                 s["req"])
            fit_round = ref.unpack_bits(bits, n) > 0
        stats = [] if has_tele else None
        started_evt = _dispatch_round(view(), w, t, fit_round, w["pri"], q0,
                                      elig, stats)
        if q0 > 0:
            w["n_rounds"] += 1

        # ---- per-event log
        i = min(max(w["n_events"], 0), e - 1)
        w["log_t"][i] = t
        w["log_queue"][i] = q0 - started_evt
        w["log_running"][i] = w["n_started"] - w["n_completed"]
        w["log_started"][i] = started_evt

        if has_tele:
            stride = s["tele_stride"]
            if (stride > 0 and w["tele_n"] < tele_cap
                    and w["n_events"] % max(stride, 1) == 0):
                w["tele_buf"][w["tele_n"]] = _tele_row(
                    t, q0 - started_evt, w)
                w["tele_n"] += 1
            disp, sh, bf, mis = stats
            w["ct_disp_trips"] += disp
            w["ct_shadow_trips"] += sh
            w["ct_backfill"] += bf
            w["ct_misfit"] += mis
        w["now"] = t
        w["n_events"] += 1
        w["steps"] += 1

    if has_fail:
        # host livelock parity: queued jobs that outlast every event are
        # rejected, with no event counted
        leftover = w["state"] == QUEUED
        w["state"] = torch.where(leftover, REJECTED, w["state"]).to(
            torch.int32)
        w["n_rejected"] += int(leftover.sum())
    if has_tele:
        stride = s["tele_stride"]
        if (stride > 0 and w["n_events"] > 0 and w["tele_n"] < tele_cap
                and (w["n_events"] - 1) % max(stride, 1) != 0):
            queue_now = w["n_submitted"] - w["n_rejected"] - w["n_started"]
            w["tele_buf"][w["tele_n"]] = _tele_row(w["now"], queue_now, w)
            w["tele_n"] += 1

    dev = state.submit.device
    return SimState(**{
        k: (v if isinstance(v, torch.Tensor)
            else torch.tensor(v, dtype=torch.int32, device=dev))
        for k, v in w.items()})


def _tele_row(t, queue, w) -> torch.Tensor:
    """One telemetry sample: t, queue, running, started_cum,
    requeued_cum, free per resource type."""
    head = torch.tensor([t, queue, w["n_started"] - w["n_completed"],
                         w["n_started"] + w["n_requeued"], w["n_requeued"]],
                        dtype=torch.int32, device=w["avail"].device)
    return torch.cat([head, w["avail"].sum(dim=0, dtype=torch.int32)])


# ----------------------------------------------------------------------
# batches: stacked int32 tensors, one per field
# ----------------------------------------------------------------------
def stack(states: List[SimState], device) -> SimState:
    """Stack equally shaped numpy states along a leading sim axis into
    one contiguous int32 tensor per field on ``device``."""
    return SimState(*(
        torch.from_numpy(np.ascontiguousarray(np.stack(
            [np.asarray(getattr(s, k)) for s in states]), dtype=np.int32)
        ).to(device)
        for k in SimState._fields))


def unstack(batch: SimState) -> List[SimState]:
    """The numpy states of a stacked batch, one per sim."""
    host = [np.asarray(t.cpu()) for t in batch]
    return [SimState(*(a[i] if a.ndim > 1 else a[i].astype(np.int32)
                       for a in host))
            for i in range(host[0].shape[0])]


def advance(state: SimState, use_kernel: bool = False,
            device=None) -> SimState:
    """Run sims to completion.

    ``state`` is either ONE numpy :class:`SimState` (as the state module
    builds it), run on ``device`` (None means the card) and returned as
    a numpy state; or a batch of tensors with a leading sim axis
    (:func:`stack`), updated in place on their own device and returned.
    CUDA tensors launch the ``fleet_engine`` kernel, once for the whole
    batch; CPU tensors run :func:`advance_plain` sim by sim.
    """
    if not isinstance(state.submit, torch.Tensor):
        batch = stack([state], resolve_device(device))
        return unstack(advance(batch, use_kernel))[0]
    dev = state.submit.device
    if build.launch_target(dev):
        _launch_kernel(state, use_kernel)
        return state
    for b in range(state.submit.shape[0]):
        out = advance_plain(SimState(*(t[b] for t in state)), use_kernel)
        for t, v in zip(state, out):
            t[b] = v
    return state


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------
#: largest node count the kernel takes (its node arrays live in shared
#: memory; the launch also checks the card's per-block limit)
MAX_N = 2048
#: largest resource-type count the kernel takes
MAX_R = 8


def _launch_kernel(batch: SimState, use_kernel: bool) -> None:
    """Launch ``fleet_engine`` on a stacked CUDA batch, in place: one
    thread block per sim."""
    dev = batch.submit.device
    for name, t in zip(SimState._fields, batch):
        build.check_input(t, name, t.dim(), dev)
    b, m = batch.submit.shape
    _, n, r = batch.avail.shape
    k = batch.assigned.shape[2]
    e = batch.log_t.shape[1]
    f = batch.fail_ev.shape[1]
    s = batch.tele_buf.shape[1]
    if n > MAX_N or r > MAX_R:
        raise ValueError(f"fleet_engine takes N <= {MAX_N} and R <= "
                         f"{MAX_R}, got N {n}, R {r}")
    if b == 0:
        return
    lib = build.library("fleet_engine")
    index = build.device_index(dev)
    smem = lib.fleet_engine_shared_bytes(n, r)
    limit = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"fleet_engine: N {n} x R {r} needs {smem} bytes "
                         f"of shared memory per block, the card has {limit}")
    w = -(-n // 32)
    # per sim: a row column, the backfill stamps, the shadow walk's
    # running-row list, and the round's fit bits (use_kernel)
    scratch = torch.empty((b, 3 * m + (m * w if use_kernel else 0)),
                          dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_uint64 * len(batch))(*(t.data_ptr() for t in batch))
    strides = (ctypes.c_int64 * len(batch))(*(t[0].numel() for t in batch))
    stream = torch.cuda.current_stream(index).cuda_stream
    build.check(lib.fleet_engine_launch(
        ctypes.addressof(ptrs), ctypes.addressof(strides), len(batch),
        scratch.data_ptr(), b, m, n, r, k, e, f, s, int(use_kernel), index,
        stream), "fleet_engine")
    counters.record_device("fleet_engine")
