// fleet_engine: every event of a fleet of simulations, one thread block
// per sim, in one launch.
//
// Replaces the TPU engine of src/repro/fleet/engine.py: _advance_impl
// (a jitted lax.while_loop, vmapped over the sims) with _dispatch_round,
// _select_nodes and _priority_order, and the shadow walk of
// src/repro/kernels/ebf_shadow.py (shadow_walk).  The plain PyTorch
// version is repro_torch/fleet/engine.py:advance_plain, and the final
// state must equal it field by field.
//
// What bounds it: latency, not bytes.  An event is a chain of dependent
// steps (next event time, completions, admission, one allocator probe
// per start), each ending in a block barrier, so the design keeps every
// step's work proportional to the rows it concerns (the running rows,
// the queue behind a cursor) instead of the table's M rows, and gives
// each block reduction one barrier.
//
// Layout.  The batch's stacked SimState fields are int32[B, ...] in
// global memory, updated in place; block b runs sim b to its end.  The
// node arrays are avail, capacity, `ext` (the shadow walk's
// availability, then the backfill pool `extra`), `avail0` (the
// round-start availability the prefilter compares against),
// eligibility, slots, a key buffer (the Best-Fit sort, the shadow walk's
// release order, the tiles of the counting sorts), and each warp's table
// of the backfill's dead request shapes.  They live in shared memory
// wherever they fit one block's opt-in limit (shared_bytes; 1024 nodes x
// R 2 take 64 KiB).  Past it (N 2048 x R 8, an Intrepid-sized 40,960
// nodes) the same code runs on a global tier chosen once at launch: the
// arrays move to the sim's scratch, and avail and capacity are the
// SimState's own rows, updated in place.  Per-row columns stay in global
// memory.  Node loops stride over kThreads, so N has no limit of its own;
// Best-Fit keeps its keys in registers up to kMaxN nodes and in the key
// buffer past that.  R up to kMaxR is unrolled in the backfill's counts;
// past it a generic count reads the request from memory.  The block's
// scalars (clock, pointers, counters, list lengths) are replicated in
// every thread's registers: each thread runs the same scalar code on
// values that block reductions broadcast, so only row, list and node
// writes need a barrier.
// Scratch, int32[B, fleet_engine_scratch_ints(M, N, R, device)]: the
// row lists below, two row columns (the failure drain, the priority
// pass, the counting sorts), the shadow walk's release keys where they
// outgrow the key buffer, and on the global tier the node arrays.
//
// Row lists, built from the SimState by one sweep at kernel start (so a
// mid-sim snapshot, a padded lane or a pad_to row needs nothing more)
// and kept across events:
//  * running: rrow[0, rn), in no order, with each row's end (rend) and
//    estimated end start + est (rrel); t_end = min rend is kept with it.
//    Rows join in commit and leave at completion and at failure eviction
//    (an in-place stable compaction).
//  * queued: qrow[0, qn).  Invariant: the live entries (>= 0) are
//    exactly the QUEUED rows, in (fifo_rank, row) order, and none lies
//    before qfirst.  Admission and requeued victims take fresh ranks
//    from rank_ctr, above every rank held, so they are appended; a start
//    tombstones its entry (-1); the list is compacted stably when an
//    append would pass M entries or tombstones outnumber live entries.
//    A row's place in the list stands for its (fifo_rank, row).  Rows
//    without a rank (INF) sort last; they are queued only after a
//    failure re-ranks rows of a host snapshot (whose running rows carry
//    no rank), and while one may be queued (q_inf) an append re-sorts
//    the list instead.  The reference orders such rows its own way: its
//    priority gives them rank 0, and its backfill's argmin over their
//    INF ranks picks row 0.  So while q_inf the greedy pick is an argmin
//    over the live entries (first_queued_rankless), and a backfill pick
//    among them becomes row 0.
//
// The event loop (one trip per event, bounded by the reference's guard
// 2M + 8 + F (M + 1)):
//  1. t = min(next submission, t_end[, next failure event]);
//  2. every running row with end <= t completes (one pass over the
//     running list, then the releases, one (row, node) pair per thread;
//     releases commute, so this equals the reference's one-per-trip
//     loop);
//  3. [kFail] FAIL/REPAIR events with time <= t, one per trip: victims
//     found in the running list, released, given checkpoint credit and
//     re-ranked behind the queue in their old rank order; node health;
//     eligibility at t;
//  4. the pending prefix with submit <= t is admitted in order;
//  5. one dispatch round: greedy starts in priority order until the
//     first failure; for EBF the shadow walk, the head's reservation
//     (without the prefilter) and the backfill behind it;
//  6. the event log, and [kTele] the telemetry sample and counters.
//
// Equivalences with the reference that this design leans on:
//  * priority: the reference materializes per-row positions of a
//    lexsort by (key, queued time, rank) once per sim (and after each
//    failure drain) and takes a masked argmin.  FIFO and EBF take the
//    first live entry of the queue list; SJF and LJF an argmin over the
//    live entries of (key, queued time, list place), which picks the
//    same row, since admission hands out exactly the ranks and queued
//    times the positions were built with.  `pri` is written once, at
//    the end, from the final state.  With no queued row the pick is row
//    0, as jnp.argmin over all-INF.
//  * shadow walk: the running rows sorted once per round by estimated
//    release max(start + est, t + 1); each release group (equal release
//    time) is a contiguous range, released whole (one (row, node) pair
//    per thread) before the head's fit is tested, as the reference tests
//    only when a group is done.
//  * backfill: pools only shrink within a round, so the reference's
//    pick, the lowest-rank queued row behind the cursor that can start
//    now, is the first such row met walking the queue list forward from
//    the cursor; a row that cannot start stays unable to for the rest of
//    the round, and so does any row that needs at least as many nodes,
//    each with at least as much, of a pool no larger: each warp keeps up
//    to 32 such dead shapes a round and skips the rows they cover.  One
//    forward walk per round, kWarps x kPerWarp candidates a step, one
//    warp each, counting fitting nodes with the request in registers and
//    R fixed per instantiation.  A pick whose
//    probe fails (the prefilter) still moves the cursor, as in the
//    reference.
//  * a greedy probe that failed fails again until a pool grows (pools
//    only shrink between completions, evictions and eligibility
//    changes), so its row is not probed again until then (`blocked`).
//  * prefilter (use_kernel): the round's fit bit of a row at a node is
//    alloc_fit::fits against the round-start availability, which the
//    probe evaluates where the reference reads its bit matrix.
//
// Best-Fit order: load per node in float32 (alloc_fit::load), a stable
// descending sort with ties by node id, over 64-bit keys (~orderable(load)
// << 32 | node) of the fitting nodes: the `need` smallest keys by as many
// block minimums, or, when `need` reaches the barrier stages of a bitonic
// sort of the keys, that sort.  FirstFit is a block prefix count over the
// fitting nodes by id.  Both take the first `need` fitting nodes;
// `assigned` is padded with N.
//
// The failure and telemetry code are template flags (kFail = F > 0,
// kTele = S > 0), so with F = 0 and S = 0 it compiles away, as the
// reference's static switches do.  So are the paths past the fast ones
// (kWide: Best-Fit keys past kMaxN nodes, counts past kMaxR types, the
// global tier): fleet_engine.cu builds the instances without them,
// exactly the code of the shapes that fit, and fleet_engine_wide.cu the
// instances with them, for every other shape, in a library of its own
// (built beside the first: its four instances and the fast four in one
// source would double the build).  The wrapper asks
// fleet_engine_needs_wide which library launches.  The launcher selects
// the tensors' device first: this library links its own CUDA runtime.
#pragma once

#ifndef FLEET_ENGINE_WIDE
#error "define FLEET_ENGINE_WIDE (0 or 1) before including fleet_engine.cuh"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "alloc_fit.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 30;
constexpr int kMaxR = 8;         // resource types the backfill unrolls
constexpr int kMaxN = 2048;      // nodes whose Best-Fit keys sit in registers
constexpr int kSortCap = 2048;   // keys the key buffer holds at least
constexpr int kPerWarp = 8;      // backfill candidates a warp takes a step
constexpr int kPerThread = kMaxN / kThreads;   // register keys a thread holds
constexpr long long kMaxInt = 2147483647LL;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kQueued = 1, kRunning = 2, kCompleted = 3, kRejected = 4;
constexpr int kUnset = -1;
constexpr int kNoRank = -2147483647 - 1;

// SimState fields, in the order of repro_torch/fleet/state.py
enum Field {
  SUBMIT, DURATION, EST, N_NEED, STATE, QUEUED_TIME, START, END, FIFO_RANK,
  UNFIT, REQ, ASSIGNED, AVAIL, CAPACITY, PENDING, PTR, N_PENDING, NOW,
  RANK_CTR, SCHED_ID, ALLOC_ID, N_SUBMITTED, N_COMPLETED, N_REJECTED,
  N_STARTED, N_EVENTS, N_ROUNDS, STEPS, LOG_T, LOG_QUEUE, LOG_RUNNING,
  LOG_STARTED, PRI, FAIL_EV, FPTR, N_FAIL, NODE_UP, QUAR_UNTIL, DOWN_SINCE,
  QUARANTINE_S, CKPT_EVERY_S, N_REQUEUED, LOST_WORK_S, NODE_DOWNTIME_S,
  TELE_STRIDE, TELE_N, TELE_BUF, CT_DISP_TRIPS, CT_SHADOW_TRIPS,
  CT_BACKFILL, CT_MISFIT, kFields
};
constexpr int kSchedFifo = 0, kSchedSjf = 1, kSchedLjf = 2, kSchedEbf = 3;
constexpr int kAllocBf = 1;
// pools of an allocator probe
constexpr int kPoolAvail = 0, kPoolBackfill = 1, kPoolShadow = 2;

struct Params {
  int* f[kFields];
  long long stride[kFields];      // elements per sim
  int* scratch;
  long long scratch_stride;
  int M, N, R, K, E, F, S, use_kernel;
  int global;                     // node arrays in scratch, not shared
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// scratch ints per sim for the row lists: rrow, rend, rrel, qrow, two
// row columns, and the release keys of the shadow walk (uint64[pow2 >=
// M]); an even count, so what follows is 8-byte aligned
__host__ __device__ inline long long list_ints(int M) {
  return 6LL * M + 2LL * pow2_at_least(M);
}

// keys of the key buffer: the Best-Fit sort of N nodes, and at least
// kSortCap (the tiles of the counting sorts, short release lists)
__host__ __device__ inline int key_count(int N) {
  const int p = pow2_at_least(N);
  return p > kSortCap ? p : kSortCap;
}

// ints of the node arrays past the key buffer that move to scratch on
// the global tier: ext, avail0, elig, slot and the dead-shape tables
// (avail and capacity stay where the SimState has them)
__host__ __device__ inline long long global_node_ints(int N, int R) {
  return 2LL * N * R + 2LL * N + kWarps * 32LL * (2 + R);
}

__device__ __forceinline__ unsigned flip(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

// descending order of a Best-Fit load as an ascending unsigned key
__device__ __forceinline__ unsigned desc_key(float load) {
  if (load == 0.0f) load = 0.0f;           // -0 ties with +0
  unsigned u = __float_as_uint(load);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;
}

// Partial results of the block reductions.  Each reduction writes one
// of two buffers, alternating per call, passes one barrier and reads
// it back: the reads of a call end before the barrier of the next call,
// which comes before the writes of the call after it to the same buffer.
struct Red {
  unsigned long long hi[2][kWarps];
  unsigned long long lo[2][kWarps];
  int v[2][kWarps];
  int count;
};

// ascending bitonic sort of n (a power of two) keys; the caller's
// writes of `a` must be behind a barrier, and the sort ends with one
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = a[i], y = a[l];
          const bool asc = (i & k) == 0;
          if ((x > y) == asc) { a[i] = y; a[l] = x; }
        }
      }
      __syncthreads();
    }
  }
}

// ----------------------------------------------------------------------
// one sim
// ----------------------------------------------------------------------
template <bool kFail, bool kTele, bool kWide>
struct Sim {
  const Params& p;
  int M, N, R, K, E, F, S, Np2, n_keys;
  // row columns and matrices of this sim
  const int *submit, *est, *n_need, *unfit, *req, *pending, *capacity_g;
  int *duration, *state, *queued_time, *start, *end, *fifo_rank, *assigned;
  int *log_t, *log_queue, *log_running, *log_started, *pri;
  const int* fail_ev;
  int *node_up, *quar_until, *down_since, *tele_buf;
  // scratch: the row lists and two row columns
  int *rrow, *rend, *rrel, *qrow, *col0, *col1;
  unsigned long long* gkey;
  // node arrays: shared memory, or scratch on the global tier
  unsigned long long* key;
  int *avail, *cap, *ext, *avail0, *elig, *slot, *dead;
  Red& red;
  // scalars (replicated in every thread)
  int ptr, n_pending, now, rank_ctr, sched, alloc, n_submitted, n_completed,
      n_rejected, n_started, n_events, n_rounds, steps, fptr, n_fail,
      quarantine_s, ckpt_every_s, n_requeued, lost_work_s, downtime,
      tele_stride, tele_n, ct_disp, ct_shadow, ct_backfill, ct_misfit;
  int rn, t_end, qn, qfirst, ph;
  int blocked;   // a row whose greedy probe failed, while no pool grew
  bool q_inf;

  __device__ Sim(const Params& prm, int b, char* smem, Red& r)
      : p(prm), red(r) {
    M = p.M; N = p.N; R = p.R; K = p.K; E = p.E; F = p.F; S = p.S;
    Np2 = pow2_at_least(N);
    n_keys = key_count(N);
    auto at = [&](int f) { return p.f[f] + b * p.stride[f]; };
    submit = at(SUBMIT); duration = at(DURATION); est = at(EST);
    n_need = at(N_NEED); state = at(STATE); queued_time = at(QUEUED_TIME);
    start = at(START); end = at(END); fifo_rank = at(FIFO_RANK);
    unfit = at(UNFIT); req = at(REQ); assigned = at(ASSIGNED);
    capacity_g = at(CAPACITY); pending = at(PENDING);
    log_t = at(LOG_T); log_queue = at(LOG_QUEUE);
    log_running = at(LOG_RUNNING); log_started = at(LOG_STARTED);
    pri = at(PRI); fail_ev = at(FAIL_EV); node_up = at(NODE_UP);
    quar_until = at(QUAR_UNTIL); down_since = at(DOWN_SINCE);
    tele_buf = at(TELE_BUF);
    int* scr = p.scratch + b * p.scratch_stride;
    rrow = scr; rend = scr + M; rrel = scr + 2 * M; qrow = scr + 3 * M;
    col0 = scr + 4 * M; col1 = scr + 5 * M;
    gkey = reinterpret_cast<unsigned long long*>(scr + 6 * M);
    // keys first (8-byte aligned), then the int arrays; on the global
    // tier avail and capacity are the SimState's own
    const bool global = kWide && p.global;
    key = reinterpret_cast<unsigned long long*>(
        global ? reinterpret_cast<char*>(scr + list_ints(M)) : smem);
    int* q = reinterpret_cast<int*>(key + n_keys);
    if (global) {
      avail = at(AVAIL);
      cap = const_cast<int*>(capacity_g);     // read only
    } else {
      avail = q; q += N * R;
      cap = q; q += N * R;
    }
    ext = q; q += N * R;
    avail0 = q; q += N * R;
    elig = q; q += N;
    slot = q; q += N;
    dead = q;
    auto s = [&](int f) { return *at(f); };
    ptr = s(PTR); n_pending = s(N_PENDING); now = s(NOW);
    rank_ctr = s(RANK_CTR); sched = min(max(s(SCHED_ID), 0), 3);
    alloc = s(ALLOC_ID); n_submitted = s(N_SUBMITTED);
    n_completed = s(N_COMPLETED); n_rejected = s(N_REJECTED);
    n_started = s(N_STARTED); n_events = s(N_EVENTS);
    n_rounds = s(N_ROUNDS); steps = s(STEPS); fptr = s(FPTR);
    n_fail = s(N_FAIL); quarantine_s = s(QUARANTINE_S);
    ckpt_every_s = s(CKPT_EVERY_S); n_requeued = s(N_REQUEUED);
    lost_work_s = s(LOST_WORK_S); downtime = s(NODE_DOWNTIME_S);
    tele_stride = s(TELE_STRIDE); tele_n = s(TELE_N);
    ct_disp = s(CT_DISP_TRIPS); ct_shadow = s(CT_SHADOW_TRIPS);
    ct_backfill = s(CT_BACKFILL); ct_misfit = s(CT_MISFIT);
    rn = 0; t_end = kInf; qn = 0; qfirst = 0; ph = 0; q_inf = false;
    blocked = -1;
  }

  // ------------------------------------------------------------------
  // block reductions, one barrier each (every thread calls them; the
  // result is broadcast)
  // ------------------------------------------------------------------
  __device__ int buf() { const int b = ph; ph ^= 1; return b; }

  // lexicographic minimum of (hi, lo)
  __device__ void min2(unsigned long long& hi, unsigned long long& lo) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long h = __shfl_xor_sync(kFull, hi, o);
      const unsigned long long l = __shfl_xor_sync(kFull, lo, o);
      if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
    }
    const int b = buf();
    if (lane == 0) { red.hi[b][warp] = hi; red.lo[b][warp] = lo; }
    __syncthreads();
    hi = red.hi[b][0];
    lo = red.lo[b][0];
    for (int w = 1; w < kWarps; ++w) {
      const unsigned long long h = red.hi[b][w], l = red.lo[b][w];
      if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
    }
  }

  __device__ unsigned long long min_u64(unsigned long long v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(kFull, v, o);
      v = u < v ? u : v;
    }
    const int b = buf();
    if (lane == 0) red.hi[b][warp] = v;
    __syncthreads();
    v = red.hi[b][0];
    for (int w = 1; w < kWarps; ++w) v = red.hi[b][w] < v ? red.hi[b][w] : v;
    return v;
  }

  __device__ long long sum(long long v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    const int b = buf();
    if (lane == 0) red.hi[b][warp] = static_cast<unsigned long long>(v);
    __syncthreads();
    unsigned long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += red.hi[b][w];
    return static_cast<long long>(s);
  }

  __device__ int min_int(int v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = __reduce_min_sync(kFull, v);
    const int b = buf();
    if (lane == 0) red.v[b][warp] = v;
    __syncthreads();
    int m = red.v[b][0];
    for (int w = 1; w < kWarps; ++w) m = min(m, red.v[b][w]);
    return m;
  }

  // exclusive prefix sum of one int per thread (in thread order); *total
  // receives the block's sum
  __device__ int excl_scan(int v, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int b = buf();
    if (lane == 31) red.v[b][warp] = x;
    __syncthreads();
    int before = 0, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = red.v[b][w];
      before += w < warp ? s : 0;
      tot += s;
    }
    *total = tot;
    return before + x - v;
  }

  // ------------------------------------------------------------------
  // pools and probes
  // ------------------------------------------------------------------
  __device__ bool pool_fits(int mode, int n, const int* q) const {
    if (mode == kPoolAvail) return alloc_fit::fits(avail + n * R, q, R);
    if (mode == kPoolShadow) return alloc_fit::fits(ext + n * R, q, R);
    int ok = 1;
    for (int r = 0; r < R; ++r)
      ok &= (min(avail[n * R + r], ext[n * R + r]) >= q[r]);
    return ok;
  }

  __device__ float pool_load(int mode, int n) const {
    if (mode == kPoolAvail) return alloc_fit::load(cap + n * R, avail + n * R, R);
    if (mode == kPoolShadow) return alloc_fit::load(cap + n * R, ext + n * R, R);
    if constexpr (kWide) {   // alloc_fit::load of min(avail, ext), any R
      const int *c = cap + n * R, *a = avail + n * R, *x = ext + n * R;
      float s = alloc_fit::used_share(c[0], min(a[0], x[0]));
      for (int r = 1; r < R; ++r)
        s = __fadd_rn(s, alloc_fit::used_share(c[r], min(a[r], x[r])));
      return s;
    } else {
      int a[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) a[r] = min(avail[n * R + r], ext[n * R + r]);
      return alloc_fit::load(cap + n * R, a, R);
    }
  }

  // release a running row's request on its nodes into `pool`
  __device__ void release(int* pool, int row) {
    const int* as = assigned + static_cast<long long>(row) * K;
    const int* rq = req + static_cast<long long>(row) * R;
    for (int k = 0; k < K; ++k) {
      const int node = as[k];
      if (node < N)
        for (int r = 0; r < R; ++r) atomicAdd(&pool[node * R + r], rq[r]);
    }
  }

  // Allocator probe of row `row` against `mode`'s pool: slot[n] = the
  // node's place in the assignment (or -1); returns ok.  `pref` ANDs the
  // round's fit bits of the row, eligibility is always ANDed.
  __device__ bool select(int mode, int row, bool pref) {
    const int* q = req + static_cast<long long>(row) * R;
    const int need = n_need[row];
    auto fit_at = [&](int n) {
      bool f = elig[n] && pool_fits(mode, n, q);
      if (pref) f = f && alloc_fit::fits(avail0 + n * R, q, R);
      return f;
    };
    if constexpr (kWide)
      if (alloc == kAllocBf && N > kMaxN)
        return select_bf_wide(fit_at, mode, need);
    if (alloc == kAllocBf) {
      // keys of node c kThreads + threadIdx.x, held in registers
      unsigned long long mk[kPerThread];
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < kPerThread; ++c) {
        const int n = c * kThreads + threadIdx.x;
        mk[c] = kNone;
        bool f = false;
        if (n < N) {
          slot[n] = -1;
          f = fit_at(n);
          if (f)
            mk[c] = (static_cast<unsigned long long>(
                         desc_key(pool_load(mode, n))) << 32) | static_cast<unsigned>(n);
        }
        if (c * kThreads < N) cnt += __syncthreads_count(f);
      }
      // a probe that fails assigns no node
      const int take = cnt >= need ? need : 0;
      const int lg = 31 - __clz(Np2);
      if (take < lg * (lg + 1) / 2) {
        // the `take` smallest keys, one block minimum each: cheaper than
        // the sort's barrier stages
        for (int i = 0; i < take; ++i) {
          unsigned long long m = mk[0];
#pragma unroll
          for (int c = 1; c < kPerThread; ++c) m = mk[c] < m ? mk[c] : m;
          m = min_u64(m);
          const int node = static_cast<int>(m & 0xffffffffu);
          if ((node & (kThreads - 1)) == static_cast<int>(threadIdx.x)) {
#pragma unroll
            for (int c = 0; c < kPerThread; ++c)
              if (c == node / kThreads) mk[c] = kNone;
            slot[node] = i;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kPerThread; ++c) {
          const int n = c * kThreads + threadIdx.x;
          if (n < Np2) key[n] = mk[c];
        }
        __syncthreads();
        bitonic_sort(key, Np2);
        for (int i = threadIdx.x; i < take; i += kThreads)
          slot[static_cast<int>(key[i] & 0xffffffffu)] = i;
      }
      __syncthreads();
      return cnt >= need;
    }
    // FirstFit: a prefix count over the fitting nodes in id order
    const int per = (N + kThreads - 1) / kThreads;
    const int n0 = min(N, threadIdx.x * per), n1 = min(N, n0 + per);
    int mine = 0;
    for (int n = n0; n < n1; ++n) {
      const bool f = fit_at(n);
      slot[n] = f ? 1 : -1;
      mine += f;
    }
    int cnt;
    int base = excl_scan(mine, &cnt);
    for (int n = n0; n < n1; ++n)
      if (slot[n] > 0) {
        slot[n] = base < need ? base : -1;
        ++base;
      }
    __syncthreads();
    return cnt >= need;
  }

  // Best-Fit past kMaxN nodes: the same keys, order and ties as the
  // register path, held in the key buffer.  Each thread keeps the least
  // of its own keys (nodes n = threadIdx.x mod kThreads) and looks again
  // only when a block minimum took it, so a pick costs one reduction.
  template <class FitAt>
  __device__ bool select_bf_wide(const FitAt& fit_at, int mode, int need) {
    __syncthreads();      // the key buffer's last readers (the shadow walk)
    int mine = 0;
    for (int n = threadIdx.x; n < Np2; n += kThreads) {
      unsigned long long k = kNone;
      if (n < N) {
        slot[n] = -1;
        if (fit_at(n)) {
          k = (static_cast<unsigned long long>(desc_key(pool_load(mode, n)))
               << 32) | static_cast<unsigned>(n);
          ++mine;
        }
      }
      key[n] = k;
    }
    const int cnt = static_cast<int>(sum(mine));   // the keys are written
    const int take = cnt >= need ? need : 0;
    const int lg = 31 - __clz(Np2);
    if (take < lg * (lg + 1) / 2) {
      auto least = [&]() {
        unsigned long long m = kNone;
        for (int n = threadIdx.x; n < N; n += kThreads) m = key[n] < m ? key[n] : m;
        return m;
      };
      unsigned long long m = least();
      for (int i = 0; i < take; ++i) {
        const int node = static_cast<int>(min_u64(m) & 0xffffffffu);
        if ((node & (kThreads - 1)) == static_cast<int>(threadIdx.x)) {
          key[node] = kNone;
          slot[node] = i;
          m = least();
        }
      }
    } else {
      bitonic_sort(key, Np2);
      for (int i = threadIdx.x; i < take; i += kThreads)
        slot[static_cast<int>(key[i] & 0xffffffffu)] = i;
    }
    __syncthreads();
    return cnt >= need;
  }

  // start `row` (at queue list place `pos`, or -1) at t on the selected
  // nodes; the pool `extra` shrinks too when `from_extra`
  __device__ void commit(int row, int pos, int t, bool from_extra) {
    const int* q = req + static_cast<long long>(row) * R;
    int* as = assigned + static_cast<long long>(row) * K;
    const int need = n_need[row];
    // A pick with no list place is row 0 picked from an empty queue
    // (q0 counts more rows than are queued: a host snapshot carries
    // n_started = 0).  Like the reference, it starts row 0 again; if row
    // 0 runs already, its running entry is replaced, not doubled.
    int again = -1;
    if (pos < 0) {
      const bool running = state[row] == kRunning;
      __syncthreads();
      if (running) {
        int mine = kInf;
        for (int a = threadIdx.x; a < rn; a += kThreads)
          if (rrow[a] == row) mine = a;
        again = min_int(mine);
      }
    }
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const int s = slot[n];
      if (s >= 0) {
        for (int r = 0; r < R; ++r) {
          avail[n * R + r] -= q[r];
          if (from_extra) ext[n * R + r] -= q[r];
        }
        if (s < K) as[s] = n;
      }
    }
    for (int k = need + threadIdx.x; k < K; k += kThreads) as[k] = N;
    const int fin = t + duration[row];
    const int at = again >= 0 && again < kInf ? again : rn;
    if (threadIdx.x == 0) {
      state[row] = kRunning;
      start[row] = t;
      end[row] = fin;
      if (pos >= 0) qrow[pos] = -1;
      rrow[at] = row;
      rend[at] = fin;
      rrel[at] = t + est[row];
    }
    __syncthreads();
    if (at == rn) {
      ++rn;
      t_end = min(t_end, fin);
    } else {
      int mine = kInf;
      for (int a = threadIdx.x; a < rn; a += kThreads) mine = min(mine, rend[a]);
      t_end = min_int(mine);
    }
  }

  // fitting, eligible nodes of the shadow availability for the head
  __device__ int shadow_fit_count(const int* q) {
    if constexpr (kWide) {
      if (N > kMaxN) {    // one barrier, not one per kThreads nodes
        int mine = 0;
        for (int n = threadIdx.x; n < N; n += kThreads)
          mine += elig[n] && alloc_fit::fits(ext + n * R, q, R);
        return static_cast<int>(sum(mine));
      }
    }
    int cnt = 0;
    for (int base = 0; base < N; base += kThreads) {
      const int n = base + threadIdx.x;
      cnt += __syncthreads_count(n < N && elig[n] &&
                                 alloc_fit::fits(ext + n * R, q, R));
    }
    return cnt;
  }

  // ------------------------------------------------------------------
  // the row lists
  // ------------------------------------------------------------------
  // dst[0, n) = the rows src[0, n) in (fifo_rank, row) order: each row's
  // place is the count of rows before it, a tile of keys at a time
  __device__ void rank_sort(const int* src, int n, int* dst) {
    unsigned long long* tile = key;
    auto rk = [&](int row) {
      return (static_cast<unsigned long long>(flip(fifo_rank[row])) << 32) |
             static_cast<unsigned>(row);
    };
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + threadIdx.x;
      const unsigned long long k = i < n ? rk(src[i]) : kNone;
      int pos = 0;
      for (int tb = 0; tb < n; tb += kThreads) {
        __syncthreads();
        if (tb + threadIdx.x < n) tile[threadIdx.x] = rk(src[tb + threadIdx.x]);
        __syncthreads();
        const int c = min(kThreads, n - tb);
        if (i < n)
          for (int x = 0; x < c; ++x) pos += tile[x] < k;
      }
      if (i < n) dst[pos] = src[i];
    }
    __syncthreads();
  }

  // the queue list anew from the QUEUED rows
  __device__ void rebuild_queue() {
    __syncthreads();
    if (threadIdx.x == 0) red.count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += kThreads)
      if (state[i] == kQueued) col0[atomicAdd(&red.count, 1)] = i;
    __syncthreads();
    const int n = red.count;
    rank_sort(col0, n, qrow);
    qn = n;
    qfirst = 0;
    q_inf = n > 0 && fifo_rank[qrow[n - 1]] >= kInf;
  }

  // both lists from the SimState (one sweep), and t_end
  __device__ void build_lists() {
    if (threadIdx.x == 0) red.count = 0;
    __syncthreads();
    int mine = kInf;
    for (int i = threadIdx.x; i < M; i += kThreads)
      if (state[i] == kRunning) {
        const int a = atomicAdd(&red.count, 1);
        rrow[a] = i;
        rend[a] = end[i];
        rrel[a] = start[i] + est[i];
        mine = min(mine, end[i]);
      }
    t_end = min_int(mine);
    rn = red.count;
    rebuild_queue();
  }

  // drop the tombstones of the queue list, keeping its order
  __device__ void compact_queue() {
    __syncthreads();
    int out = 0;
    for (int base = qfirst; base < qn; base += kThreads) {
      const int a = base + threadIdx.x;
      const int row = a < qn ? qrow[a] : -1;
      int total;
      const int off = excl_scan(row >= 0, &total);
      if (row >= 0) qrow[out + off] = row;
      out += total;
    }
    __syncthreads();
    qn = out;
    qfirst = 0;
  }

  // the live list place of a queued row (-1 if it has none)
  __device__ int place_of(int row) {
    int mine = kInf;
    for (int a = qfirst + threadIdx.x; a < qn; a += kThreads)
      if (qrow[a] == row) mine = a;
    const int a = min_int(mine);
    return a < kInf ? a : -1;
  }

  // the queued row first in priority order, and its list place (row 0
  // and -1 if none is queued)
  __device__ int first_queued(int& pos) {
    if (q_inf) return first_queued_rankless(pos);
    if (sched != kSchedSjf && sched != kSchedLjf) {
      while (qfirst < qn) {
        const int row = qrow[qfirst];
        if (row >= 0) { pos = qfirst; return row; }
        const int a = qfirst + 1 + threadIdx.x;
        const int f = min_int(a < qn && qrow[a] >= 0 ? a : kInf);
        if (f < kInf) {
          qfirst = pos = f;
          return qrow[f];
        }
        qfirst = min(qn, qfirst + 1 + kThreads);
      }
      pos = -1;
      return 0;
    }
    unsigned long long hi = kNone, lo = kNone;
    for (int a = qfirst + threadIdx.x; a < qn; a += kThreads) {
      const int i = qrow[a];
      if (i < 0) continue;
      const int k1 = sched == kSchedSjf ? est[i] : -est[i];
      const int qt = queued_time[i] >= 0 ? queued_time[i] : submit[i];
      const unsigned long long h =
          (static_cast<unsigned long long>(flip(k1)) << 32) | flip(qt);
      if (h < hi || (h == hi && static_cast<unsigned>(a) < lo)) {
        hi = h;
        lo = static_cast<unsigned>(a);
      }
    }
    min2(hi, lo);
    if (lo == kNone) { pos = -1; return 0; }
    pos = static_cast<int>(lo);
    return qrow[pos];
  }

  // first_queued while a rankless row may be queued: the reference's
  // priority gives such a row rank 0 (_priority_order), so it comes
  // first, not last as in the list: an argmin over the live entries of
  // ([key, queued time,] rank or 0, row)
  __device__ int first_queued_rankless(int& pos) {
    const bool keyed = sched == kSchedSjf || sched == kSchedLjf;
    unsigned long long hi = kNone, lo = kNone;
    for (int a = qfirst + threadIdx.x; a < qn; a += kThreads) {
      const int i = qrow[a];
      if (i < 0) continue;
      unsigned long long h = 0;
      if (keyed) {
        const int k1 = sched == kSchedSjf ? est[i] : -est[i];
        const int qt = queued_time[i] >= 0 ? queued_time[i] : submit[i];
        h = (static_cast<unsigned long long>(flip(k1)) << 32) | flip(qt);
      }
      const int rk = fifo_rank[i] < kInf ? fifo_rank[i] : 0;
      const unsigned long long l =
          (static_cast<unsigned long long>(flip(rk)) << 32) | static_cast<unsigned>(i);
      if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
    }
    min2(hi, lo);
    if (lo == kNone) { pos = -1; return 0; }
    const int row = static_cast<int>(lo & 0xffffffffu);
    pos = place_of(row);
    return row;
  }

  // ------------------------------------------------------------------
  // one dispatch round at t
  // ------------------------------------------------------------------
  // the earliest release group after which the head fits in `ext`:
  // returns found; *shadow_t its time, *released the rows released
  __device__ bool shadow_walk(int idx_h, int t, int* shadow_t, int* released) {
    const int* hq = req + static_cast<long long>(idx_h) * R;
    const int need = n_need[idx_h];
    for (int i = threadIdx.x; i < N * R; i += kThreads) ext[i] = avail[i];
    const int L = rn, Lp2 = pow2_at_least(L);
    unsigned long long* rel = Lp2 <= n_keys ? key : gkey;
    for (int a = threadIdx.x; a < Lp2; a += kThreads)
      rel[a] = a < L ? (static_cast<unsigned long long>(
                            flip(max(rrel[a], t + 1))) << 32) |
                           static_cast<unsigned>(a)
                     : kNone;
    __syncthreads();
    bitonic_sort(rel, Lp2);
    // col1[g] = the first place of release group g (a run of equal
    // release times)
    int G = 0;
    for (int base = 0; base < L; base += kThreads) {
      const int a = base + threadIdx.x;
      const bool head = a < L && (a == 0 || (rel[a] >> 32) != (rel[a - 1] >> 32));
      int total;
      const int g = G + excl_scan(head, &total);
      if (head) col1[g] = a;
      G += total;
    }
    __syncthreads();
    *released = L;
    for (int g = 0; g < G; ++g) {
      // release the group, one (row, node slot) pair per thread
      const int g0 = col1[g], g1 = g + 1 < G ? col1[g + 1] : L;
      for (int i = threadIdx.x; i < (g1 - g0) * K; i += kThreads) {
        const int row = rrow[static_cast<int>(rel[g0 + i / K] & 0xffffffffu)];
        const int node = assigned[static_cast<long long>(row) * K + i % K];
        if (node < N)
          for (int r = 0; r < R; ++r)
            atomicAdd(&ext[node * R + r], req[static_cast<long long>(row) * R + r]);
      }
      __syncthreads();
      if (shadow_fit_count(hq) >= need) {
        *shadow_t = static_cast<int>(static_cast<unsigned>(rel[g0] >> 32) ^ 0x80000000u);
        *released = g1;
        return true;
      }
    }
    return false;
  }

  // fitting, eligible nodes of a backfill candidate needing `need` nodes
  // of request q (one warp; kR = R): against avail when it ends before
  // the shadow time, else against min(avail, ext).  Each lane counts its
  // nodes a stretch of 8 at a time, with no test between them, and the
  // warp stops once `need` is reached.
  template <int kR>
  __device__ int count_fits(const int (&q)[kMaxR], bool before, int need) {
    const int lane = threadIdx.x & 31;
    int cnt = 0;
    for (int n0 = 0; n0 < N && cnt < need; n0 += 8 * 32) {
      int mine = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 32 * i + lane;
        if (n < N) {
          int f = elig[n];
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            int a = avail[n * kR + r];
            if (!before) a = min(a, ext[n * kR + r]);
            f &= a >= q[r];
          }
          mine += f;
        }
      }
      cnt += __reduce_add_sync(kFull, mine);
    }
    return cnt;
  }

  // the same past kMaxR types, the request q[0, R) read from memory
  __device__ int count_fits_any(const int* q, bool before, int need) {
    const int lane = threadIdx.x & 31;
    int cnt = 0;
    for (int n0 = 0; n0 < N && cnt < need; n0 += 8 * 32) {
      int mine = 0;
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 32 * i + lane;
        if (n < N) {
          int f = elig[n];
          for (int r = 0; r < R; ++r) {
            int a = avail[n * R + r];
            if (!before) a = min(a, ext[n * R + r]);
            f &= a >= q[r];
          }
          mine += f;
        }
      }
      cnt += __reduce_add_sync(kFull, mine);
    }
    return cnt;
  }

  // the backfill behind the head (queue list place from `p`), in rank
  // order; returns the jobs started
  __device__ int backfill(int t, int shadow_t, int p, bool pref) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // this warp's shapes (need, before, request) that could not start in
    // this round, one a lane: pools only shrink, so a candidate needing at
    // least as much of a pool at most as large cannot start either
    int* tab = dead + warp * 32 * (2 + R);
    int n_dead = 0;
    int admits = 0;
    while (p < qn) {
      // lane j < kPerWarp fetches candidate p + warp + kWarps j
      int c_row = -1, c_need = 0, c_before = 0;
      int c_q[kMaxR] = {};
      const int a_l = p + warp + kWarps * lane;
      if (lane < kPerWarp && a_l < qn) {
        c_row = qrow[a_l];
        if (c_row >= 0) {
          c_need = n_need[c_row];
          c_before = t + est[c_row] <= shadow_t;
#pragma unroll
          for (int r = 0; r < kMaxR; ++r)
            if (r < R) c_q[r] = req[static_cast<long long>(c_row) * R + r];
        }
      }
      int hit = kInf;
      for (int j = 0; j < kPerWarp; ++j) {
        const int row = __shfl_sync(kFull, c_row, j);
        if (row < 0) continue;
        const int need = __shfl_sync(kFull, c_need, j);
        const bool before = __shfl_sync(kFull, c_before, j);
        int q[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) q[r] = __shfl_sync(kFull, c_q[r], j);
        // past kMaxR types the request is read from the row
        const int* rq = req + static_cast<long long>(row) * R;
        bool dom = false;
        if (lane < n_dead) {
          const int* d = tab + lane * (2 + R);
          dom = d[0] <= need && (d[1] || !before);
#pragma unroll
          for (int r = 0; r < kMaxR; ++r)
            if (r < R) dom = dom && d[2 + r] <= q[r];
          if constexpr (kWide)
            for (int r = kMaxR; r < R; ++r) dom = dom && d[2 + r] <= rq[r];
        }
        if (__any_sync(kFull, dom)) continue;
        int cnt;
        switch (R) {
          case 1: cnt = count_fits<1>(q, before, need); break;
          case 2: cnt = count_fits<2>(q, before, need); break;
          case 3: cnt = count_fits<3>(q, before, need); break;
          case 4: cnt = count_fits<4>(q, before, need); break;
          case 5: cnt = count_fits<5>(q, before, need); break;
          case 6: cnt = count_fits<6>(q, before, need); break;
          case 7: cnt = count_fits<7>(q, before, need); break;
          default:
            if constexpr (kWide) {
              if (R > kMaxR) {
                cnt = count_fits_any(rq, before, need);
                break;
              }
            }
            cnt = count_fits<8>(q, before, need);
            break;
        }
        if (cnt >= need) {
          hit = p + warp + kWarps * j;
          break;
        }
        if (n_dead < 32) {
          if (lane == n_dead) {
            int* d = tab + lane * (2 + R);
            d[0] = need;
            d[1] = before;
#pragma unroll
            for (int r = 0; r < kMaxR; ++r)
              if (r < R) d[2 + r] = q[r];
            if constexpr (kWide)
              for (int r = kMaxR; r < R; ++r) d[2 + r] = rq[r];
          }
          __syncwarp();
          ++n_dead;
        }
      }
      const int f = min_int(lane == 0 ? hit : kInf);
      if (f >= kInf) {
        p += kWarps * kPerWarp;
        continue;
      }
      int row = qrow[f], pos = f;
      // Only rankless rows fit behind the cursor: the reference's argmin
      // over their INF ranks picks row 0, whatever its state.
      const bool row0 = fifo_rank[row] >= kInf;
      if (row0) {
        row = 0;
        pos = state[0] == kQueued ? place_of(0) : -1;
      }
      const bool before = t + est[row] <= shadow_t;
      const bool ok = select(before ? kPoolAvail : kPoolBackfill, row, pref);
      if (ok) {
        commit(row, pos, t, !before);
        ++n_started;
        ++admits;
      }
      const int cursor = fifo_rank[row];
      if (cursor >= kInf) break;  // nothing ranks behind the cursor
      if (!row0) {
        p = f + 1;
        continue;
      }
      // a row 0 that did not start would be picked again forever
      if (!ok) break;
      // the walk resumes behind row 0's rank
      int mine = kInf;
      for (int a = qfirst + threadIdx.x; a < qn; a += kThreads) {
        const int r = qrow[a];
        if (r >= 0 && fifo_rank[r] > cursor) mine = min(mine, a);
      }
      p = min(min_int(mine), qn);
    }
    return admits;
  }

  // returns the jobs started
  __device__ int dispatch(int t, int q0, int counters[4]) {
    const bool pref = p.use_kernel != 0;
    if (pref && q0 > 0) {
      for (int i = threadIdx.x; i < N * R; i += kThreads) avail0[i] = avail[i];
      __syncthreads();
    }
    if (qn - qfirst > 2 * q0 + kThreads) compact_queue();
    // phase 1: greedy starts until the first blocked candidate
    int started = 0, q_cnt = q0, idx_h = 0, pos_h = -1;
    bool go = q0 > 0;
    while (go) {
      int pos;
      const int idx = first_queued(pos);
      // pools only shrink between releases, so a probe that failed
      // fails again until one (completion, eviction, eligibility)
      const bool ok = q_cnt > 0 && idx != blocked &&
                      select(kPoolAvail, idx, pref);
      if (!ok && q_cnt > 0) blocked = idx;
      if (ok) {
        commit(idx, pos, t, false);
        ++n_started; ++started; --q_cnt;
      }
      idx_h = idx;
      pos_h = pos;
      go = ok && q_cnt > 0;
    }
    const int greedy = started;
    // phase 2: EBF shadow walk + head reservation
    const bool has_head = sched == kSchedEbf && q_cnt > 0;
    int shadow_t = 0, released = 0, bf_admits = 0;
    if (has_head && shadow_walk(idx_h, t, &shadow_t, &released)) {
      // head reservation at shadow time: no prefilter (the shadow pool
      // can exceed the round-start availability); ext becomes `extra`
      select(kPoolShadow, idx_h, false);
      const int* hq = req + static_cast<long long>(idx_h) * R;
      for (int i = threadIdx.x; i < N * R; i += kThreads)
        if (slot[i / R] >= 0) ext[i] -= hq[i % R];
      __syncthreads();
      // phase 3: backfill behind the reservation (a head without a rank
      // has no row ranked behind it)
      if (fifo_rank[idx_h] < kInf)
        bf_admits = backfill(t, shadow_t, pos_h + 1, pref);
      started += bf_admits;
    }
    if (kTele) {
      counters[0] = greedy + (q_cnt > 0 ? 1 : 0);
      counters[1] = has_head ? released : 0;
      counters[2] = bf_admits;
      counters[3] = has_head ? (q0 - greedy - 1) - bf_admits : 0;
    }
    return started;
  }

  // ------------------------------------------------------------------
  // every running row with end <= t completes; the running list keeps
  // the rest, in order
  __device__ void complete(int t) {
    const int L = rn;
    int out = 0, done = 0, mine = kInf;
    for (int base = 0; base < L; base += kThreads) {
      const int a = base + threadIdx.x;
      int row = 0, e = 0, rl = 0;
      bool keep = false, fin = false;
      if (a < L) {
        row = rrow[a]; e = rend[a]; rl = rrel[a];
        keep = e > t || e >= kInf;
        fin = !keep;
        if (fin) state[row] = kCompleted;
      }
      // kept rows count in the low 16 bits, completed ones in the high
      // bits: one scan places both
      int total;
      const int off = excl_scan(keep | (fin << 16), &total);
      if (keep) {
        const int at = out + (off & 0xffff);
        rrow[at] = row; rend[at] = e; rrel[at] = rl;
        mine = min(mine, e);
      }
      if (fin) col0[done + (off >> 16)] = row;
      out += total & 0xffff;
      done += total >> 16;
    }
    __syncthreads();
    // the completed rows' releases, one (row, node slot) pair per thread
    for (int i = threadIdx.x; i < done * K; i += kThreads) {
      const int row = col0[i / K];
      const int node = assigned[static_cast<long long>(row) * K + i % K];
      if (node < N)
        for (int r = 0; r < R; ++r)
          atomicAdd(&avail[node * R + r], req[static_cast<long long>(row) * R + r]);
    }
    n_completed += done;
    if (done > 0) blocked = -1;
    rn = out;
    t_end = min_int(mine);
  }

  // requeue a victim: queued again, not started, on no node
  __device__ void requeue(int row) {
    state[row] = kQueued;
    start[row] = kUnset;
    end[row] = kInf;
    int* as = assigned + static_cast<long long>(row) * K;
    for (int k = 0; k < K; ++k) as[k] = N;
  }

  // FAIL of node v at ev_t: its running rows are released, take their
  // checkpoint credit and are requeued behind the queue in their old
  // rank order (the stable argsort of key = victim ? fifo_rank : INF)
  __device__ void evict(int v, int ev_t) {
    if (threadIdx.x == 0) red.count = 0;
    __syncthreads();
    const int L = rn;
    long long lost = 0;
    int out = 0, mine = kInf, nf_mine = 0;
    for (int base = 0; base < L; base += kThreads) {
      const int a = base + threadIdx.x;
      int row = 0, e = 0, rl = 0;
      bool vm = false;
      if (a < L) {
        row = rrow[a]; e = rend[a]; rl = rrel[a];
        const int* as = assigned + static_cast<long long>(row) * K;
        for (int k = 0; k < K; ++k) vm |= as[k] == v;
      }
      if (vm) {
        release(avail, row);
        const int ran = ev_t - start[row];
        const int dur = duration[row];
        const int ck = ckpt_every_s;
        int saved = ck > 0 ? (ran / max(ck, 1)) * ck : 0;
        saved = min(saved, max(dur - 1, 0));
        const int new_dur = max(dur - saved, 1);
        lost += ran - (dur - new_dur);
        duration[row] = new_dur;
        col0[atomicAdd(&red.count, 1)] = row;
        nf_mine += fifo_rank[row] < kInf;
      }
      const bool keep = a < L && !vm;
      int total;
      const int off = excl_scan(keep, &total);
      if (keep) {
        rrow[out + off] = row; rend[out + off] = e; rrel[out + off] = rl;
        mine = min(mine, e);
      }
      out += total;
    }
    rn = out;
    t_end = min_int(mine);
    const int nv = L - out;
    if (nv == 0) return;
    lost_work_s += static_cast<int>(sum(lost));
    const int nf = static_cast<int>(sum(nf_mine));
    // victims with a rank take rank_ctr + their place in (rank, row)
    // order among them
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const int row = col0[i], ki = fifo_rank[row];
      int pos = kNoRank;
      if (ki < kInf) {
        pos = 0;
        for (int j = 0; j < nv; ++j) {
          const int rj = col0[j], kj = fifo_rank[rj];
          pos += kj < ki || (kj == ki && rj < row);
        }
      }
      col1[i] = pos;
    }
    __syncthreads();
    if (nv == nf) {
      if (qn + nv > M) compact_queue();
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        const int row = col0[i];
        fifo_rank[row] = rank_ctr + col1[i];
        requeue(row);
        qrow[qn + col1[i]] = row;
      }
      qn += nv;
      if (q_inf) rebuild_queue();
    } else {
      // victims without a rank share key INF with every row that is not
      // a ranked victim: the first nv - nf such rows by index take the
      // last places.  Ranked victims are the rows ranked in
      // [rank_ctr, rank_ctr + nf) once their ranks are written.
      for (int i = threadIdx.x; i < nv; i += kThreads)
        if (col1[i] != kNoRank) fifo_rank[col0[i]] = rank_ctr + col1[i];
      __syncthreads();
      int carry = 0;
      for (int base = 0; base < M; base += kThreads) {
        const int i = base + threadIdx.x;
        const bool k_inf = i < M && !(fifo_rank[i] >= rank_ctr &&
                                      fifo_rank[i] < rank_ctr + nf);
        int total;
        const int ord = carry + excl_scan(k_inf, &total);
        if (k_inf && ord < nv - nf) fifo_rank[i] = rank_ctr + nf + ord;
        carry += total;
      }
      for (int i = threadIdx.x; i < nv; i += kThreads) requeue(col0[i]);
      rebuild_queue();
    }
    rank_ctr += nv;
    n_started -= nv;
    n_requeued += nv;
    __syncthreads();
  }

  // FAIL/REPAIR events with time <= t, one per trip
  __device__ void drain(int t) {
    while (fptr < n_fail && t < kInf) {
      const int* ev = fail_ev + 3 * min(max(fptr, 0), F - 1);
      const int ev_t = ev[0], v = ev[1], kind = ev[2];
      if (ev_t > t) break;
      const bool up_v = node_up[v] > 0;
      const bool do_fail = kind == 1 && up_v;
      const bool do_rep = kind == 0 && !up_v;
      if (do_fail) evict(v, ev_t);
      if (do_rep) downtime += ev_t - down_since[v];
      __syncthreads();
      if (threadIdx.x == 0) {
        if (do_fail) {
          node_up[v] = 0;
          quar_until[v] = ev_t + quarantine_s;
          down_since[v] = ev_t;
        } else if (do_rep) {
          node_up[v] = 1;
          down_since[v] = -1;
        }
      }
      __syncthreads();
      ++fptr;
    }
    for (int n = threadIdx.x; n < N; n += kThreads)
      elig[n] = node_up[n] > 0 && quar_until[n] <= t;
    blocked = -1;
    __syncthreads();
  }

  // the pending prefix with submit <= t, in (T_sb, seq) order
  __device__ void admit(int t) {
    bool appended = false;
    for (;;) {
      const int row = pending[min(max(ptr, 0), M - 1)];
      if (!(ptr < n_pending && submit[row] <= t)) break;
      const bool bad = unfit[row] > 0;
      if (!bad && qn == M) compact_queue();
      if (threadIdx.x == 0) {
        state[row] = bad ? kRejected : kQueued;
        if (!bad) {
          queued_time[row] = t;
          qrow[qn] = row;
        }
        fifo_rank[row] = rank_ctr;
      }
      qn += !bad;
      appended |= !bad;
      ++ptr; ++rank_ctr; ++n_submitted;
      n_rejected += bad;
    }
    if (q_inf && appended) rebuild_queue();
    __syncthreads();
  }

  // ------------------------------------------------------------------
  __device__ void tele_sample(int t, int queue) {
    int* row = tele_buf + static_cast<long long>(tele_n) * (5 + R);
    if (threadIdx.x == 0) {
      row[0] = t;
      row[1] = queue;
      row[2] = n_started - n_completed;
      row[3] = n_started + n_requeued;
      row[4] = n_requeued;
    }
    for (int r = 0; r < R; ++r) {
      long long mine = 0;
      for (int n = threadIdx.x; n < N; n += kThreads) mine += avail[n * R + r];
      const int s = static_cast<int>(sum(mine));
      if (threadIdx.x == 0) row[5 + r] = s;
    }
    ++tele_n;
  }

  // priority positions of the final state (fleet.engine._priority_order)
  __device__ void write_pri() {
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += kThreads)
      col0[i] = fifo_rank[i] < kInf ? fifo_rank[i] : 0;
    __syncthreads();
    for (int pos = ptr + threadIdx.x; pos < n_pending; pos += kThreads) {
      const int row = pending[pos];
      if (fifo_rank[row] >= kInf) col0[row] = rank_ctr + pos - ptr;
    }
    __syncthreads();
    if (sched == kSchedFifo || sched == kSchedEbf) {
      for (int i = threadIdx.x; i < M; i += kThreads) pri[i] = col0[i];
      return;
    }
    // SJF/LJF: the row's place in the lexsort by (key, queued time,
    // rank), stable by row: count the rows before it, a tile at a time
    int* t1 = reinterpret_cast<int*>(key);
    int* t2 = t1 + kThreads;
    int* t3 = t1 + 2 * kThreads;
    const int tiles = (M + kThreads - 1) / kThreads;
    for (int ti = 0; ti < tiles; ++ti) {
      const int i = ti * kThreads + threadIdx.x;
      int k1 = 0, k2 = 0, k3 = 0, pos = 0;
      if (i < M) {
        k1 = sched == kSchedSjf ? est[i] : -est[i];
        k2 = queued_time[i] >= 0 ? queued_time[i] : submit[i];
        k3 = col0[i];
      }
      for (int tj = 0; tj < tiles; ++tj) {
        const int j = tj * kThreads + threadIdx.x;
        __syncthreads();
        if (j < M) {
          t1[threadIdx.x] = sched == kSchedSjf ? est[j] : -est[j];
          t2[threadIdx.x] = queued_time[j] >= 0 ? queued_time[j] : submit[j];
          t3[threadIdx.x] = col0[j];
        }
        __syncthreads();
        const int n = min(kThreads, M - tj * kThreads);
        if (i < M)
          for (int x = 0; x < n; ++x) {
            const int j2 = tj * kThreads + x;
            const int a = t1[x], b2 = t2[x], c = t3[x];
            pos += a < k1 || (a == k1 && (b2 < k2 || (b2 == k2 &&
                   (c < k3 || (c == k3 && j2 < i)))));
          }
      }
      if (i < M) pri[i] = pos;
    }
  }

  // ------------------------------------------------------------------
  __device__ void run() {
    if (!(kWide && p.global)) {
      for (int i = threadIdx.x; i < N * R; i += kThreads) {
        avail[i] = p.f[AVAIL][blockIdx.x * p.stride[AVAIL] + i];
        cap[i] = capacity_g[i];
      }
    }
    for (int n = threadIdx.x; n < N; n += kThreads) elig[n] = 1;
    build_lists();
    __syncthreads();
    const long long guard =
        2LL * M + 8 + (kFail ? static_cast<long long>(F) * (M + 1) : 0);
    for (;;) {
      bool go = ptr < n_pending || rn > 0;
      if (kFail) {
        const int queued = n_submitted - n_rejected - n_started;
        go = go || (queued > 0 && fptr < n_fail);
      }
      if (!(steps < guard && go)) break;
      // ---- next event time
      const int pidx = pending[min(max(ptr, 0), M - 1)];
      const int t_sub = ptr < n_pending ? submit[pidx] : kInf;
      int t = min(t_sub, t_end);
      if (kFail) {
        const int n_live = n_submitted - n_rejected - n_completed;
        if (fptr < n_fail && n_live > 0)
          t = min(t, fail_ev[3 * min(max(fptr, 0), F - 1)]);
      }
      // ---- completions
      if (t_end <= t && t_end < kInf) complete(t);
      // ---- failure drain, eligibility at t
      if (kFail) drain(t);
      // ---- submissions
      admit(t);
      // ---- dispatch
      const int q0 = n_submitted - n_rejected - n_started;
      int counters[4] = {0, 0, 0, 0};
      const int started = dispatch(t, q0, counters);
      if (q0 > 0) ++n_rounds;
      // ---- event log
      if (threadIdx.x == 0) {
        const int i = min(max(n_events, 0), E - 1);
        log_t[i] = t;
        log_queue[i] = q0 - started;
        log_running[i] = n_started - n_completed;
        log_started[i] = started;
      }
      if (kTele) {
        if (tele_stride > 0 && tele_n < S &&
            n_events % max(tele_stride, 1) == 0)
          tele_sample(t, q0 - started);
        ct_disp += counters[0];
        ct_shadow += counters[1];
        ct_backfill += counters[2];
        ct_misfit += counters[3];
      }
      now = t;
      ++n_events;
      ++steps;
      __syncthreads();
    }
    if (kFail) {
      // livelock parity: queued jobs that outlast every event are
      // rejected, with no event counted
      long long left = 0;
      for (int i = threadIdx.x; i < M; i += kThreads)
        if (state[i] == kQueued) {
          state[i] = kRejected;
          ++left;
        }
      n_rejected += static_cast<int>(sum(left));
    }
    if (kTele) {
      if (tele_stride > 0 && n_events > 0 && tele_n < S &&
          (n_events - 1) % max(tele_stride, 1) != 0)
        tele_sample(now, n_submitted - n_rejected - n_started);
    }
    write_pri();
    if (!(kWide && p.global))
      for (int i = threadIdx.x; i < N * R; i += kThreads)
        p.f[AVAIL][blockIdx.x * p.stride[AVAIL] + i] = avail[i];
    if (threadIdx.x == 0) {
      auto put = [&](int f, int v) { p.f[f][blockIdx.x * p.stride[f]] = v; };
      put(PTR, ptr); put(NOW, now); put(RANK_CTR, rank_ctr);
      put(N_SUBMITTED, n_submitted); put(N_COMPLETED, n_completed);
      put(N_REJECTED, n_rejected); put(N_STARTED, n_started);
      put(N_EVENTS, n_events); put(N_ROUNDS, n_rounds); put(STEPS, steps);
      put(FPTR, fptr); put(N_REQUEUED, n_requeued);
      put(LOST_WORK_S, lost_work_s); put(NODE_DOWNTIME_S, downtime);
      put(TELE_N, tele_n); put(CT_DISP_TRIPS, ct_disp);
      put(CT_SHADOW_TRIPS, ct_shadow); put(CT_BACKFILL, ct_backfill);
      put(CT_MISFIT, ct_misfit);
    }
  }
};

template <bool kFail, bool kTele, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
fleet_engine_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Red red;
  Sim<kFail, kTele, kWide> sim(p, blockIdx.x, smem, red);
  sim.run();
}

// dynamic shared memory of the shared tier for N nodes and R types, bytes
long long shared_bytes(int N, int R) {
  return static_cast<long long>(sizeof(unsigned long long)) * key_count(N) +
         static_cast<long long>(sizeof(int)) *
             (4LL * N * R + 2LL * N + kWarps * 32LL * (2 + R));
}

// the shapes whose int32 indexes stay in range (row x node slot, node x
// type, the pow2 sort widths), on top of the reference's own
bool shapes_ok(int M, int N, int R, int K, int E, int F, int S) {
  return M >= 1 && N >= 1 && R >= 1 && K >= 1 && E >= 1 && F >= 0 &&
         S >= 0 && 6LL * M <= kMaxInt && N <= (1 << 30) &&
         static_cast<long long>(M) * K <= kMaxInt &&
         static_cast<long long>(N) * R <= kMaxInt &&
         3LL * F <= kMaxInt && kWarps * 32LL * (2 + R) <= kMaxInt;
}

// the tier: 1 when the node arrays outgrow one block's shared memory
// (with the block's reductions) on `device`, 0 when they fit; < 0 is
// a CUDA error
int tier_of(int N, int R, int device) {
  int limit = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return shared_bytes(N, R) + static_cast<long long>(sizeof(Red)) >
         static_cast<long long>(limit);
}

long long scratch_of(int M, int N, int R, int global) {
  return list_ints(M) +
         (global ? 2LL * key_count(N) + global_node_ints(N, R) : 0);
}

template <bool kFail, bool kTele, bool kWide>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  auto kernel = fleet_engine_kernel<kFail, kTele, kWide>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 1 when N x R needs the wide instances: more nodes than Best-Fit keeps
// in registers, more types than the backfill unrolls, or node arrays past
// one block's shared memory; 0 when the fast ones take it; < 0 a CUDA
// error
int needs_wide(int N, int R, int device) {
  if (N > kMaxN || R > kMaxR) return 1;
  return tier_of(N, R, device);
}

// fields: kFields device pointers in SimState order, each int32[B, ...]
// contiguous; strides: elements per sim of each.  scratch: int32[B,
// fleet_engine_scratch_ints(M, N, R, device)].  The fast instances
// (fleet_engine.cu) refuse the shapes that need the wide ones
// (fleet_engine_wide.cu).
template <bool kWide>
int launch_entry(const void* fields, const void* strides, int n_fields,
                 void* scratch, int B, int M, int N, int R, int K, int E,
                 int F, int S, int use_kernel, int device, void* stream) {
  if (n_fields != kFields || B < 0 || !shapes_ok(M, N, R, K, E, F, S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wide = needs_wide(N, R, device);
  if (wide < 0) return -wide;
  if (wide && !kWide) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int global = tier_of(N, R, device);
  if (global < 0) return -global;
  Params p;
  const unsigned long long* fp = static_cast<const unsigned long long*>(fields);
  const long long* st = static_cast<const long long*>(strides);
  for (int i = 0; i < kFields; ++i) {
    p.f[i] = reinterpret_cast<int*>(fp[i]);
    p.stride[i] = st[i];
  }
  p.scratch = static_cast<int*>(scratch);
  p.scratch_stride = scratch_of(M, N, R, global);
  p.M = M; p.N = N; p.R = R; p.K = K; p.E = E; p.F = F; p.S = S;
  p.use_kernel = use_kernel;
  p.global = global;
  const size_t smem = global ? 0 : static_cast<size_t>(shared_bytes(N, R));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F > 0 && S > 0) return launch<true, true, kWide>(p, B, smem, s);
  if (F > 0) return launch<true, false, kWide>(p, B, smem, s);
  if (S > 0) return launch<false, true, kWide>(p, B, smem, s);
  return launch<false, false, kWide>(p, B, smem, s);
}

}  // namespace

// The launchers of one library: the fast instances (fleet_engine.cu
// defines FLEET_ENGINE_WIDE 0) or the wide ones (fleet_engine_wide.cu, 1).
extern "C" int fleet_engine_launch(const void* fields, const void* strides,
                                   int n_fields, void* scratch, int B, int M,
                                   int N, int R, int K, int E, int F, int S,
                                   int use_kernel, int device, void* stream) {
  return launch_entry<FLEET_ENGINE_WIDE != 0>(
      fields, strides, n_fields, scratch, B, M, N, R, K, E, F, S, use_kernel,
      device, stream);
}

// 1 when N x R needs fleet_engine_wide's instances, 0 when not, < 0 a
// CUDA error
extern "C" int fleet_engine_needs_wide(int N, int R, int device) {
  return needs_wide(N, R, device);
}

// dynamic shared memory of a launch at N x R on `device`, bytes: the node
// arrays where they fit, else 0 (the global tier); < 0 a CUDA error
extern "C" long long fleet_engine_shared_bytes(int N, int R, int device) {
  const int global = tier_of(N, R, device);
  if (global < 0) return global;
  return global ? 0 : shared_bytes(N, R);
}

// int32 scratch elements per sim of M rows, N nodes and R types on
// `device` (the node arrays too on the global tier); < 0 a CUDA error or
// shapes out of int32 range
extern "C" long long fleet_engine_scratch_ints(int M, int N, int R,
                                               int device) {
  if (!shapes_ok(M, N, R, 1, 1, 0, 0))
    return -static_cast<long long>(cudaErrorInvalidValue);
  const int global = tier_of(N, R, device);
  if (global < 0) return global;
  return scratch_of(M, N, R, global);
}
