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
// Layout.  The batch's stacked SimState fields are int32[B, ...] in
// global memory, updated in place; block b runs sim b to its end.  Node
// arrays live in shared memory (avail, capacity, the backfill pool
// `extra`, the shadow walk's availability, eligibility, slots and the
// Best-Fit sort keys); per-row columns stay in global memory (Seth's
// 10,048 rows x ~12 columns do not fit in a block's shared memory).  The
// block's scalars (clock, pointers, counters) are replicated in every
// thread's registers: each thread runs the same scalar code on values
// that block reductions broadcast, so only row and node writes need a
// barrier.  Scratch, int32[B, 3M + M W]: a row column the failure drain
// and the priority pass use, the backfill's per-round "cannot start"
// stamps, the running-row list of the shadow walk, and the round's fit
// bits (use_kernel).
//
// The event loop (one trip per event, bounded by the reference's guard
// 2M + 8 + F (M + 1)):
//  1. one pass over the rows: any row running, and the earliest end;
//     t = min(next submission, earliest end[, next failure event]);
//  2. every running row with end <= t completes (one pass; releases
//     commute, so this equals the reference's one-per-trip loop);
//  3. [kFail] FAIL/REPAIR events with time <= t, one per trip: victims
//     released in one pass, checkpoint credit, re-ranked behind the
//     queue in their old rank order; node health; eligibility at t;
//  4. the pending prefix with submit <= t is admitted in order;
//  5. one dispatch round: [use_kernel] the fit bits of every row against
//     the round-start availability (alloc_fit.cuh, the code of
//     alloc_score.cu); greedy starts in priority order until the first
//     failure; for EBF the shadow walk, the head's reservation (without
//     the prefilter) and the backfill behind it;
//  6. the event log, and [kTele] the telemetry sample and counters.
//
// Equivalences with the reference that this design leans on:
//  * priority: the reference materializes per-row positions of a
//    lexsort by (key, queued time, rank) once per sim (and after each
//    failure drain) and takes a masked argmin; here each candidate
//    search is a lexicographic argmin over (key, queued time, fifo rank,
//    row) of the queued rows, which picks the same row, since admission
//    hands out exactly the ranks and queued times the positions were
//    built with.  The `pri` field is written once, at the end, from the
//    final state (the same positions, by that same argument).  With no
//    queued row the argmin is row 0, as jnp.argmin over all-INF.
//  * shadow walk: one release group (equal estimated release time) per
//    trip over a compact list of the running rows; the reference
//    releases one row per trip and tests the fit only when a group is
//    done, so the availability and the shadow time are the same.
//  * backfill: pools only shrink within a round, so a row that cannot
//    start stays unable to start; it is stamped and skipped for the rest
//    of the round, and the loop ends at the first trip with no
//    candidate (the reference's more_bf test, one trip later, with no
//    effect).
//
// Best-Fit order: load per node in float32 (alloc_fit::load), a stable
// descending sort with ties by node id: a bitonic sort of 64-bit keys
// (~orderable(load) << 32 | node) of the fitting nodes; FirstFit is a
// block prefix count over the fitting nodes by id.  Both take the first
// `need` fitting nodes; `assigned` is padded with N.
//
// The failure and telemetry code are template flags (kFail = F > 0,
// kTele = S > 0), so with F = 0 and S = 0 it compiles away, as the
// reference's static switches do.  The launcher selects the tensors'
// device first: this library links its own CUDA runtime.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alloc_fit.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kInf = 1 << 30;
constexpr int kMaxR = 8;
constexpr int kMaxN = 2048;
constexpr unsigned long long kNone = ~0ull;
constexpr int kQueued = 1, kRunning = 2, kCompleted = 3, kRejected = 4;
constexpr int kUnset = -1;
constexpr int kNoRank = -2147483647 - 1;   // "rank unchanged" in scratch

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
};

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

// ----------------------------------------------------------------------
// block primitives (every thread calls them; the result is broadcast)
// ----------------------------------------------------------------------
struct Red {
  unsigned long long hi[kWarps + 1];
  unsigned long long lo[kWarps + 1];
  int scan[kWarps + 1];
  int count;
};

// lexicographic minimum of (hi, lo) over the block
__device__ void block_min2(unsigned long long& hi, unsigned long long& lo,
                           Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long h = __shfl_xor_sync(0xffffffffu, hi, o);
    const unsigned long long l = __shfl_xor_sync(0xffffffffu, lo, o);
    if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
  }
  __syncthreads();                          // red is free again
  if (lane == 0) { red.hi[warp] = hi; red.lo[warp] = lo; }
  __syncthreads();
  if (warp == 0) {
    hi = lane < kWarps ? red.hi[lane] : kNone;
    lo = lane < kWarps ? red.lo[lane] : kNone;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long h = __shfl_xor_sync(0xffffffffu, hi, o);
      const unsigned long long l = __shfl_xor_sync(0xffffffffu, lo, o);
      if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
    }
    if (lane == 0) { red.hi[kWarps] = hi; red.lo[kWarps] = lo; }
  }
  __syncthreads();
  hi = red.hi[kWarps];
  lo = red.lo[kWarps];
}

__device__ long long block_sum(long long v, Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red.hi[warp] = static_cast<unsigned long long>(v);
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? static_cast<long long>(red.hi[lane]) : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red.hi[kWarps] = static_cast<unsigned long long>(v);
  }
  __syncthreads();
  return static_cast<long long>(red.hi[kWarps]);
}

__device__ int block_min_int(int v, Red& red) {
  unsigned long long hi = flip(v), lo = 0;
  block_min2(hi, lo, red);
  return static_cast<int>(static_cast<unsigned>(hi) ^ 0x80000000u);
}

// exclusive prefix sum of one int per thread (in thread order); *total
// receives the block's sum
__device__ int block_excl_scan(int v, int* total, Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? red.scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) red.scan[lane] = w;
  }
  __syncthreads();
  const int before = warp ? red.scan[warp - 1] : 0;
  *total = red.scan[kWarps - 1];
  return before + x - v;
}

// ascending bitonic sort of n (a power of two) keys in shared memory
__device__ void bitonic_sort(unsigned long long* a, int n) {
  __syncthreads();
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
template <bool kFail, bool kTele>
struct Sim {
  const Params& p;
  int M, N, R, K, E, F, S, W, Np2;
  // row columns and matrices of this sim
  const int *submit, *est, *n_need, *unfit, *req, *pending, *capacity_g;
  int *duration, *state, *queued_time, *start, *end, *fifo_rank, *assigned;
  int *log_t, *log_queue, *log_running, *log_started, *pri;
  const int* fail_ev;
  int *node_up, *quar_until, *down_since, *tele_buf;
  int *col0, *dead, *list, *bits;
  // shared memory
  int *avail, *cap, *extra, *cur, *elig, *slot;
  unsigned long long* key;
  int* tile;
  Red& red;
  // scalars (replicated in every thread)
  int ptr, n_pending, now, rank_ctr, sched, alloc, n_submitted, n_completed,
      n_rejected, n_started, n_events, n_rounds, steps, fptr, n_fail,
      quarantine_s, ckpt_every_s, n_requeued, lost_work_s, downtime,
      tele_stride, tele_n, ct_disp, ct_shadow, ct_backfill, ct_misfit;

  __device__ Sim(const Params& prm, int b, char* smem, Red& r)
      : p(prm), red(r) {
    M = p.M; N = p.N; R = p.R; K = p.K; E = p.E; F = p.F; S = p.S;
    W = (N + 31) / 32;
    Np2 = 1;
    while (Np2 < N) Np2 <<= 1;
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
    col0 = scr; dead = scr + M; list = scr + 2 * M; bits = scr + 3 * M;
    // shared: keys first (8-byte aligned), then the int arrays
    key = reinterpret_cast<unsigned long long*>(smem);
    int* q = reinterpret_cast<int*>(key + Np2);
    avail = q; q += N * R;
    cap = q; q += N * R;
    extra = q; q += N * R;
    cur = q; q += N * R;
    elig = q; q += N;
    slot = q; q += N;
    tile = q;                                  // 3 * kThreads ints
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
  }

  // ------------------------------------------------------------------
  __device__ int pool_at(int mode, int i) const {
    return mode == kPoolAvail ? avail[i]
         : mode == kPoolBackfill ? min(avail[i], extra[i]) : cur[i];
  }

  __device__ bool pool_fits(int mode, int n, const int* q) const {
    if (mode == kPoolAvail) return alloc_fit::fits(avail + n * R, q, R);
    if (mode == kPoolShadow) return alloc_fit::fits(cur + n * R, q, R);
    int ok = 1;
    for (int r = 0; r < R; ++r)
      ok &= (min(avail[n * R + r], extra[n * R + r]) >= q[r]);
    return ok;
  }

  __device__ float pool_load(int mode, int n) const {
    if (mode == kPoolAvail) return alloc_fit::load(cap + n * R, avail + n * R, R);
    if (mode == kPoolShadow) return alloc_fit::load(cap + n * R, cur + n * R, R);
    int a[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R) a[r] = min(avail[n * R + r], extra[n * R + r]);
    return alloc_fit::load(cap + n * R, a, R);
  }

  // Allocator probe of row `row` against `mode`'s pool: slot[n] = the
  // node's place in the assignment (or -1); returns ok.  `pref` ANDs the
  // round's fit bits of the row, eligibility is always ANDed.
  __device__ bool select(int mode, int row, bool pref) {
    const int* q = req + static_cast<long long>(row) * R;
    const int need = n_need[row];
    const unsigned* pw =
        reinterpret_cast<const unsigned*>(bits) + static_cast<long long>(row) * W;
    auto fit_at = [&](int n) {
      bool f = elig[n] && pool_fits(mode, n, q);
      if (pref) f = f && ((pw[n >> 5] >> (n & 31)) & 1u);
      return f;
    };
    if (alloc == kAllocBf) {
      int mine = 0;
      for (int n = threadIdx.x; n < Np2; n += kThreads) {
        unsigned long long k = kNone;
        if (n < N) {
          slot[n] = -1;
          if (fit_at(n)) {
            k = (static_cast<unsigned long long>(
                     desc_key(pool_load(mode, n))) << 32) | static_cast<unsigned>(n);
            ++mine;
          }
        }
        key[n] = k;
      }
      const int cnt = static_cast<int>(block_sum(mine, red));
      bitonic_sort(key, Np2);
      const int take = min(cnt, need);
      for (int i = threadIdx.x; i < take; i += kThreads)
        slot[static_cast<int>(key[i] & 0xffffffffu)] = i;
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
    int base = block_excl_scan(mine, &cnt, red);
    for (int n = n0; n < n1; ++n)
      if (slot[n] > 0) {
        slot[n] = base < need ? base : -1;
        ++base;
      }
    __syncthreads();
    return cnt >= need;
  }

  // start `row` at t on the selected nodes; the pool `extra` shrinks too
  // when `from_extra`
  __device__ void commit(int row, int t, bool from_extra) {
    const int* q = req + static_cast<long long>(row) * R;
    int* as = assigned + static_cast<long long>(row) * K;
    const int need = n_need[row];
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const int s = slot[n];
      if (s >= 0) {
        for (int r = 0; r < R; ++r) {
          avail[n * R + r] -= q[r];
          if (from_extra) extra[n * R + r] -= q[r];
        }
        if (s < K) as[s] = n;
      }
    }
    for (int k = need + threadIdx.x; k < K; k += kThreads) as[k] = N;
    if (threadIdx.x == 0) {
      state[row] = kRunning;
      start[row] = t;
      end[row] = t + duration[row];
    }
    __syncthreads();
  }

  // the queued row first in priority order (row 0 if none is queued)
  __device__ int first_queued() {
    unsigned long long hi = kNone, lo = kNone;
    const bool lex = sched == kSchedSjf || sched == kSchedLjf;
    for (int i = threadIdx.x; i < M; i += kThreads) {
      unsigned long long h = kNone, l;
      if (state[i] == kQueued) {
        if (lex) {
          const int k1 = sched == kSchedSjf ? est[i] : -est[i];
          const int qt = queued_time[i] >= 0 ? queued_time[i] : submit[i];
          h = (static_cast<unsigned long long>(flip(k1)) << 32) | flip(qt);
          l = (static_cast<unsigned long long>(flip(fifo_rank[i])) << 32) |
              static_cast<unsigned>(i);
        } else {
          h = flip(fifo_rank[i]);
          l = static_cast<unsigned>(i);
        }
      } else {
        l = static_cast<unsigned>(i);
      }
      if (h < hi || (h == hi && l < lo)) { hi = h; lo = l; }
    }
    block_min2(hi, lo, red);
    return static_cast<int>(lo & 0xffffffffu);
  }

  // the round's fit bits of every row against the round-start avail
  __device__ void prefilter() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunks = (M + 31) / 32;
    for (int item = warp; item < W * chunks; item += kWarps) {
      const int w = item % W, j0 = (item / W) * 32;
      const int n = w * 32 + lane;
      unsigned mine = 0;
      for (int k = 0; k < 32 && j0 + k < M; ++k) {
        const int ok = n < N ? alloc_fit::fits(
            avail + n * R, req + static_cast<long long>(j0 + k) * R, R) : 0;
        const unsigned b = __ballot_sync(0xffffffffu, ok);
        if (lane == k) mine = b;
      }
      if (j0 + lane < M)
        reinterpret_cast<unsigned*>(bits)[static_cast<long long>(j0 + lane) * W + w] = mine;
    }
    __syncthreads();
  }

  // fitting, eligible nodes of the shadow availability for the head
  __device__ int shadow_fit_count(const int* q) {
    int mine = 0;
    for (int n = threadIdx.x; n < N; n += kThreads)
      mine += elig[n] && alloc_fit::fits(cur + n * R, q, R);
    return static_cast<int>(block_sum(mine, red));
  }

  // ------------------------------------------------------------------
  // one dispatch round at t; returns the jobs started
  __device__ int dispatch(int t, int q0, int stamp, int counters[4]) {
    const bool pref = p.use_kernel != 0;
    if (pref && q0 > 0) prefilter();
    // phase 1: greedy starts until the first blocked candidate
    int started = 0, q_cnt = q0, idx_h = 0;
    bool go = q0 > 0;
    while (go) {
      const int idx = first_queued();
      const bool ok = q_cnt > 0 && select(kPoolAvail, idx, pref);
      if (ok) {
        commit(idx, t, false);
        ++n_started; ++started; --q_cnt;
      }
      idx_h = idx;
      go = ok && q_cnt > 0;
    }
    const int greedy = started;
    // phase 2: EBF shadow walk + head reservation
    const bool has_head = sched == kSchedEbf && q_cnt > 0;
    bool found = false;
    int shadow_t = 0, released = 0;
    if (has_head) {
      const int* hq = req + static_cast<long long>(idx_h) * R;
      const int need = n_need[idx_h];
      for (int i = threadIdx.x; i < N * R; i += kThreads) cur[i] = avail[i];
      if (threadIdx.x == 0) red.count = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < M; i += kThreads)
        if (state[i] == kRunning) {
          const int at = atomicAdd(&red.count, 1);
          list[at] = i;
          col0[at] = max(start[i] + est[i], t + 1);
        }
      __syncthreads();
      const int L = red.count;
      int prev = -2147483647 - 1;
      for (int trip = 0; trip < L; ++trip) {
        int mine = kInf;
        for (int a = threadIdx.x; a < L; a += kThreads)
          if (col0[a] > prev) mine = min(mine, col0[a]);
        const int T = block_min_int(mine, red);
        if (T >= kInf) break;
        int rel_here = 0;
        for (int a = threadIdx.x; a < L; a += kThreads)
          if (col0[a] == T) {
            const int row = list[a];
            const int* rq = req + static_cast<long long>(row) * R;
            const int* as = assigned + static_cast<long long>(row) * K;
            for (int k = 0; k < K; ++k) {
              const int node = as[k];
              if (node < N)
                for (int r = 0; r < R; ++r) atomicAdd(&cur[node * R + r], rq[r]);
            }
            ++rel_here;
          }
        released += static_cast<int>(block_sum(rel_here, red));
        if (shadow_fit_count(hq) >= need) {
          found = true;
          shadow_t = T;
          break;
        }
        prev = T;
      }
    }
    const bool enter_bf = has_head && found;
    int bf_admits = 0;
    if (enter_bf) {
      // head reservation at shadow time: no prefilter (the shadow pool
      // can exceed the round-start availability)
      select(kPoolShadow, idx_h, false);
      const int* hq = req + static_cast<long long>(idx_h) * R;
      for (int i = threadIdx.x; i < N * R; i += kThreads)
        extra[i] = cur[i] - (slot[i / R] >= 0 ? hq[i % R] : 0);
      __syncthreads();
      // phase 3: backfill behind the reservation, in FIFO rank order
      int cursor = fifo_rank[idx_h];
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int trip = 0; trip <= M; ++trip) {
        unsigned long long hi = kNone, lo = kNone;
        for (int i = warp; i < M; i += kWarps) {
          if (state[i] != kQueued || fifo_rank[i] <= cursor ||
              dead[i] == stamp)
            continue;
          const bool before = t + est[i] <= shadow_t;
          const int mode = before ? kPoolAvail : kPoolBackfill;
          const int* q = req + static_cast<long long>(i) * R;
          const int need = n_need[i];
          int cnt = 0;
          for (int n0 = 0; n0 < N && cnt < need; n0 += 32) {
            const int n = n0 + lane;
            const bool f = n < N && elig[n] && pool_fits(mode, n, q);
            cnt += __popc(__ballot_sync(0xffffffffu, f));
          }
          if (cnt >= need) {
            const unsigned long long h = flip(fifo_rank[i]);
            if (h < hi || (h == hi && static_cast<unsigned>(i) < lo)) {
              hi = h;
              lo = static_cast<unsigned>(i);
            }
          } else if (lane == 0) {
            dead[i] = stamp;              // pools only shrink: for good
          }
        }
        block_min2(hi, lo, red);
        if (hi == kNone) break;
        const int idx = static_cast<int>(lo & 0xffffffffu);
        const bool before = t + est[idx] <= shadow_t;
        if (select(before ? kPoolAvail : kPoolBackfill, idx, pref)) {
          commit(idx, t, !before);
          ++n_started; ++started; ++bf_admits;
        }
        cursor = fifo_rank[idx];
      }
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
  // FAIL/REPAIR events with time <= t, one per trip
  __device__ void drain(int t) {
    while (fptr < n_fail && t < kInf) {
      const int* ev = fail_ev + 3 * min(max(fptr, 0), F - 1);
      const int ev_t = ev[0], v = ev[1], kind = ev[2];
      if (ev_t > t) break;
      const bool up_v = node_up[v] > 0;
      const bool do_fail = kind == 1 && up_v;
      const bool do_rep = kind == 0 && !up_v;
      if (do_fail) {
        // pass 1: victims release, take their checkpoint credit
        long long lost = 0;
        int nv_mine = 0, nf_mine = 0;
        for (int i = threadIdx.x; i < M; i += kThreads) {
          bool vm = false;
          if (state[i] == kRunning) {
            const int* as = assigned + static_cast<long long>(i) * K;
            for (int k = 0; k < K; ++k) vm |= as[k] == v;
          }
          col0[i] = vm;
          list[i] = kNoRank;
          if (!vm) continue;
          const int* as = assigned + static_cast<long long>(i) * K;
          const int* rq = req + static_cast<long long>(i) * R;
          for (int k = 0; k < K; ++k) {
            const int node = as[k];
            if (node < N)
              for (int r = 0; r < R; ++r) atomicAdd(&avail[node * R + r], rq[r]);
          }
          const int ran = ev_t - start[i];
          const int dur = duration[i];
          const int ck = ckpt_every_s;
          int saved = ck > 0 ? (ran / max(ck, 1)) * ck : 0;
          saved = min(saved, max(dur - 1, 0));
          const int new_dur = max(dur - saved, 1);
          lost += ran - (dur - new_dur);
          duration[i] = new_dur;
          ++nv_mine;
          nf_mine += fifo_rank[i] < kInf;
        }
        const int nv = static_cast<int>(block_sum(nv_mine, red));
        const int nf = static_cast<int>(block_sum(nf_mine, red));
        lost_work_s += static_cast<int>(block_sum(lost, red));
        // pass 2: new ranks, victims behind the queue in old rank order
        // (the stable argsort of key = victim ? fifo_rank : INF)
        for (int i = threadIdx.x; i < M; i += kThreads) {
          if (!col0[i] || fifo_rank[i] >= kInf) continue;
          const int ki = fifo_rank[i];
          int pos = 0;
          for (int j = 0; j < M; ++j)
            pos += col0[j] && fifo_rank[j] < kInf &&
                   (fifo_rank[j] < ki || (fifo_rank[j] == ki && j < i));
          list[i] = rank_ctr + pos;
        }
        if (nv > nf) {
          // victims without a rank share key INF with every other row:
          // the first nv - nf such rows by index take the last places
          int carry = 0;
          for (int base = 0; base < M; base += kThreads) {
            const int i = base + threadIdx.x;
            const bool k_inf = i < M && (!col0[i] || fifo_rank[i] >= kInf);
            int total;
            const int ord = carry + block_excl_scan(k_inf, &total, red);
            if (k_inf && ord < nv - nf) list[i] = rank_ctr + nf + ord;
            carry += total;
          }
        }
        __syncthreads();
        // pass 3: requeue
        for (int i = threadIdx.x; i < M; i += kThreads) {
          if (list[i] != kNoRank) fifo_rank[i] = list[i];
          if (!col0[i]) continue;
          state[i] = kQueued;
          start[i] = kUnset;
          end[i] = kInf;
          int* as = assigned + static_cast<long long>(i) * K;
          for (int k = 0; k < K; ++k) as[k] = N;
        }
        rank_ctr += nv;
        n_started -= nv;
        n_requeued += nv;
      }
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
      const int sum = static_cast<int>(block_sum(mine, red));
      if (threadIdx.x == 0) row[5 + r] = sum;
    }
    ++tele_n;
  }

  // priority positions of the final state (fleet.engine._priority_order)
  __device__ void write_pri() {
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
    int* t1 = tile;
    int* t2 = tile + kThreads;
    int* t3 = tile + 2 * kThreads;
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
    for (int i = threadIdx.x; i < N * R; i += kThreads) {
      avail[i] = p.f[AVAIL][blockIdx.x * p.stride[AVAIL] + i];
      cap[i] = capacity_g[i];
    }
    for (int n = threadIdx.x; n < N; n += kThreads) elig[n] = 1;
    for (int i = threadIdx.x; i < M; i += kThreads) dead[i] = -1;
    __syncthreads();
    const long long guard =
        2LL * M + 8 + (kFail ? static_cast<long long>(F) * (M + 1) : 0);
    for (;;) {
      // ---- any running row, and the earliest end
      int mine = kInf, run_mine = 0;
      for (int i = threadIdx.x; i < M; i += kThreads)
        if (state[i] == kRunning) {
          run_mine = 1;
          mine = min(mine, end[i]);
        }
      const bool any_running = __syncthreads_or(run_mine);
      const int t_end = block_min_int(mine, red);
      bool go = ptr < n_pending || any_running;
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
      if (t_end <= t && t_end < kInf) {
        int done = 0;
        for (int i = threadIdx.x; i < M; i += kThreads) {
          if (state[i] != kRunning || end[i] > t || end[i] >= kInf) continue;
          state[i] = kCompleted;
          const int* as = assigned + static_cast<long long>(i) * K;
          const int* rq = req + static_cast<long long>(i) * R;
          for (int k = 0; k < K; ++k) {
            const int node = as[k];
            if (node < N)
              for (int r = 0; r < R; ++r) atomicAdd(&avail[node * R + r], rq[r]);
          }
          ++done;
        }
        n_completed += static_cast<int>(block_sum(done, red));
      }
      // ---- failure drain, eligibility at t
      if (kFail) drain(t);
      // ---- submissions, in (T_sb, seq) order
      for (;;) {
        const int row = pending[min(max(ptr, 0), M - 1)];
        if (!(ptr < n_pending && submit[row] <= t)) break;
        const bool bad = unfit[row] > 0;
        if (threadIdx.x == 0) {
          state[row] = bad ? kRejected : kQueued;
          if (!bad) queued_time[row] = t;
          fifo_rank[row] = rank_ctr;
        }
        ++ptr; ++rank_ctr; ++n_submitted;
        n_rejected += bad;
      }
      __syncthreads();
      // ---- dispatch
      const int q0 = n_submitted - n_rejected - n_started;
      int counters[4] = {0, 0, 0, 0};
      const int started = dispatch(t, q0, steps + 1, counters);
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
      int left = 0;
      for (int i = threadIdx.x; i < M; i += kThreads)
        if (state[i] == kQueued) {
          state[i] = kRejected;
          ++left;
        }
      n_rejected += static_cast<int>(block_sum(left, red));
    }
    if (kTele) {
      if (tele_stride > 0 && n_events > 0 && tele_n < S &&
          (n_events - 1) % max(tele_stride, 1) != 0)
        tele_sample(now, n_submitted - n_rejected - n_started);
    }
    write_pri();
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

template <bool kFail, bool kTele>
__global__ void __launch_bounds__(kThreads, 1)
fleet_engine_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Red red;
  Sim<kFail, kTele> sim(p, blockIdx.x, smem, red);
  sim.run();
}

size_t shared_bytes(int N, int R) {
  int np2 = 1;
  while (np2 < N) np2 <<= 1;
  return sizeof(unsigned long long) * np2 +
         sizeof(int) * (4 * N * R + 2 * N + 3 * kThreads);
}

template <bool kFail, bool kTele>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  auto kernel = fleet_engine_kernel<kFail, kTele>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields: kFields device pointers in SimState order, each int32[B, ...]
// contiguous; strides: elements per sim of each.  scratch: int32[B,
// 3M + (use_kernel ? M ceil(N/32) : 0)].
extern "C" int fleet_engine_launch(const void* fields, const void* strides,
                                   int n_fields, void* scratch, int B, int M,
                                   int N, int R, int K, int E, int F, int S,
                                   int use_kernel, int device, void* stream) {
  if (n_fields != kFields || B < 0 || M < 1 || N < 1 || N > kMaxN ||
      R < 1 || R > kMaxR || K < 1 || E < 1 || F < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  Params p;
  const unsigned long long* fp = static_cast<const unsigned long long*>(fields);
  const long long* st = static_cast<const long long*>(strides);
  for (int i = 0; i < kFields; ++i) {
    p.f[i] = reinterpret_cast<int*>(fp[i]);
    p.stride[i] = st[i];
  }
  p.scratch = static_cast<int*>(scratch);
  p.scratch_stride = 3LL * M + (use_kernel ? 1LL * M * ((N + 31) / 32) : 0);
  p.M = M; p.N = N; p.R = R; p.K = K; p.E = E; p.F = F; p.S = S;
  p.use_kernel = use_kernel;
  const size_t smem = shared_bytes(N, R);
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem + sizeof(Red) > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F > 0 && S > 0) return launch<true, true>(p, B, smem, s);
  if (F > 0) return launch<true, false>(p, B, smem, s);
  if (S > 0) return launch<false, true>(p, B, smem, s);
  return launch<false, false>(p, B, smem, s);
}

// dynamic shared memory the kernel takes for N nodes and R types, bytes
extern "C" int fleet_engine_shared_bytes(int N, int R) {
  return static_cast<int>(shared_bytes(N, R));
}
