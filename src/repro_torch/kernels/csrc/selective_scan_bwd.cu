// selective_scan_bwd: the backward of the Mamba-1 selective scan.
//
// Replaces the backward of src/repro/kernels/ops.py's scan (ops.py:145-147):
// jax.vjp of the oracle's lax.scan (src/repro/kernels/ref.py:98), which
// XLA runs as one compiled device loop.  The reference has no Pallas
// backward; its docstring (ops.py:131-133) leaves one to a deployment.
//
// Forward (csrc/selective_scan.cu), per batch row b, channel d, state s:
//   a_t = exp(delta_t * A),  h_t = a_t * h_{t-1} + delta_t * B_t * u_t,
//   y_t = sum_s h_t * C_t + D * u_t.
// With G_t = dL/dh_t, the reverse recurrence is
//   G_{L-1} = gh + C_{L-1} gy_{L-1},  G_t = a_{t+1} G_{t+1} + C_t gy_t,
// and the gradients are
//   du_t     = D gy_t + delta_t sum_s G_t B_t                  [Bt, L, Di]
//   ddelta_t = sum_s G_t (h_{t-1} a_t A + B_t u_t)             [Bt, L, Di]
//   dB_t     = sum_d G_t delta_t u_t,  dC_t = sum_d gy_t h_t   [Bt, L, S]
//   dA       = sum_{b,t} G_t h_{t-1} a_t delta_t                [Di, S]
//   dD       = sum_{b,t} gy_t u_t                               [Di]
//
// Bound on the card at the training shape (Bt 2, L 512, Di 8192, S 16,
// bf16): operations.  The Bt*L*Di*S = 134M exponentials at the SFU rate
// (16 per clock per SM, 132 SMs, 1.98 GHz) take 0.032 ms; the bytes (u,
// delta, B, C, du, ddelta, dB, dC at 2 bytes, gy in float32, gh, A, D,
// dA, dD in float32) take 0.031 ms at 3.35 TB/s.
//
// The walk back needs h_{t-1} in reverse order.  Pass 1 runs the forward
// recurrence and keeps the state at chunk starts (every kChunk = 8 steps)
// in a scratch buffer; then the walk takes the chunks from the last: it
// recomputes the chunk's states from its checkpoint into shared memory
// and walks them backward.  The states are recomputed with the forward
// kernel's arithmetic (__fmul_rn, fmaf, expf), so they are its states bit
// for bit.
//
// The first design (4 lanes of 4 states a channel, 256 threads a block,
// 16-step chunks) took 0.92 ms at the training shape on an H100, 28.8x
// its bound.  It waited on device memory about two thirds of its time:
// each of its 1,520 sequential steps loaded u, delta and B (the walk also
// C and gy) from device memory and nothing was fetched ahead, with 15.5
// warps an SM to hide it.  It took three exponentials per (b, t, d, s)
// and 28 shuffles a step in the walk.  This design:
//
// * stages every chunk's tiles in shared memory before use, with
//   cp.async, two stages deep: the walk's chunk of kChunk steps (u, delta
//   and gy [kChunk x 64 channels], the B and C rows) lands while the chunk
//   before it is walked, and is read by both the recompute and the walk.
//   Pass 1 needs only u, delta and B and none of the walk's shared memory
//   yet, so it stages kChunk1 = 32 steps at a time in the place of the
//   chunk states (a quarter of the barriers of 8-step stages).  Each
//   landed stage is widened to float32 once (u, delta, gy as one float4
//   a channel and step; B and C as one float4 a lane and step), so no step
//   reads device memory or computes an address offset.  The forward
//   kernel's 16-byte copies of the aligned bytes around each row are
//   reused; a kAligned instantiation (the rows of u, delta and gy at
//   multiples of 16 bytes, as at the model's widths) drops the offset
//   arithmetic.  The checkpoint a walk chunk starts from is loaded into
//   registers one chunk ahead.
// * splits a channel's 16 states over kGroups = 8 lanes of 2 states: 512
//   threads a block for 64 channels, so the grid at the training shape
//   (128 x 2 blocks) holds 31 warps an SM, twice the first design's, all
//   resident in one wave of 2 blocks an SM.  That caps the registers at 64
//   and the shared memory at 113 KB a block, hence 8-step chunks (64 KB of
//   states).
// * takes two exponentials per (b, t, d, s), in pass 1 and in the
//   recompute: the recompute keeps a_t beside h_t (one float4 a thread
//   and step) and the walk reads both.
// * sums du and ddelta over a channel's 8 lanes by a reduce-scatter (3
//   shuffles for the two sums), and dB and dC over a warp's 4 channels by
//   another (3 shuffles for the lane's 4 terms): each xor round halves
//   what a lane carries, leaving each lane one of the warp's 32 sums of
//   the step (dB or dC of one state), which it stores.  The block's 16
//   warps are added in a fixed pairwise order once a chunk, while the
//   next chunk is widened.  6 shuffles a step, where the first design took
//   28.
// * keeps each chunk's du and ddelta in shared memory and writes its rows
//   coalesced, with its dB and dC, while the next chunk is widened.
// A full chunk (n == kChunk) runs its steps unrolled and unchecked
// (kFull).  ptxas (sm_90a, CUDA 12.8): 64 registers, at most 4 bytes of
// spill, 103,296 bytes of dynamic shared memory a block for bfloat16 and
// float16, 110,464 for float32; selective_scan_bwd_attributes reports the
// registers, shared memory and resident blocks the card gives.
//
// Reductions, all in a fixed order (no atomics: two runs on the same
// inputs are bitwise equal):
// * du, ddelta over a channel's states and dB, dC over a warp's channels:
//   the xor rounds above;
// * dB, dC over the warps of a block pairwise at the end of each chunk,
//   into per-block partials [tiles, Bt, L, S] in scratch;
// * dA, dD over the sequence in registers, into per-row partials
//   [Bt, Di, S] and [Bt, Di];
// * a second launch (scan_bwd_reduce) adds the partials over channel
//   tiles (dB, dC) and batch rows (dA, dD) in index order.
//
// Inputs u, delta, B, C in one element type (float32, bfloat16, float16),
// read as they lie; A, D, gy, gh float32; du, ddelta, dB, dC are written
// in the element type, rounded to nearest even as a float32 tensor's
// .to(dtype) rounds; dA, dD float32.  expf, no --use_fast_math.  Any
// L >= 1, Di >= 1, 1 <= S <= kMaxS, Bt <= 65535: the channel tail and the
// states past S are zeros in shared memory, and the last chunk is short.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxS = 16;
constexpr int kPer = 2;                   // states per thread
constexpr int kGroups = kMaxS / kPer;     // threads per channel
constexpr int kTileD = 64;                // channels per block
constexpr int kThreads = kTileD * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                 // steps per checkpoint and stage
constexpr int kStages = 2;                // chunks staged at once
constexpr int kChunk1 = 32;               // steps per stage of pass 1
constexpr int kMinBlocks = 2;             // resident blocks per SM wanted
constexpr int kReduceThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename E>
__device__ __forceinline__ E narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's newest copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Shared-memory layout of one stage (one chunk's tiles as they lie), in
// bytes, for element type E.
template <typename E>
struct Stage {
  // one row: kTileD elements plus the 16 bytes an unaligned start adds
  static constexpr int kRow = kTileD * sizeof(E) + 16;
  static constexpr int kGyRow = kTileD * sizeof(float) + 16;
  // B or C of one chunk: kChunk * kMaxS elements plus both ragged ends
  static constexpr int kFlat = kChunk * kMaxS * sizeof(E) + 32;
  static constexpr int kU = 0;
  static constexpr int kDt = kU + kChunk * kRow;
  static constexpr int kGy = kDt + kChunk * kRow;
  static constexpr int kB = kGy + kChunk * kGyRow;
  static constexpr int kC = kB + kFlat;
  static constexpr int kBytes = kC + kFlat;
};

// The block's shared memory, in bytes.
template <typename E>
struct Smem {
  // float4 [kChunk][kThreads]: each thread's h_t (2 states), then a_t
  static constexpr int kState = 0;
  static constexpr int kStage = kState + kChunk * kThreads * 16;
  // float4 [kChunk][kTileD]: u, delta, gy, 0 of a channel and step
  static constexpr int kUdg = kStage + kStages * Stage<E>::kBytes;
  // float4 [kChunk][kGroups]: a lane's two B, then its two C, of a step
  static constexpr int kBC = kUdg + kChunk * kTileD * 16;
  // float [kChunk][kWarps][2 * kMaxS]: each warp's dB, dC sums of a step
  static constexpr int kRed = kBC + kChunk * kGroups * 16;
  // E [2][kChunk][kTileD]: du, then ddelta, of the chunk
  static constexpr int kOut = kRed + kChunk * kWarps * 2 * kMaxS * 4;
  static constexpr int kBytes = kOut + 2 * kChunk * kTileD * sizeof(E);
};
// kMinBlocks blocks of the float32 instantiation in an SM's 228 KB (each
// block also takes 1 KB the hardware reserves)
static_assert(kMinBlocks * (Smem<float>::kBytes + 1024) <= 228 * 1024,
              "shared memory per block");
static_assert(kStages >= 2, "a chunk's copies fly while another is used");

// Pass 1 reads only u, delta and B, and nothing of the walk's shared
// memory yet: it stages kChunk1 steps at a time, two stages deep, in the
// chunk states' place.
template <typename E>
struct Pass1 {
  static constexpr int kRow = Stage<E>::kRow;
  static constexpr int kFlat = kChunk1 * kMaxS * sizeof(E) + 32;
  static constexpr int kU = 0;
  static constexpr int kDt = kU + kChunk1 * kRow;
  static constexpr int kB = kDt + kChunk1 * kRow;
  static constexpr int kStage = kB + kFlat;
  // float2 [kChunk1][kTileD]: u, delta; float2 [kChunk1][kGroups]: B, B
  static constexpr int kUd = 2 * kStage;
  static constexpr int kB2 = kUd + kChunk1 * kTileD * 8;
  static constexpr int kBytes = kB2 + kChunk1 * kGroups * 8;
};
static_assert(Pass1<float>::kBytes <= Smem<float>::kStage,
              "pass 1 fits in the chunk states' place");
static_assert(kChunk1 % kChunk == 0 && Pass1<float>::kStage % 16 == 0,
              "whole checkpoint chunks, aligned stages");
// stage_range's copies: one a thread (C's from thread kThreads / 2 on)
static_assert(Pass1<float>::kFlat / 16 <= kThreads &&
                  Stage<float>::kFlat / 16 <= kThreads / 2,
              "one 16-byte copy a thread");

// The 16-byte chunks that cover the bytes [a, a + len): the first one's
// address, and how many.
__device__ __forceinline__ uintptr_t cover_lo(uintptr_t a) {
  return a & ~uintptr_t(15);
}
__device__ __forceinline__ int cover_n(uintptr_t a, int len) {
  return static_cast<int>((a + len + 15 - cover_lo(a)) >> 4);
}

// Issue the 16-byte copies that cover the bytes [src, src + len) into
// dst, one a thread from thread first on; the data then starts at byte
// (src mod 16) of dst.
__device__ __forceinline__ void stage_range(char* dst, const void* src,
                                            int len, int first) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < cover_n(a, len)) {
    cp_async16(dst + 16 * i,
               reinterpret_cast<const char*>(cover_lo(a)) + 16 * i);
  }
}

// Copy piece i of the 16-byte pieces that cover a row's len bytes at src
// into dst (kAligned: src is a multiple of 16).
template <bool kAligned>
__device__ __forceinline__ void stage_piece(char* dst, const void* src,
                                            int len, int i) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = kAligned ? a : cover_lo(a);
  const int n = kAligned ? (len + 15) >> 4 : cover_n(a, len);
  if (i < n) {
    cp_async16(dst + 16 * i, reinterpret_cast<const char*>(lo) + 16 * i);
  }
}

// Where a chunk lies: steps t0 .. t0 + n - 1 of batch row b (rows row0 +
// t0 ..), channels d0 .. d0 + nd - 1.
struct Span {
  long long row0;
  int t0, n, Di, d0, nd, S;
};

// The 16-byte pieces of a row of the u, delta and gy tiles: thread
// (k, i) of the first kChunk * kPieces copies piece i of row k.
constexpr int kPieces = (kTileD * sizeof(float) + 16) / 16;
static_assert(kChunk * kPieces <= kThreads, "one piece a thread");
// thread (k, c) widens and writes back element c of row k of the tiles
static_assert(kChunk * kTileD == kThreads, "one element a thread");

// Issue the copies of one walk chunk's tiles into the stage st: the u,
// delta and gy rows, the B and C rows.
template <typename E, bool kAligned>
__device__ __forceinline__ void stage_chunk(char* st, const E* u,
                                            const E* delta, const float* gy,
                                            const E* B, const E* C,
                                            const Span& sp) {
  const int k = threadIdx.x / kPieces;
  const int i = threadIdx.x - k * kPieces;
  if (k < sp.n) {
    const long long o = (sp.row0 + sp.t0 + k) * sp.Di + sp.d0;
    const int len = sp.nd * static_cast<int>(sizeof(E));
    stage_piece<kAligned>(st + Stage<E>::kU + k * Stage<E>::kRow, u + o, len,
                          i);
    stage_piece<kAligned>(st + Stage<E>::kDt + k * Stage<E>::kRow, delta + o,
                          len, i);
    stage_piece<kAligned>(st + Stage<E>::kGy + k * Stage<E>::kGyRow, gy + o,
                          sp.nd * static_cast<int>(sizeof(float)), i);
  }
  const long long fo = (sp.row0 + sp.t0) * sp.S;
  const int flen = sp.n * sp.S * static_cast<int>(sizeof(E));
  stage_range(st + Stage<E>::kB, B + fo, flen, 0);
  stage_range(st + Stage<E>::kC, C + fo, flen, kThreads / 2);
}

// Widen a landed stage to float32: udg[k][c] = (u, delta, gy, 0) and
// bc[k][g] = (B of states 2g, 2g+1, C of the same), zeros past the steps,
// the channels and the states.
template <typename E, bool kAligned>
__device__ __forceinline__ void widen_chunk(const char* st, float4* udg,
                                            float4* bc, const E* u,
                                            const E* delta, const float* gy,
                                            const E* B, const E* C,
                                            const Span& sp) {
  const int k = threadIdx.x / kTileD;
  const int c = threadIdx.x - k * kTileD;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k < sp.n && c < sp.nd) {
    unsigned mu = 0, mt = 0, mg = 0;   // where each row's data starts
    if (!kAligned) {
      const long long o = (sp.row0 + sp.t0 + k) * sp.Di + sp.d0;
      mu = reinterpret_cast<uintptr_t>(u + o) & 15u;
      mt = reinterpret_cast<uintptr_t>(delta + o) & 15u;
      mg = reinterpret_cast<uintptr_t>(gy + o) & 15u;
    }
    const char* row = st + k * Stage<E>::kRow + c * sizeof(E);
    v.x = widen(*reinterpret_cast<const E*>(row + Stage<E>::kU + mu));
    v.y = widen(*reinterpret_cast<const E*>(row + Stage<E>::kDt + mt));
    v.z = *reinterpret_cast<const float*>(
        st + Stage<E>::kGy + k * Stage<E>::kGyRow + c * 4 + mg);
  }
  udg[threadIdx.x] = v;
  if (threadIdx.x < kChunk * kGroups) {
    const int kb = threadIdx.x / kGroups;
    const int s = (threadIdx.x - kb * kGroups) * kPer;
    const long long fo = (sp.row0 + sp.t0) * sp.S;
    const E* rb = reinterpret_cast<const E*>(
        st + Stage<E>::kB + (reinterpret_cast<uintptr_t>(B + fo) & 15));
    const E* rc = reinterpret_cast<const E*>(
        st + Stage<E>::kC + (reinterpret_cast<uintptr_t>(C + fo) & 15));
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kb < sp.n) {
      if (s < sp.S) w.x = widen(rb[kb * sp.S + s]);
      if (s + 1 < sp.S) w.y = widen(rb[kb * sp.S + s + 1]);
      if (s < sp.S) w.z = widen(rc[kb * sp.S + s]);
      if (s + 1 < sp.S) w.w = widen(rc[kb * sp.S + s + 1]);
    }
    bc[threadIdx.x] = w;
  }
}

// One step of this lane's two states, in the forward kernel's arithmetic
// (u, delta, and B of the two states): h advances, da gets a_t.
__device__ __forceinline__ void forward_step(float (&h)[kPer],
                                             const float (&a)[kPer],
                                             float ut, float dt, float b0,
                                             float b1, float (&da)[kPer]) {
  const float du = __fmul_rn(dt, ut);
  da[0] = expf(__fmul_rn(dt, a[0]));
  da[1] = expf(__fmul_rn(dt, a[1]));
  h[0] = fmaf(da[0], h[0], __fmul_rn(du, b0));
  h[1] = fmaf(da[1], h[1], __fmul_rn(du, b1));
}

// Advance this lane's two states over the chunk's n steps and keep h_t
// and a_t of each step in state.  kFull: n == kChunk, no step checks.
template <bool kFull>
__device__ __forceinline__ void advance_chunk(const float4* udg,
                                              const float4* bc,
                                              float4* state, float (&h)[kPer],
                                              const float (&a)[kPer], int n,
                                              int dl, int g) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (kFull || k < n) {
      const float4 x = udg[k * kTileD + dl];
      const float4 v = bc[k * kGroups + g];
      float da[kPer];
      forward_step(h, a, x.x, x.y, v.x, v.y, da);
      state[k * kThreads + threadIdx.x] =
          make_float4(h[0], h[1], da[0], da[1]);
    }
  }
}

// Issue the copies of pass 1's steps t0 .. t0 + n - 1 (u, delta and B)
// into the pass-1 stage st.
template <typename E, bool kAligned>
__device__ __forceinline__ void stage_pass1(char* st, const E* u,
                                            const E* delta, const E* B,
                                            const Span& sp) {
  constexpr int kP = Pass1<E>::kRow / 16;
  const int len = sp.nd * static_cast<int>(sizeof(E));
  for (int i = threadIdx.x; i < sp.n * kP; i += kThreads) {
    const int k = i / kP;
    const int piece = i - k * kP;
    const long long o = (sp.row0 + sp.t0 + k) * sp.Di + sp.d0;
    stage_piece<kAligned>(st + Pass1<E>::kU + k * Pass1<E>::kRow, u + o, len,
                          piece);
    stage_piece<kAligned>(st + Pass1<E>::kDt + k * Pass1<E>::kRow, delta + o,
                          len, piece);
  }
  stage_range(st + Pass1<E>::kB, B + (sp.row0 + sp.t0) * sp.S,
              sp.n * sp.S * static_cast<int>(sizeof(E)), 0);
}

// Widen a landed pass-1 stage: ud[k][c] = (u, delta), b2[k][g] = (B of
// states 2g, 2g + 1), zeros past the channels and the states.
template <typename E, bool kAligned>
__device__ __forceinline__ void widen_pass1(const char* st, float2* ud,
                                            float2* b2, const E* u,
                                            const E* delta, const E* B,
                                            const Span& sp) {
  for (int i = threadIdx.x; i < sp.n * kTileD; i += kThreads) {
    const int k = i / kTileD;
    const int c = i - k * kTileD;
    float2 v = make_float2(0.0f, 0.0f);
    if (c < sp.nd) {
      unsigned mu = 0, mt = 0;
      if (!kAligned) {
        const long long o = (sp.row0 + sp.t0 + k) * sp.Di + sp.d0;
        mu = reinterpret_cast<uintptr_t>(u + o) & 15u;
        mt = reinterpret_cast<uintptr_t>(delta + o) & 15u;
      }
      const char* row = st + k * Pass1<E>::kRow + c * sizeof(E);
      v.x = widen(*reinterpret_cast<const E*>(row + Pass1<E>::kU + mu));
      v.y = widen(*reinterpret_cast<const E*>(row + Pass1<E>::kDt + mt));
    }
    ud[i] = v;
  }
  const E* rb = reinterpret_cast<const E*>(
      st + Pass1<E>::kB +
      (reinterpret_cast<uintptr_t>(B + (sp.row0 + sp.t0) * sp.S) & 15));
  for (int i = threadIdx.x; i < sp.n * kGroups; i += kThreads) {
    const int k = i / kGroups;
    const int s = (i - k * kGroups) * kPer;
    b2[i] = make_float2(s < sp.S ? widen(rb[k * sp.S + s]) : 0.0f,
                        s + 1 < sp.S ? widen(rb[k * sp.S + s + 1]) : 0.0f);
  }
}

// Pass 1 over one checkpoint chunk (kChunk steps of ud, b2).
__device__ __forceinline__ void advance_pass1(const float2* ud,
                                              const float2* b2,
                                              float (&h)[kPer],
                                              const float (&a)[kPer], int dl,
                                              int g) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const float2 x = ud[k * kTileD + dl];
    const float2 v = b2[k * kGroups + g];
    float da[kPer];
    forward_step(h, a, x.x, x.y, v.x, v.y, da);
  }
}

// Walk the chunk's n steps backward from the states in state (h0: the
// state entering the chunk).  Each step's du and ddelta go to out, the
// warp's dB and dC sums of the step to red; carry (G past the chunk),
// gA and gD accumulate.
template <typename E, bool kFull>
__device__ __forceinline__ void walk_chunk(
    const float4* state, const float4* udg, const float4* bc, float* red,
    E* out, const float (&a)[kPer], const float (&h0)[kPer],
    float (&carry)[kPer], float (&gA)[kPer], float& gD, float dd, int n,
    int dl, int g) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool odd = (g & 1) != 0;         // keeps ddelta (else du's sum)
  const bool hi_c = (lane & 8) != 0;     // keeps dC (else dB)
  const bool hi_s = (lane & 16) != 0;    // keeps state 2g + 1 (else 2g)
  // this lane's slot of a step's warp sums, and of a step's du or ddelta
  float* red_lane = red + (tid >> 5) * 2 * kMaxS + (hi_c ? kMaxS : 0) +
                    kPer * g + (hi_s ? 1 : 0);
  E* out_lane = out + (g & 1) * kChunk * kTileD + dl;
  if (kFull) n = kChunk;
  float4 sk = state[(n - 1) * kThreads + tid];
  float hc[kPer] = {sk.x, sk.y};         // h_k
  float da[kPer] = {sk.z, sk.w};         // a_k
#pragma unroll
  for (int k = kChunk - 1; k >= 0; --k) {
    if (kFull || k < n) {
      float hp[kPer], dap[kPer] = {0.0f, 0.0f};  // h_{k-1}, a_{k-1}
      if (k > 0) {
        sk = state[(k - 1) * kThreads + tid];
        hp[0] = sk.x, hp[1] = sk.y, dap[0] = sk.z, dap[1] = sk.w;
      } else {
        hp[0] = h0[0], hp[1] = h0[1];
      }
      const float4 x = udg[k * kTileD + dl];   // u, delta, gy
      const float4 v = bc[k * kGroups + g];    // B, B, C, C
      const float bv[kPer] = {v.x, v.y};
      const float cv[kPer] = {v.z, v.w};
      const float dtu = __fmul_rn(x.y, x.x);
      float gx[kPer], gb[kPer], pb[kPer], pc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float G = fmaf(cv[j], x.z, carry[j]);           // dL/dh_t
        gx[j] = __fmul_rn(__fmul_rn(G, hp[j]), da[j]);        // dL/d(dt*A)
        gb[j] = __fmul_rn(G, bv[j]);
        gA[j] = fmaf(gx[j], x.y, gA[j]);
        pb[j] = __fmul_rn(G, dtu);
        pc[j] = __fmul_rn(x.z, hc[j]);
        carry[j] = __fmul_rn(da[j], G);
      }
      const float sgb = __fadd_rn(gb[0], gb[1]);
      const float sdt =
          fmaf(sgb, x.x, fmaf(gx[1], a[1], __fmul_rn(gx[0], a[0])));
      // du's and ddelta's sums over the channel's 8 lanes: even lanes
      // keep du's, odd ones ddelta's, after the first round
      float keep = odd ? sdt : sgb;
      keep = __fadd_rn(keep, __shfl_xor_sync(kFullMask, odd ? sgb : sdt, 1));
      keep = __fadd_rn(keep, __shfl_xor_sync(kFullMask, keep, 2));
      keep = __fadd_rn(keep, __shfl_xor_sync(kFullMask, keep, 4));
      const float val = odd ? keep : fmaf(dd, x.z, __fmul_rn(x.y, keep));
      if (g < 2) out_lane[k * kTileD] = narrow<E>(val);
      gD = fmaf(x.z, x.x, gD);
      // dB's and dC's sums over the warp's 4 channels: lane bit 3 picks dB
      // or dC, then lane bit 4 one of the lane's two states
      float k0 = hi_c ? pc[0] : pb[0];
      float k1 = hi_c ? pc[1] : pb[1];
      k0 = __fadd_rn(k0, __shfl_xor_sync(kFullMask, hi_c ? pb[0] : pc[0], 8));
      k1 = __fadd_rn(k1, __shfl_xor_sync(kFullMask, hi_c ? pb[1] : pc[1], 8));
      float kk = hi_s ? k1 : k0;
      kk = __fadd_rn(kk, __shfl_xor_sync(kFullMask, hi_s ? k0 : k1, 16));
      red_lane[k * kWarps * 2 * kMaxS] = kk;
      hc[0] = hp[0], hc[1] = hp[1], da[0] = dap[0], da[1] = dap[1];
    }
  }
}

template <typename E, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_bwd_kernel(const E* __restrict__ u, const E* __restrict__ delta,
                    const float* __restrict__ A, const E* __restrict__ B,
                    const E* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ gy,
                    const float* __restrict__ gh, E* __restrict__ du,
                    E* __restrict__ ddelta, float* __restrict__ ckpt,
                    float* __restrict__ part_b, float* __restrict__ part_c,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    int Bt, int L, int Di, int S) {
  using M = Smem<E>;
  extern __shared__ __align__(16) char smem[];
  float4* state = reinterpret_cast<float4*>(smem + M::kState);
  char* stages = smem + M::kStage;
  float4* udg = reinterpret_cast<float4*>(smem + M::kUdg);
  float4* bc = reinterpret_cast<float4*>(smem + M::kBC);
  float* red = reinterpret_cast<float*>(smem + M::kRed);
  E* out = reinterpret_cast<E*>(smem + M::kOut);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int d0 = tile * kTileD;
  const int nd = min(kTileD, Di - d0);
  const int g = tid & (kGroups - 1);               // state group
  const int dl = tid / kGroups;                    // channel in the tile
  const int d = d0 + dl;
  const bool live = dl < nd;
  const int s0 = g * kPer;
  const int nact = live ? max(0, min(kPer, S - s0)) : 0;
  const long long row0 = static_cast<long long>(b) * L;
  const int chunks = (L + kChunk - 1) / kChunk;
  const long long rows = static_cast<long long>(Bt) * L;

  float a[kPer], carry[kPer], gA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[j] = j < nact ? A[static_cast<long long>(d) * S + s0 + j] : 0.0f;
    carry[j] = j < nact
                   ? gh[(static_cast<long long>(b) * Di + d) * S + s0 + j]
                   : 0.0f;
    gA[j] = 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;
  float gD = 0.0f;
  // the states entering chunks 1 .. chunks - 2 (the last chunk's stays in
  // registers), this thread's pair of each: [Bt, tiles, chunks - 2,
  // kThreads] float2
  const int nck = max(chunks - 2, 0);
  float2* ck = reinterpret_cast<float2*>(ckpt) +
               (static_cast<long long>(b) * gridDim.x + tile) * nck *
                   kThreads +
               tid;

  // The walk goes over chunks chunks - 1 .. 0 (job j: chunk chunks - 1
  // - j); each job's tiles are staged kStages - 1 jobs ahead, and each
  // chunk's sums and rows are written out during the next job's
  // widening (or after the last job).
  auto span_of = [&](int j) {
    const int c = chunks - 1 - j;
    return Span{row0, c * kChunk, min(kChunk, L - c * kChunk), Di, d0, nd,
                S};
  };
  auto stage = [&](int j) {
    if (j < chunks) {
      stage_chunk<E, kAligned>(stages + (j % kStages) * Stage<E>::kBytes, u,
                               delta, gy, B, C, span_of(j));
    }
    cp_async_commit();                    // one group a job, even if empty
  };
  // this block's dB and dC of a walked chunk (thread (k, slot) adds the
  // 16 warps' sums pairwise, in a fixed order), and its du and ddelta
  // rows (thread (k, c) writes one of each)
  auto flush = [&](const Span& sp) {
    if (tid < sp.n * 2 * kMaxS) {
      const int k = tid / (2 * kMaxS);
      const int slot = tid - k * 2 * kMaxS;
      const int s = slot & (kMaxS - 1);
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v[w] = red[(k * kWarps + w) * 2 * kMaxS + slot];
      }
#pragma unroll
      for (int m = 1; m < kWarps; m <<= 1) {
#pragma unroll
        for (int w = 0; w < kWarps; w += 2 * m) {
          v[w] = __fadd_rn(v[w], v[w + m]);
        }
      }
      if (s < S) {
        (slot < kMaxS ? part_b : part_c)
            [(tile * rows + row0 + sp.t0 + k) * S + s] = v[0];
      }
    }
    const int k = tid / kTileD;
    const int cl = tid - k * kTileD;
    if (k < sp.n && cl < nd) {
      const long long o = (row0 + sp.t0 + k) * Di + d0 + cl;
      du[o] = out[tid];
      ddelta[o] = out[kThreads + tid];
    }
  };
  // the walk's first stages land during pass 1
  for (int j = 0; j < kStages - 1; ++j) stage(j);

  // Pass 1: the forward states over chunks 0 .. chunks - 2, kChunk1 steps
  // a stage, in the chunk states' place; the state entering each chunk
  // 1 .. chunks - 2 goes to ck, the last chunk's stays in h.
  float h[kPer] = {0.0f, 0.0f};
  {
    char* st1 = smem + M::kState;
    float2* ud = reinterpret_cast<float2*>(st1 + Pass1<E>::kUd);
    float2* b2 = reinterpret_cast<float2*>(st1 + Pass1<E>::kB2);
    const int steps = (chunks - 1) * kChunk;
    const int jobs1 = (steps + kChunk1 - 1) / kChunk1;
    auto span1 = [&](int j) {
      return Span{row0, j * kChunk1, min(kChunk1, steps - j * kChunk1), Di, d0,
                  nd, S};
    };
    if (jobs1 > 0) stage_pass1<E, kAligned>(st1, u, delta, B, span1(0));
    cp_async_commit();
    for (int j = 0; j < jobs1; ++j) {
      const Span sp = span1(j);
      cp_async_wait<0>();
      __syncthreads();
      if (j + 1 < jobs1) {
        stage_pass1<E, kAligned>(st1 + ((j + 1) & 1) * Pass1<E>::kStage, u,
                                 delta, B, span1(j + 1));
      }
      cp_async_commit();
      widen_pass1<E, kAligned>(st1 + (j & 1) * Pass1<E>::kStage, ud, b2, u,
                               delta, B, sp);
      __syncthreads();
      for (int q = 0; q < sp.n / kChunk; ++q) {
        advance_pass1(ud + q * kChunk * kTileD, b2 + q * kChunk * kGroups, h,
                      a, dl, g);
        const int c = sp.t0 / kChunk + q;
        if (c + 1 <= chunks - 2) {
          ck[static_cast<long long>(c) * kThreads] = make_float2(h[0], h[1]);
        }
      }
    }
  }

  float2 next = make_float2(0.0f, 0.0f);  // the next walk chunk's h0
  for (int j = 0; j < chunks; ++j) {
    const Span sp = span_of(j);
    const int c = sp.t0 / kChunk;
    // this job's tiles have landed, and every thread is done with the
    // last job's (or pass 1's) shared memory
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage(j + kStages - 1);
    if (j > 0) flush(span_of(j - 1));
    widen_chunk<E, kAligned>(stages + (j % kStages) * Stage<E>::kBytes, udg,
                             bc, u, delta, gy, B, C, sp);
    if (j > 0) h[0] = next.x, h[1] = next.y;
    const float h0[kPer] = {h[0], h[1]};
    next = c >= 2 ? ck[static_cast<long long>(c - 2) * kThreads]
                  : make_float2(0.0f, 0.0f);
    __syncthreads();
    if (sp.n == kChunk) {
      advance_chunk<true>(udg, bc, state, h, a, sp.n, dl, g);
      walk_chunk<E, true>(state, udg, bc, red, out, a, h0, carry, gA, gD,
                          dd, sp.n, dl, g);
    } else {
      advance_chunk<false>(udg, bc, state, h, a, sp.n, dl, g);
      walk_chunk<E, false>(state, udg, bc, red, out, a, h0, carry, gA, gD,
                           dd, sp.n, dl, g);
    }
  }
  __syncthreads();
  flush(span_of(chunks - 1));
  // this row's dA and dD of the tile's channels
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < nact) {
      part_a[(static_cast<long long>(b) * Di + d) * S + s0 + j] = gA[j];
    }
  }
  if (live && g == 0) part_d[static_cast<long long>(b) * Di + d] = gD;
}

// dB, dC = the tiles' partials added in tile order; dA, dD = the rows'
// partials added in row order.
template <typename E>
__global__ void __launch_bounds__(kReduceThreads)
    scan_bwd_reduce(const float* __restrict__ part_b,
                    const float* __restrict__ part_c,
                    const float* __restrict__ part_a,
                    const float* __restrict__ part_d, E* __restrict__ dB,
                    E* __restrict__ dC, float* __restrict__ dA,
                    float* __restrict__ dD, int tiles, int Bt,
                    long long nbc, int Di, int S) {
  const long long na = static_cast<long long>(Di) * S;
  const long long total = 2 * nbc + na + Di;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long o = is_c ? i - nbc : i;
      const float* p = is_c ? part_c : part_b;
      for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, p[t * nbc + o]);
      (is_c ? dC : dB)[o] = narrow<E>(acc);
    } else if (i < 2 * nbc + na) {
      const long long o = i - 2 * nbc;
      for (int b = 0; b < Bt; ++b) acc = __fadd_rn(acc, part_a[b * na + o]);
      dA[o] = acc;
    } else {
      const long long o = i - 2 * nbc - na;
      for (int b = 0; b < Bt; ++b) {
        acc = __fadd_rn(acc, part_d[static_cast<long long>(b) * Di + o]);
      }
      dD[o] = acc;
    }
  }
}

struct Scratch {
  long long ckpt, part, part_a, part_d;   // floats of each piece
};

Scratch scratch_of(int Bt, int L, int Di, int S) {
  const long long chunks = (L + kChunk - 1) / kChunk;
  const long long tiles = (Di + kTileD - 1) / kTileD;
  const long long nck = chunks > 2 ? chunks - 2 : 0;
  return {static_cast<long long>(Bt) * tiles * nck * kThreads * kPer,
          tiles * Bt * L * S, static_cast<long long>(Bt) * Di * S,
          static_cast<long long>(Bt) * Di};
}

// The walk kernel's dynamic shared memory (over the 48 KB a launch may
// take unasked) and the carveout that fits kMinBlocks of it in an SM.
template <typename E, bool kAligned>
cudaError_t prepare() {
  cudaError_t e = cudaFuncSetAttribute(
      scan_bwd_kernel<E, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<E>::kBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      scan_bwd_kernel<E, kAligned>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

template <typename E, bool kAligned>
cudaError_t attributes(int* out) {
  cudaError_t e = prepare<E, kAligned>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, scan_bwd_kernel<E, kAligned>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, scan_bwd_kernel<E, kAligned>, kThreads, Smem<E>::kBytes);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = Smem<E>::kBytes;
  out[3] = kThreads;
  out[4] = blocks;
  out[5] = kTileD;
  return cudaSuccess;
}

template <typename E>
cudaError_t attributes(bool aligned, int* out) {
  return aligned ? attributes<E, true>(out) : attributes<E, false>(out);
}

template <typename E, bool kAligned>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* gy, const void* gh, void* du, void* ddelta,
                   void* dA, void* dB, void* dC, void* dD, float* scratch,
                   int Bt, int L, int Di, int S, int sms,
                   cudaStream_t stream) {
  const Scratch sz = scratch_of(Bt, L, Di, S);
  float* ckpt = scratch;
  float* part_b = ckpt + sz.ckpt;
  float* part_c = part_b + sz.part;
  float* part_a = part_c + sz.part;
  float* part_d = part_a + sz.part_a;
  cudaError_t e = prepare<E, kAligned>();
  if (e != cudaSuccess) return e;
  const int tiles = (Di + kTileD - 1) / kTileD;
  scan_bwd_kernel<E, kAligned>
      <<<dim3(tiles, Bt), kThreads, Smem<E>::kBytes, stream>>>(
          static_cast<const E*>(u), static_cast<const E*>(delta),
          static_cast<const float*>(A), static_cast<const E*>(B),
          static_cast<const E*>(C), static_cast<const float*>(D),
          static_cast<const float*>(gy), static_cast<const float*>(gh),
          static_cast<E*>(du), static_cast<E*>(ddelta), ckpt, part_b, part_c,
          part_a, part_d, Bt, L, Di, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long nbc = static_cast<long long>(Bt) * L * S;
  const long long total = 2 * nbc + static_cast<long long>(Di) * S + Di;
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  scan_bwd_reduce<E><<<blocks, kReduceThreads, 0, stream>>>(
      part_b, part_c, part_a, part_d, static_cast<E*>(dB),
      static_cast<E*>(dC), static_cast<float*>(dA), static_cast<float*>(dD),
      tiles, Bt, nbc, Di, S);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(bool aligned, const void* u, const void* delta,
                   const void* A, const void* B, const void* C,
                   const void* D, const void* gy, const void* gh, void* du,
                   void* ddelta, void* dA, void* dB, void* dC, void* dD,
                   float* scratch, int Bt, int L, int Di, int S, int sms,
                   cudaStream_t stream) {
  return aligned ? launch<E, true>(u, delta, A, B, C, D, gy, gh, du, ddelta,
                                   dA, dB, dC, dD, scratch, Bt, L, Di, S,
                                   sms, stream)
                 : launch<E, false>(u, delta, A, B, C, D, gy, gh, du, ddelta,
                                    dA, dB, dC, dD, scratch, Bt, L, Di, S,
                                    sms, stream);
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// float32 scratch elements a launch at this shape takes
extern "C" long long selective_scan_bwd_scratch_floats(int Bt, int L, int Di,
                                                       int S) {
  const Scratch sz = scratch_of(Bt, L, Di, S);
  return sz.ckpt + 2 * sz.part + sz.part_a + sz.part_d;
}

// What the walk kernel's instantiation for a dtype code (and aligned: the
// rows of u, delta and gy start at multiples of 16 bytes) uses: registers
// per thread, static and dynamic shared memory per block, threads per
// block, resident blocks per SM (the occupancy calculator's) and channels
// per block (a grid has ceil(Di / channels) x Bt blocks).
extern "C" int selective_scan_bwd_attributes(int dtype, int aligned,
                                             int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (dtype) {
    case 0:
      return static_cast<int>(attributes<float>(aligned != 0, out));
    case 1:
      return static_cast<int>(attributes<__nv_bfloat16>(aligned != 0, out));
    case 2:
      return static_cast<int>(attributes<__half>(aligned != 0, out));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int selective_scan_bwd_launch(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* gy, const void* gh, void* du,
    void* ddelta, void* dA, void* dB, void* dC, void* dD, void* scratch,
    long long scratch_floats, int Bt, int L, int Di, int S, int dtype,
    int device, void* stream) {
  if (Bt < 1 || Bt > 65535 || L < 1 || Di < 1 || S < 1 || S > kMaxS ||
      dtype < 0 || dtype > 2 ||
      scratch_floats < selective_scan_bwd_scratch_floats(Bt, L, Di, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the 16-byte fast path: every row of u, delta and gy starts at a
  // multiple of 16 bytes
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(u) |
                         reinterpret_cast<uintptr_t>(delta) |
                         reinterpret_cast<uintptr_t>(gy);
  const bool aligned = (ptrs & 15) == 0 &&
                       (static_cast<long long>(Di) * elem_size(dtype)) % 16 ==
                           0 &&
                       Di % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      e = launch<float>(aligned, u, delta, A, B, C, D, gy, gh, du, ddelta, dA,
                        dB, dC, dD, sc, Bt, L, Di, S, sms, s);
      break;
    case 1:
      e = launch<__nv_bfloat16>(aligned, u, delta, A, B, C, D, gy, gh, du,
                                ddelta, dA, dB, dC, dD, sc, Bt, L, Di, S, sms,
                                s);
      break;
    default:
      e = launch<__half>(aligned, u, delta, A, B, C, D, gy, gh, du, ddelta,
                         dA, dB, dC, dD, sc, Bt, L, Di, S, sms, s);
      break;
  }
  return static_cast<int>(e);
}
