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
// The walk back needs h_{t-1} in reverse order.  A block of 256 threads
// takes 64 channels of one batch row, each channel's 16 states split over
// 4 neighbouring lanes, as the forward does.  Pass 1 runs the forward
// recurrence and keeps the state at each chunk start (every kChunk = 16
// steps) in a scratch buffer; pass 2 walks the chunks from the last:
// it recomputes the chunk's states from its checkpoint into shared
// memory (each thread its own float4 a step, 64 KB a block), then walks
// them backward.  The states are recomputed with the forward kernel's
// arithmetic (__fmul_rn, fmaf, expf), so they are its states bit for bit.
//
// Reductions, all in a fixed order (no atomics: two runs on the same
// inputs are bitwise equal):
// * du, ddelta over a channel's states: two xor shuffles, as the forward;
// * dB, dC over channels: three xor shuffles within a warp (8 channels),
//   the 8 warps' sums in shared memory added in warp order at the end of
//   each chunk, into per-block partials [tiles, Bt, L, S] in scratch;
// * dA, dD over the sequence in registers, into per-row partials
//   [Bt, Di, S] and [Bt, Di];
// * a second launch (scan_bwd_reduce) adds the partials over channel
//   tiles (dB, dC) and batch rows (dA, dD) in index order.
//
// Bound on the card at the training shape (Bt 2, L 512, Di 8192, S 16,
// bf16): operations.  The Bt*L*Di*S = 134M exponentials at the SFU rate
// (16 per clock per SM, 132 SMs, 1.98 GHz) take 0.032 ms; the bytes (u,
// delta, B, C, du, ddelta, dB, dC at 2 bytes, gy in float32, gh, A, D,
// dA, dD in float32) take 0.022 ms at 3.35 TB/s.  This kernel takes three
// exponentials per (b, t, d, s) (pass 1, the recompute, the walk back)
// and reads u, delta and B three times; it is the simple first design.
//
// Inputs u, delta, B, C in one element type (float32, bfloat16, float16),
// read as they lie; A, D, gy, gh float32; du, ddelta, dB, dC are written
// in the element type, rounded to nearest even as a float32 tensor's
// .to(dtype) rounds; dA, dD float32.  expf, no --use_fast_math.  Any
// L >= 1, Di >= 1, 1 <= S <= kMaxS, Bt <= 65535.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxS = 16;
constexpr int kPer = 4;                   // states per thread
constexpr int kGroups = kMaxS / kPer;     // threads per channel
constexpr int kTileD = 64;                // channels per block
constexpr int kThreads = kTileD * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                // steps per checkpoint
// the chunk's states (one float4 per thread and step), then the warps'
// dB and dC sums of the chunk
constexpr int kHsBytes = kChunk * kThreads * 16;
constexpr int kRedFloats = kWarps * kChunk * kMaxS;
constexpr int kSmemBytes = kHsBytes + 2 * kRedFloats * 4;
constexpr int kReduceThreads = 256;

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

// u, delta of channel d and B (and C) of this lane's states at row r
// (= b * L + t); zeros past the channels and the states.
template <typename E>
__device__ __forceinline__ void load_step(const E* u, const E* delta,
                                          const E* B, long long r, int Di,
                                          int d, int S, int s0, int nact,
                                          bool live, float& ut, float& dt,
                                          float (&bv)[kPer]) {
  ut = live ? widen(u[r * Di + d]) : 0.0f;
  dt = live ? widen(delta[r * Di + d]) : 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    bv[j] = j < nact ? widen(B[r * S + s0 + j]) : 0.0f;
  }
}

// One forward step, in the forward kernel's arithmetic.
__device__ __forceinline__ void advance(float (&h)[kPer],
                                        const float (&a)[kPer], float ut,
                                        float dt, const float (&bv)[kPer]) {
  const float du = __fmul_rn(dt, ut);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float da = expf(__fmul_rn(dt, a[j]));
    h[j] = fmaf(da, h[j], __fmul_rn(du, bv[j]));
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const E* __restrict__ u, const E* __restrict__ delta,
                    const float* __restrict__ A, const E* __restrict__ B,
                    const E* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ gy,
                    const float* __restrict__ gh, E* __restrict__ du,
                    E* __restrict__ ddelta, float* __restrict__ ckpt,
                    float* __restrict__ part_b, float* __restrict__ part_c,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    int Bt, int L, int Di, int S) {
  extern __shared__ __align__(16) char smem[];
  float4* hs = reinterpret_cast<float4*>(smem);           // [kChunk][kThreads]
  float* red_b = reinterpret_cast<float*>(smem + kHsBytes);  // [warp][k][s]
  float* red_c = red_b + kRedFloats;

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
  const int warp = tid / 32;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(b) * L;
  const int chunks = (L + kChunk - 1) / kChunk;
  const long long rows = static_cast<long long>(Bt) * L;

  float a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[j] = j < nact ? A[static_cast<long long>(d) * S + s0 + j] : 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;
  // the state entering chunk c >= 1, [Bt, chunks - 1, Di, S]
  auto ck = [&](int c) {
    return ckpt +
           ((static_cast<long long>(b) * (chunks - 1) + (c - 1)) * Di + d) *
               S +
           s0;
  };

  // ---- pass 1: the forward states at each chunk start ----------------
  float h[kPer] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < (chunks - 1) * kChunk; ++t) {
    float ut, dt, bv[kPer];
    load_step(u, delta, B, row0 + t, Di, d, S, s0, nact, live, ut, dt, bv);
    advance(h, a, ut, dt, bv);
    if ((t + 1) % kChunk == 0) {
      float* out = ck((t + 1) / kChunk);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j < nact) out[j] = h[j];
      }
    }
  }

  // ---- pass 2: the chunks from the last, each walked backward --------
  float carry[kPer], gA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    carry[j] = j < nact ? gh[(static_cast<long long>(b) * Di + d) * S + s0 + j]
                        : 0.0f;
    gA[j] = 0.0f;
  }
  float gD = 0.0f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, L - t0);
    float h0[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      h0[j] = (c > 0 && j < nact) ? ck(c)[j] : 0.0f;
      h[j] = h0[j];
    }
    for (int k = 0; k < n; ++k) {           // recompute the chunk's states
      float ut, dt, bv[kPer];
      load_step(u, delta, B, row0 + t0 + k, Di, d, S, s0, nact, live, ut, dt,
                bv);
      advance(h, a, ut, dt, bv);
      hs[k * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
    }
    for (int k = n - 1; k >= 0; --k) {      // and walk them backward
      const long long r = row0 + t0 + k;
      float ut, dt, bv[kPer], cv[kPer];
      load_step(u, delta, B, r, Di, d, S, s0, nact, live, ut, dt, bv);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        cv[j] = j < nact ? widen(C[r * S + s0 + j]) : 0.0f;
      }
      const float gyt = live ? gy[r * Di + d] : 0.0f;
      const float4 hc4 = hs[k * kThreads + tid];
      const float hc[kPer] = {hc4.x, hc4.y, hc4.z, hc4.w};
      float hp[kPer];
      if (k > 0) {
        const float4 hp4 = hs[(k - 1) * kThreads + tid];
        hp[0] = hp4.x, hp[1] = hp4.y, hp[2] = hp4.z, hp[3] = hp4.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) hp[j] = h0[j];
      }
      const float dtu = __fmul_rn(dt, ut);
      float sgb = 0.0f, sdt = 0.0f, pb[kPer], pc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float G = fmaf(cv[j], gyt, carry[j]);        // dL/dh_t
        const float da = expf(__fmul_rn(dt, a[j]));
        const float gx = __fmul_rn(__fmul_rn(G, hp[j]), da);  // dL/d(dt*A)
        const float gb = __fmul_rn(G, bv[j]);
        sdt = fmaf(gx, a[j], sdt);
        sdt = fmaf(gb, ut, sdt);
        sgb = __fadd_rn(sgb, gb);
        gA[j] = fmaf(gx, dt, gA[j]);
        pb[j] = __fmul_rn(G, dtu);
        pc[j] = __fmul_rn(gyt, hc[j]);
        carry[j] = __fmul_rn(da, G);
      }
      // the lanes of a channel: (p0 + p1) + (p2 + p3) on every lane
#pragma unroll
      for (int m = 1; m < kGroups; m <<= 1) {
        sgb = __fadd_rn(sgb, __shfl_xor_sync(0xffffffffu, sgb, m));
        sdt = __fadd_rn(sdt, __shfl_xor_sync(0xffffffffu, sdt, m));
      }
      if (live && g == 0) {
        du[r * Di + d] = narrow<E>(fmaf(dd, gyt, __fmul_rn(dt, sgb)));
        ddelta[r * Di + d] = narrow<E>(sdt);
        gD = fmaf(gyt, ut, gD);
      }
      // the 8 channels of a warp, per state
#pragma unroll
      for (int m = kGroups; m < 32; m <<= 1) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          pb[j] = __fadd_rn(pb[j], __shfl_xor_sync(0xffffffffu, pb[j], m));
          pc[j] = __fadd_rn(pc[j], __shfl_xor_sync(0xffffffffu, pc[j], m));
        }
      }
      if (lane < kGroups) {                  // lane g holds states s0..
        const int o = (warp * kChunk + k) * kMaxS + s0;
        *reinterpret_cast<float4*>(red_b + o) =
            make_float4(pb[0], pb[1], pb[2], pb[3]);
        *reinterpret_cast<float4*>(red_c + o) =
            make_float4(pc[0], pc[1], pc[2], pc[3]);
      }
    }
    __syncthreads();
    // this block's dB and dC of the chunk: the warps added in order
    for (int i = tid; i < n * S; i += kThreads) {
      const int k = i / S;
      const int s = i - k * S;
      float sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb = __fadd_rn(sb, red_b[(w * kChunk + k) * kMaxS + s]);
        sc = __fadd_rn(sc, red_c[(w * kChunk + k) * kMaxS + s]);
      }
      const long long o = (tile * rows + row0 + t0 + k) * S + s;
      part_b[o] = sb;
      part_c[o] = sc;
    }
    __syncthreads();                         // red_* is the next chunk's
  }
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
  return {static_cast<long long>(Bt) * (chunks - 1) * Di * S,
          tiles * Bt * L * S, static_cast<long long>(Bt) * Di * S,
          static_cast<long long>(Bt) * Di};
}

template <typename E>
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
  cudaError_t e = cudaFuncSetAttribute(
      scan_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  const int tiles = (Di + kTileD - 1) / kTileD;
  scan_bwd_kernel<E><<<dim3(tiles, Bt), kThreads, kSmemBytes, stream>>>(
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

}  // namespace

// float32 scratch elements a launch at this shape takes
extern "C" long long selective_scan_bwd_scratch_floats(int Bt, int L, int Di,
                                                       int S) {
  const Scratch sz = scratch_of(Bt, L, Di, S);
  return sz.ckpt + 2 * sz.part + sz.part_a + sz.part_d;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      e = launch<float>(u, delta, A, B, C, D, gy, gh, du, ddelta, dA, dB, dC,
                        dD, sc, Bt, L, Di, S, sms, s);
      break;
    case 1:
      e = launch<__nv_bfloat16>(u, delta, A, B, C, D, gy, gh, du, ddelta, dA,
                                dB, dC, dD, sc, Bt, L, Di, S, sms, s);
      break;
    default:
      e = launch<__half>(u, delta, A, B, C, D, gy, gh, du, ddelta, dA, dB, dC,
                         dD, sc, Bt, L, Di, S, sms, s);
      break;
  }
  return static_cast<int>(e);
}
