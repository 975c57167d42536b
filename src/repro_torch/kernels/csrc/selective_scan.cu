// selective_scan: the Mamba-1 forward recurrence (diagonal SSM, ZOH).
//
// Replaces the TPU kernel of src/repro/kernels/selective_scan.py:
//   selective_scan_pallas (body _selective_scan_kernel).
//
//   h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t      [Di, S]
//   y_t = sum_s h_t[:, s] * C_t[s] + D * u_t                      [Di]
//
// with u, delta [Bt, L, Di] and B, C [Bt, L, S] in one element type
// (float32, bfloat16 or float16, read as they lie and widened to float32
// in registers, which is exact), A float32[Di, S], D float32[Di], and
// float32 outputs y [Bt, L, Di] and h_last = h_{L-1} [Bt, Di, S].
//
// The TPU kernel carried h[block_d, S] in VMEM scratch across the
// sequential grid axis over chunks of L.  Blocks on Hopper run in no
// order, so the sequence axis is a loop inside the block.
//
// Bound on the card at the serve shape (Bt 4, L 1000, Di 8192, S 16):
// operations.  The Bt*L*Di*S = 524M exponentials at the SFU rate (16 per
// clock per SM, 132 SMs, 1.98 GHz) take 0.125 ms; the bytes (u, delta, B,
// C at their element size, y and h_last in float32: 0.26 GB at bf16)
// take 0.078 ms at 3.35 TB/s.
//
// The earlier design gave one thread one (b, d) and all S states: 8
// warps per SM at the serve shape, each waiting on two global loads and
// 16 dependent expf per step.  This one:
//
// * splits the S states of a channel over kGroups = 4 neighbouring lanes
//   (kPer = 4 states each, so a thread keeps 4 h and 4 A in registers);
//   a block of 256 threads covers kTileD = 64 channels of one batch row.
//   ptxas: 63-64 registers, no spills; 26,752 bytes of shared memory a
//   block for bf16 and fp16, 47,232 for float32; 4 blocks = 32 warps
//   resident per SM for every instantiation (the occupancy calculator,
//   selective_scan_attributes; the earlier design had 8).
//   The 4 partial h.C sums are combined by two xor shuffles (each lane
//   gets the same sum in the same order) and each lane stores y of one
//   step in four, so a warp stores 4 full 32-byte sectors.  Exactly one
//   expf per (b, t, d, s): a lane skips the states past S.  At the serve
//   shape the grid is 128 x 4 blocks, and __launch_bounds__(256, 4) caps
//   the registers so that 4 blocks (32 warps) stay resident per SM: the
//   whole grid is one wave.
// * stages u and delta tiles [kChunk steps x 64 channels] and the B and
//   C rows of the same steps in shared memory with cp.async, two chunks
//   deep: the next chunk loads while this one is computed.  Each copy is
//   a 16-byte cp.async of the aligned 16 bytes around the data (every
//   such chunk holds a byte of the tensor, so it lies in mapped memory);
//   a row's data starts at its address modulo 16 within its shared row.
//   When the pointers and the row pitch Di * sizeof(elem) are multiples
//   of 16 (the serve shape) that offset is 0 at compile time (kAligned).
//   A chunk of kChunk steps with S == kMaxS runs without bound checks
//   (kFull).  Each pays on an H100 at the serve shape: without kAligned
//   the kernel takes 8-11 % longer, without kFull 51-55 % (PERF.md,
//   benchmarks_torch/scan_variants.py).
//   B and C are widened once per chunk into float32 rows of stride kMaxS
//   that a thread reads as one float4 each.
// * reads the caller's element type, so the wrapper makes no float32
//   copy of u and delta.
//
// expf (not __expf), explicit roundings (__fmul_rn, fmaf) so that the
// float32 and the narrow instantiations compute bitwise the same on the
// same values, and no --use_fast_math keep the result within 1e-4 of the
// plain PyTorch version.  Any L >= 1, Di >= 1, 1 <= S <= kMaxS and
// Bt <= 65535 are taken: the channel tail is masked and the last chunk
// is short.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxS = 16;
constexpr int kPer = 4;                   // states per thread (4 | kPer)
constexpr int kGroups = kMaxS / kPer;     // threads per channel
constexpr int kTileD = 64;                // channels per block
constexpr int kThreads = kTileD * kGroups;
constexpr int kChunk = 32;                // steps per staged chunk
constexpr int kMinBlocks = 4;             // resident blocks per SM wanted

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory layout of one stage, in bytes, for element type E.
template <typename E>
struct Stage {
  // one row: kTileD elements plus the 16 bytes an unaligned start adds
  static constexpr int kRow = kTileD * sizeof(E) + 16;
  // B or C of one chunk: kChunk * kMaxS elements plus both ragged ends
  static constexpr int kFlat = kChunk * kMaxS * sizeof(E) + 32;
  static constexpr int kU = 0;
  static constexpr int kDt = kU + kChunk * kRow;
  static constexpr int kB = kDt + kChunk * kRow;
  static constexpr int kC = kB + kFlat;
  static constexpr int kBytes = kC + kFlat;
};

template <typename E>
constexpr int smem_bytes() {
  // two stages, then B and C of the current chunk widened to float32
  return 2 * Stage<E>::kBytes + 2 * kChunk * kMaxS * sizeof(float);
}
// under the 48 KB a launch may take without cudaFuncSetAttribute; 4
// blocks of the float32 instantiation (47,232 bytes) fit in an SM's 228 KB
static_assert(smem_bytes<float>() <= 48 * 1024, "shared memory per block");

// The 16-byte chunks that cover the bytes [a, a + len): the first one's
// address, and how many.
__device__ __forceinline__ uintptr_t cover_lo(uintptr_t a) {
  return a & ~uintptr_t(15);
}
__device__ __forceinline__ int cover_n(uintptr_t a, int len) {
  return static_cast<int>((a + len + 15 - cover_lo(a)) >> 4);
}

// Issue the 16-byte copies that cover the bytes [src, src + len) into
// dst; the data then starts at byte (src mod 16) of dst.
__device__ __forceinline__ void stage_range(char* dst, const char* src,
                                            int len, int first, int stride) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const char* lo = reinterpret_cast<const char*>(cover_lo(a));
  for (int i = first; i < cover_n(a, len); i += stride) {
    cp_async16(dst + 16 * i, lo + 16 * i);
  }
}

template <typename E>
__device__ __forceinline__ void stage_chunk(
    char* st, const E* u, const E* delta, const E* B, const E* C,
    long long row0, int t0, int n, int Di, int d0, int nd, int S) {
  constexpr int kRowChunks = Stage<E>::kRow / 16;
  const int tid = threadIdx.x;
  for (int i = tid; i < n * kRowChunks; i += kThreads) {
    const int k = i / kRowChunks;
    const int c = i - k * kRowChunks;
    const long long off = (row0 + t0 + k) * Di + d0;
    const int len = nd * static_cast<int>(sizeof(E));
    const uintptr_t a = reinterpret_cast<uintptr_t>(u + off);
    const uintptr_t b = reinterpret_cast<uintptr_t>(delta + off);
    if (c < cover_n(a, len)) {
      cp_async16(st + Stage<E>::kU + k * Stage<E>::kRow + 16 * c,
                 reinterpret_cast<const char*>(cover_lo(a)) + 16 * c);
    }
    if (c < cover_n(b, len)) {
      cp_async16(st + Stage<E>::kDt + k * Stage<E>::kRow + 16 * c,
                 reinterpret_cast<const char*>(cover_lo(b)) + 16 * c);
    }
  }
  const long long fo = (row0 + t0) * S;
  const int flen = n * S * static_cast<int>(sizeof(E));
  stage_range(st + Stage<E>::kB, reinterpret_cast<const char*>(B + fo), flen,
              tid, kThreads);
  stage_range(st + Stage<E>::kC, reinterpret_cast<const char*>(C + fo), flen,
              tid, kThreads);
}

// One staged chunk of n steps (t0 .. t0 + n - 1): each lane advances its
// kPer states, the kGroups lanes of a channel add their h.C, and each lane
// stores y of one step in kGroups.  kFull: n == kChunk and S == kMaxS,
// so neither the steps nor the states need a bound check.
template <typename E, bool kAligned, bool kFull>
__device__ __forceinline__ void scan_chunk(
    const char* st, const float* sB, const float* sC, float (&h)[kPer],
    const float (&a)[kPer], float dd, float* y, long long row0, int t0,
    int n, int Di, int d, int dl, int g, int s0, int nact, bool live,
    unsigned pitch16, unsigned u16, unsigned dt16) {
  if (kFull) n = kChunk;
  for (int k0 = 0; k0 < n; k0 += kGroups) {
    float ykeep = 0.0f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int k = k0 + q;
      if (kFull || k < n) {  // the same for the whole block
        unsigned mu = 0, mt = 0;
        if (!kAligned) {
          const unsigned rows = static_cast<unsigned>(t0 + k) * pitch16;
          mu = (u16 + rows) & 15u;
          mt = (dt16 + rows) & 15u;
        }
        const float ut = widen(reinterpret_cast<const E*>(
            st + Stage<E>::kU + k * Stage<E>::kRow + mu)[dl]);
        const float dt = widen(reinterpret_cast<const E*>(
            st + Stage<E>::kDt + k * Stage<E>::kRow + mt)[dl]);
        float bv[kPer], cv[kPer];
#pragma unroll
        for (int v = 0; v < kPer; v += 4) {
          const float4 bk =
              *reinterpret_cast<const float4*>(sB + k * kMaxS + s0 + v);
          const float4 ck =
              *reinterpret_cast<const float4*>(sC + k * kMaxS + s0 + v);
          bv[v] = bk.x, bv[v + 1] = bk.y, bv[v + 2] = bk.z, bv[v + 3] = bk.w;
          cv[v] = ck.x, cv[v + 1] = ck.y, cv[v + 2] = ck.z, cv[v + 3] = ck.w;
        }
        const float du = __fmul_rn(dt, ut);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (kFull || j < nact) {
            const float da = expf(__fmul_rn(dt, a[j]));
            h[j] = fmaf(da, h[j], __fmul_rn(du, bv[j]));
            acc = fmaf(h[j], cv[j], acc);
          }
        }
        // the lanes of a channel: (p0 + p1) + (p2 + p3) on every lane
#pragma unroll
        for (int m = 1; m < kGroups; m <<= 1) {
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
        }
        if (q == g) ykeep = fmaf(dd, ut, acc);
      }
    }
    const int k = k0 + g;
    if (live && (kFull || k < n)) y[(row0 + t0 + k) * Di + d] = ykeep;
  }
}

template <typename E, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_kernel(const E* __restrict__ u,
                          const E* __restrict__ delta,
                          const float* __restrict__ A,
                          const E* __restrict__ B, const E* __restrict__ C,
                          const float* __restrict__ D, float* __restrict__ y,
                          float* __restrict__ h_last, int L, int Di, int S) {
  extern __shared__ __align__(16) char smem[];
  float* sB = reinterpret_cast<float*>(smem + 2 * Stage<E>::kBytes);
  float* sC = sB + kChunk * kMaxS;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kTileD;
  const int nd = min(kTileD, Di - d0);
  const int g = threadIdx.x & (kGroups - 1);       // state group
  const int dl = threadIdx.x / kGroups;            // channel in the tile
  const int d = d0 + dl;
  const bool live = dl < nd;
  const int s0 = g * kPer;
  const int nact = max(0, min(kPer, S - s0));      // states of this lane
  const long long row0 = static_cast<long long>(b) * L;

  float a[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[j] = (live && j < nact) ? A[static_cast<long long>(d) * S + s0 + j]
                              : 0.0f;
    h[j] = 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;

  // low 4 bits of the rows' addresses (the unaligned case only)
  const unsigned pitch16 = (static_cast<unsigned>(Di) * sizeof(E)) & 15u;
  const unsigned u16 = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(u + row0 * Di + d0));
  const unsigned dt16 = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(delta + row0 * Di + d0));

  const int chunks = (L + kChunk - 1) / kChunk;
  stage_chunk<E>(smem, u, delta, B, C, row0, 0, min(kChunk, L), Di, d0, nd,
                 S);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, L - t0);
    // this chunk has landed, and every thread is done with the last one
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < chunks) {
      stage_chunk<E>(smem + ((c + 1) & 1) * Stage<E>::kBytes, u, delta, B, C,
                     row0, t0 + kChunk, min(kChunk, L - t0 - kChunk), Di, d0,
                     nd, S);
    }
    cp_async_commit();
    const char* st = smem + (c & 1) * Stage<E>::kBytes;
    {  // widen B and C of this chunk into float32 rows of stride kMaxS
      const long long fo = (row0 + t0) * S;
      const int mb = static_cast<int>(
          reinterpret_cast<uintptr_t>(B + fo) & 15);
      const int mc = static_cast<int>(
          reinterpret_cast<uintptr_t>(C + fo) & 15);
      const E* rb = reinterpret_cast<const E*>(st + Stage<E>::kB + mb);
      const E* rc = reinterpret_cast<const E*>(st + Stage<E>::kC + mc);
      for (int i = threadIdx.x; i < n * S; i += kThreads) {
        const int k = i / S;
        const int s = i - k * S;
        sB[k * kMaxS + s] = widen(rb[i]);
        sC[k * kMaxS + s] = widen(rc[i]);
      }
    }
    __syncthreads();
    if (n == kChunk && S == kMaxS) {
      scan_chunk<E, kAligned, true>(st, sB, sC, h, a, dd, y, row0, t0, n, Di,
                                    d, dl, g, s0, nact, live, pitch16, u16,
                                    dt16);
    } else {
      scan_chunk<E, kAligned, false>(st, sB, sC, h, a, dd, y, row0, t0, n,
                                     Di, d, dl, g, s0, nact, live, pitch16,
                                     u16, dt16);
    }
  }
  if (live) {
    float* out = h_last + (static_cast<long long>(b) * Di + d) * S + s0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < nact) out[j] = h[j];
    }
  }
}

// dtype codes across the ABI: 0 float32, 1 bfloat16, 2 float16
template <typename E, bool kAligned>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&selective_scan_kernel<E, kAligned>);
}

const void* pick(int dtype, bool aligned, int* bytes) {
  switch (dtype) {
    case 0:
      *bytes = smem_bytes<float>();
      return aligned ? kernel_of<float, true>() : kernel_of<float, false>();
    case 1:
      *bytes = smem_bytes<__nv_bfloat16>();
      return aligned ? kernel_of<__nv_bfloat16, true>()
                     : kernel_of<__nv_bfloat16, false>();
    case 2:
      *bytes = smem_bytes<__half>();
      return aligned ? kernel_of<__half, true>()
                     : kernel_of<__half, false>();
    default:
      return nullptr;
  }
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

template <typename E>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   void* h_last, int Bt, int L, int Di, int S, bool aligned,
                   cudaStream_t stream) {
  const dim3 grid((Di + kTileD - 1) / kTileD, Bt);
  const int bytes = smem_bytes<E>();
  const E* uu = static_cast<const E*>(u);
  const E* dt = static_cast<const E*>(delta);
  const E* bb = static_cast<const E*>(B);
  const E* cc = static_cast<const E*>(C);
  const float* aa = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(D);
  float* yy = static_cast<float*>(y);
  float* hh = static_cast<float*>(h_last);
  if (aligned) {
    selective_scan_kernel<E, true><<<grid, kThreads, bytes, stream>>>(
        uu, dt, aa, bb, cc, dd, yy, hh, L, Di, S);
  } else {
    selective_scan_kernel<E, false><<<grid, kThreads, bytes, stream>>>(
        uu, dt, aa, bb, cc, dd, yy, hh, L, Di, S);
  }
  return cudaGetLastError();
}

}  // namespace

// What one instantiation uses: registers per thread, static and dynamic
// shared memory per block, threads per block and resident blocks per SM
// (ptxas -v reports the registers but not the dynamic shared memory a
// launch sets, nor the residency that follows from both).
extern "C" int selective_scan_attributes(int dtype, int aligned,
                                         int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int bytes = 0;
  const void* fn = pick(dtype, aligned != 0, &bytes);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = bytes;
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

extern "C" int selective_scan_launch(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* D, void* y,
                                     void* h_last, int Bt, int L, int Di,
                                     int S, int dtype, int device,
                                     void* stream) {
  if (Bt < 1 || Bt > 65535 || L < 1 || Di < 1 || S < 1 || S > kMaxS ||
      dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(u) |
                         reinterpret_cast<uintptr_t>(delta);
  const bool aligned =
      (ptrs & 15) == 0 &&
      (static_cast<long long>(Di) * elem_size(dtype)) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      e = launch<float>(u, delta, A, B, C, D, y, h_last, Bt, L, Di, S,
                        aligned, s);
      break;
    case 1:
      e = launch<__nv_bfloat16>(u, delta, A, B, C, D, y, h_last, Bt, L, Di,
                                S, aligned, s);
      break;
    default:
      e = launch<__half>(u, delta, A, B, C, D, y, h_last, Bt, L, Di, S,
                         aligned, s);
      break;
  }
  return static_cast<int>(e);
}
