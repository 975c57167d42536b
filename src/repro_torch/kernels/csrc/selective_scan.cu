// selective_scan: the Mamba-1 forward recurrence (diagonal SSM, ZOH).
//
// Replaces the TPU kernel of src/repro/kernels/selective_scan.py:
//   selective_scan_pallas (body _selective_scan_kernel).
//
//   h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t      [Di, S]
//   y_t = sum_s h_t[:, s] * C_t[s] + D * u_t                      [Di]
//
// with u, delta, y float32[Bt, L, Di], A float32[Di, S], B, C float32
// [Bt, L, S], D float32[Di] and h_last = h_{L-1} float32[Bt, Di, S].
//
// The TPU kernel carried h[block_d, S] in VMEM scratch across the
// sequential grid axis over chunks of L.  Blocks on Hopper run in no
// order, so the sequence axis becomes a loop inside the block: one
// thread owns one (b, d) and keeps its h[S] and A[d, S] in registers for
// the whole sequence (S is capped at compile time, kMaxS; the wrapper
// refuses more).  A block covers kThreads consecutive channels of one
// batch row, so the loads of u and delta and the store of y are
// coalesced along d; B_t and C_t, shared by the whole block, are staged
// in shared memory a chunk of kChunk steps at a time.  h_last is written
// once at the end.  Any L >= 1 and Di >= 1 are taken: the ragged channel
// tail is masked, and the last chunk is short.
//
// Bound on the card: the bytes of u, delta and y (12 bytes per (b, t, d)
// at 3.35 TB/s) and the Bt*L*Di*S exponentials at the SFU rate (16 per
// clock per SM) are about equal at S = 16.  This design reaches neither:
// Bt*Di/32 warps (1024 at Bt 4, Di 8192) leave each SM some 8 warps to
// hide an L-long dependent walk.  A chunked parallel scan, cp.async
// staging of u and delta, and bf16 inputs are later work.  expf (not
// __expf) and no --use_fast_math keep the result within 1e-4 of the
// plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxS = 16;
constexpr int kChunk = 64;

__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ D,
    float* __restrict__ y, float* __restrict__ h_last, int L, int Di,
    int S) {
  __shared__ float sB[kChunk * kMaxS];
  __shared__ float sC[kChunk * kMaxS];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Di;
  float a[kMaxS];
  float h[kMaxS];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    a[s] = (live && s < S) ? A[static_cast<long long>(d) * S + s] : 0.0f;
    h[s] = 0.0f;
  }
  const float dd = live ? D[d] : 0.0f;
  const long long row0 = static_cast<long long>(b) * L;  // row of (b, 0)

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int n = min(kChunk, L - t0);
    __syncthreads();  // every thread is done with the previous chunk
    const float* bsrc = B + (row0 + t0) * S;
    const float* csrc = C + (row0 + t0) * S;
    for (int i = threadIdx.x; i < n * S; i += kThreads) {
      sB[i] = bsrc[i];
      sC[i] = csrc[i];
    }
    __syncthreads();
    if (live) {
      const long long base = (row0 + t0) * Di + d;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const long long off = base + static_cast<long long>(k) * Di;
        const float ut = u[off];
        const float dt = delta[off];
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s < S) {
            const float da = expf(dt * a[s]);
            const float db = dt * sB[k * S + s];
            h[s] = da * h[s] + db * ut;
            acc += h[s] * sC[k * S + s];
          }
        }
        y[off] = acc + dd * ut;
      }
    }
  }
  if (live) {
    float* out = h_last + (static_cast<long long>(b) * Di + d) * S;
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) out[s] = h[s];
    }
  }
}

}  // namespace

extern "C" int selective_scan_launch(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* D, void* y,
                                     void* h_last, int Bt, int L, int Di,
                                     int S, int device, void* stream) {
  if (Bt < 1 || Bt > 65535 || L < 1 || Di < 1 || S < 1 || S > kMaxS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Di + kThreads - 1) / kThreads, Bt);
  selective_scan_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(h_last), L, Di, S);
  return static_cast<int>(cudaGetLastError());
}
