// alloc_score: packed fit bits of the whole queue against every node, and
// every node's Best-Fit load score, in one launch per dispatch event.
// Launched with J = 1 it is also the per-job alloc_score.
//
// Replaces the TPU kernels of src/repro/kernels/alloc_score.py:
//   alloc_score_batch_pallas (body _alloc_score_batch_kernel) and
//   alloc_score_pallas       (body _alloc_score_kernel).
//
//   fit[j, n]  = AND_r (avail[n, r] >= req[j, r])             (signed int32)
//   bits[j, w] = sum_k fit[j, 32 w + k] << k      (u32; tail bits past N = 0)
//   score[n]   = sum_{r=0..R-1} (cap - avail) / max(cap, 1)       (float32)
//
// The TPU kernels wrote fit and score as [J, N] int32/float32 tiles.  The
// score does not depend on j, and a fit is one bit, so here the output is
// J * ceil(N/32) words plus N floats: 0.63 MB instead of 40 MB at
// J 4893 x N 1024.  The score must be bitwise equal to the host's numpy
// float32 reconcile (BatchProbe.find): one ulp reorders Best-Fit ties and
// changes the trace.  The fit compare and the load arithmetic live in
// alloc_fit.cuh, shared with the fleet engine's prefilter and probes.
//
// Bound on the card: bytes (J*R + 2*N*R words in, J*W + N out), ~0.2 us at
// the RICC peak, far below the launch.  Design: a warp covers 32
// consecutive nodes, each lane holding its node's avail row in registers
// (R is a template parameter, 1..8, so the compares unroll; past 8 one
// generic instance reads the row and the request from memory,
// with the same bits and the same float32 sum in r order), and one
// __ballot_sync per request row yields the word; lanes past N vote 0 and
// stay in the loop, so every ballot is defined.  A block of kWarps warps
// covers kWarps words and walks chunks of 32 request rows staged in
// shared memory (all lanes read one row at a time: a broadcast); lane k
// keeps row k's word and every lane stores once per chunk, in place of a
// single-lane store per row, which left each warp's row walk bound by
// latency.  Blocks stride over the chunks (grid y capped), so any J runs.  The blocks of grid row 0 also write the score,
// once per node.  The launcher selects the tensors' device first: this
// library links its own CUDA runtime.
#include <cuda_runtime.h>

#include "alloc_fit.cuh"

namespace {

constexpr int kWarps = 8;                 // words (of 32 nodes) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                 // request rows per chunk: a word
constexpr int kMaxGridY = 65535;

template <int R>
__global__ void __launch_bounds__(kThreads)
alloc_score_kernel(const int* __restrict__ req, const int* __restrict__ avail,
                   const int* __restrict__ cap, unsigned* __restrict__ bits,
                   float* __restrict__ score, int J, int N) {
  __shared__ int s_req[kRows * R];
  const int W = (N + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = word * 32 + lane;
  const bool live = n < N;
  int a[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    a[r] = live ? avail[static_cast<long long>(n) * R + r] : 0;
  if (blockIdx.y == 0 && live) {
    const int* c = cap + static_cast<long long>(n) * R;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float u = alloc_fit::used_share(c[r], a[r]);
      s = (r == 0) ? u : __fadd_rn(s, u);
    }
    score[n] = s;
  }
  const int n_chunks = (J + kRows - 1) / kRows;
  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const long long j0 = static_cast<long long>(chunk) * kRows;
    const int rows = min(kRows, J - static_cast<int>(j0));
    __syncthreads();                      // the last chunk's rows are read
    for (int i = threadIdx.x; i < kRows * R; i += kThreads)
      s_req[i] = (i < rows * R) ? req[j0 * R + i] : 0;
    __syncthreads();
    unsigned mine = 0;                    // row j0 + lane's word
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const int ok = live ? alloc_fit::fits<R>(a, s_req + k * R) : 0;
      const unsigned b = __ballot_sync(0xffffffffu, ok);
      if (lane == k) mine = b;
    }
    if (word < W && lane < rows) bits[(j0 + lane) * W + word] = mine;
  }
}

// any R: the same words and score, the node's row and each request row
// read from global memory (the request rows are one broadcast per warp)
__global__ void __launch_bounds__(kThreads)
alloc_score_any_kernel(const int* __restrict__ req,
                       const int* __restrict__ avail,
                       const int* __restrict__ cap, unsigned* __restrict__ bits,
                       float* __restrict__ score, int J, int N, int R) {
  const int W = (N + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = word * 32 + lane;
  const bool live = n < N;
  const int* a = avail + static_cast<long long>(live ? n : 0) * R;
  if (blockIdx.y == 0 && live)
    score[n] = alloc_fit::load(cap + static_cast<long long>(n) * R, a, R);
  const int n_chunks = (J + kRows - 1) / kRows;
  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const long long j0 = static_cast<long long>(chunk) * kRows;
    const int rows = min(kRows, J - static_cast<int>(j0));
    unsigned mine = 0;                    // row j0 + lane's word
    for (int k = 0; k < kRows; ++k) {
      const int ok = live && k < rows
                         ? alloc_fit::fits(a, req + (j0 + k) * R, R) : 0;
      const unsigned b = __ballot_sync(0xffffffffu, ok);
      if (lane == k) mine = b;
    }
    if (word < W && lane < rows) bits[(j0 + lane) * W + word] = mine;
  }
}

template <int R>
void launch(const dim3& grid, cudaStream_t stream, const void* req,
            const void* avail, const void* cap, void* bits, void* score,
            int J, int N) {
  alloc_score_kernel<R><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(req), static_cast<const int*>(avail),
      static_cast<const int*>(cap), static_cast<unsigned*>(bits),
      static_cast<float*>(score), J, N);
}

}  // namespace

extern "C" int alloc_score_launch(const void* req, const void* avail,
                                  const void* cap, void* bits, void* score,
                                  int J, int N, int R, int device,
                                  void* stream) {
  if (R < 1 || N < 1 || J < 0 ||
      static_cast<long long>(N) * R > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int words = (N + 31) / 32;
  const int n_chunks = (J + kRows - 1) / kRows;
  const dim3 grid((words + kWarps - 1) / kWarps,
                  n_chunks < 1 ? 1 : (n_chunks < kMaxGridY ? n_chunks
                                                           : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: launch<1>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 2: launch<2>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 3: launch<3>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 4: launch<4>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 5: launch<5>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 6: launch<6>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 7: launch<7>(grid, s, req, avail, cap, bits, score, J, N); break;
    case 8: launch<8>(grid, s, req, avail, cap, bits, score, J, N); break;
    default:
      alloc_score_any_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const int*>(req), static_cast<const int*>(avail),
          static_cast<const int*>(cap), static_cast<unsigned*>(bits),
          static_cast<float*>(score), J, N, R);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
