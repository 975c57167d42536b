// ebf_shadow: number of nodes that fit EASY backfilling's blocked head
// after each prefix of the running jobs' estimated releases.
//
// Replaces the TPU kernel of src/repro/kernels/ebf_shadow.py:
//   ebf_shadow_pallas (body _ebf_shadow_kernel).
//
//   cum[m, n, r] = avail[n, r] + sum_{k<=m} deltas[k, n, r]
//   fits[m]      = #{ n : AND_r cum[m, n, r] >= req[r] }     (exact int32)
//
// The TPU kernel materialized cum[M, R, BN] in VMEM per node block and
// summed per-block counts [M, nb] afterwards.  Here one thread owns one
// node and walks m = 0..M-1 with its running cum[r] in registers (R is
// capped at compile time, kMaxR; the wrapper refuses more).  Per release
// prefix a warp counts its fitting nodes with one ballot + popcount and
// lane 0 adds the count into fits[m] with an integer atomicAdd, so the
// result is exact whatever order the blocks run in.  The launcher zeroes
// fits on the stream first.
//
// Bound on the card: bytes.  The deltas tensor is read once, M*N*R*4
// bytes (about 8 MB at M = 1000, N = 1024, R = 2: ~2.5 us at 3.35 TB/s).
// At those sizes the kernel is bound by its M-long dependent walk over
// few blocks, and the path around it by the host building deltas and
// copying them to the card; loads for later m do not depend on cum, so
// the unrolled walk keeps several in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // a multiple of the warp: every lane votes
constexpr int kMaxR = 8;

__global__ void ebf_shadow_kernel(const int* __restrict__ avail,
                                  const int* __restrict__ deltas,
                                  const int* __restrict__ req,
                                  int* __restrict__ fits, int M, int N,
                                  int R) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  int cum[kMaxR];
  int q[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    cum[r] = (live && r < R) ? avail[static_cast<long long>(n) * R + r] : 0;
    q[r] = (r < R) ? req[r] : 0;
  }
  const long long plane = static_cast<long long>(N) * R;
  const int* d = deltas + static_cast<long long>(live ? n : 0) * R;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    int ok = live ? 1 : 0;
    if (live) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          cum[r] += d[m * plane + r];
          ok &= (cum[r] >= q[r]);
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0 && ballot != 0u) {
      atomicAdd(fits + m, __popc(ballot));
    }
  }
}

}  // namespace

extern "C" int ebf_shadow_launch(const void* avail, const void* deltas,
                                 const void* req, void* fits, int M, int N,
                                 int R, int device, void* stream) {
  if (R < 1 || R > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(fits, 0, sizeof(int) * M, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ebf_shadow_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int*>(avail), static_cast<const int*>(deltas),
      static_cast<const int*>(req), static_cast<int*>(fits), M, N, R);
  return static_cast<int>(cudaGetLastError());
}
