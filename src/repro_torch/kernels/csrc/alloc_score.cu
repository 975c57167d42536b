// alloc_score_batch: fit mask + Best-Fit load score of the whole queue
// against every node, in one launch per dispatch event.  Launched with
// J = 1 it is also the per-job alloc_score.
//
// Replaces the TPU kernels of src/repro/kernels/alloc_score.py:
//   alloc_score_batch_pallas (body _alloc_score_batch_kernel) and
//   alloc_score_pallas       (body _alloc_score_kernel).
//
//   fit[j, n]   = AND_r (avail[n, r] >= req[j, r])        (signed int32)
//   score[j, n] = sum_{r=0..R-1} (cap - avail) / max(cap, 1)   (float32)
//
// The score must be bitwise equal to the host's numpy float32 reconcile
// (BatchProbe.find): one ulp reorders Best-Fit ties and changes the
// trace.  So: subtract as ints, convert with round-to-nearest, divide
// correctly rounded (__fdiv_rn; the build never uses --use_fast_math),
// add in r order with __fadd_rn.  Nodes that are down or quarantined
// carry avail = -1 and never fit, even where a request column is 0,
// because the compare is signed.
//
// Bound on the card: bytes.  Each (j, n) does R compares and writes
// 8 bytes; at J = 4096, N = 1024 that is 32 MB of output, ~10 us at
// 3.35 TB/s, below the cost of the launch and of the D2H copy that
// follows it.  Design: one thread per (j, n) over a 2-D grid (x: node
// tiles, y: queue rows; a thread takes rows j + gridDim.y as well only
// when J exceeds the grid's y limit).  The thread computes its node's
// score once and reuses it for every row it covers; consecutive threads
// write consecutive nodes, so stores are coalesced.  The [N, R]
// row-major layout is read as it is: the TPU kernel's transpose to
// [R, N] and its -1/ones padding existed only for VMEM lanes, and bounds
// checks mask the ragged edge here.  The launcher selects the tensors'
// device first: this library links its own CUDA runtime.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void alloc_score_batch_kernel(const int* __restrict__ req,
                                         const int* __restrict__ avail,
                                         const int* __restrict__ cap,
                                         int* __restrict__ fit,
                                         float* __restrict__ score,
                                         int J, int N, int R) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int* a = avail + static_cast<long long>(n) * R;
  const int* c = cap + static_cast<long long>(n) * R;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) {
    const int cr = c[r];
    const float u = __fdiv_rn(__int2float_rn(cr - a[r]),
                              __int2float_rn(max(cr, 1)));
    s = (r == 0) ? u : __fadd_rn(s, u);
  }
  for (long long j = blockIdx.y; j < J; j += gridDim.y) {
    const int* q = req + j * R;
    int ok = 1;
    for (int r = 0; r < R; ++r) ok &= (a[r] >= q[r]);
    const long long o = j * N + n;
    fit[o] = ok;
    score[o] = s;
  }
}

}  // namespace

extern "C" int alloc_score_batch_launch(const void* req, const void* avail,
                                        const void* cap, void* fit,
                                        void* score, int J, int N, int R,
                                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kThreads - 1) / kThreads, J < kMaxGridY ? J : kMaxGridY);
  alloc_score_batch_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(req), static_cast<const int*>(avail),
      static_cast<const int*>(cap), static_cast<int*>(fit),
      static_cast<float*>(score), J, N, R);
  return static_cast<int>(cudaGetLastError());
}
