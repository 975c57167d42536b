// ebf_shadow: number of nodes that fit EASY backfilling's blocked head
// after each prefix of the running jobs' estimated releases.
//
// Replaces the TPU kernel of src/repro/kernels/ebf_shadow.py:
//   ebf_shadow_pallas (body _ebf_shadow_kernel).
//
//   cum[m, n, r] = avail[n, r] + sum_{k<=m} deltas[k, n, r]
//   fits[m]      = #{ n : AND_r cum[m, n, r] >= req[r] }     (exact int32)
//
// The TPU kernel read a dense deltas[M, N, R] and materialized
// cum[M, R, BN] in VMEM per node block.  Almost all of deltas is zero: a
// release group touches only the nodes of the jobs that end then.  Here
// the releases arrive sparse, grouped by node (CSR): node n's entries are
// node_ptr[n] .. node_ptr[n+1]-1, each a group index entry_m[e] (not
// decreasing within a node) and a vector entry_vec[e, :R].
//
// One block of up to 1024 threads; each thread owns nodes n = tid,
// tid + blockDim, ...  It tests the fit of avail[n] (its share of
// base = #{n : avail[n] >= req}), walks only its node's entries, applies
// every entry of one group before it tests the fit again (the
// tie-grouping of the host scan), and on each change of fit adds +1 or -1
// to diff[m].  A block-wide scan then writes fits[m] = base + sum_{k<=m}
// diff[k].  This is exact for deltas of any sign, as the dense walk was,
// and the work falls from M*N*R dependent steps to N + nnz + M.  diff
// lives in shared memory up to kSharedM groups; above that the kernel
// uses fits itself as diff (zeroed, then scanned in place), in the same
// launch.  Integer atomics make the counts independent of thread order.
//
// The kernel trusts no index it reads: a node whose pointers leave
// [0, nnz] or run backwards, an entry whose group lies outside [0, M) or
// below the one before it in its node, or node_ptr[0] != 0 or
// node_ptr[N] != nnz, is skipped and marks the input malformed, and then
// every fits[m] is -1 (a count is never negative).
//
// Bound on the card: bytes, each input word read once and each fits word
// written once (N*R + R + N + 1 + nnz*(1+R) + M words), well under a
// microsecond at the RICC peak; the launch is the floor.  A node's
// running sums cum[0, R) sit in registers up to kMaxR types; past that
// (kWide) they sit in its row of work[N, R], a scratch the wrapper
// allocates, and the request is read from memory: the same counts, in
// the same launch shape.  The launcher selects the tensors' device
// first: this library links its own CUDA runtime.
#include <cuda_runtime.h>

#include "alloc_fit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;
constexpr int kSharedM = 4096;            // diff[] in shared memory up to M

__device__ __forceinline__ int fit_of(const int* cum, const int* q, int R) {
  int ok = 1;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < R) ok &= (cum[r] >= q[r]);
  return ok;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
ebf_shadow_kernel(const int* __restrict__ avail, const int* __restrict__ req,
                  const int* __restrict__ node_ptr,
                  const int* __restrict__ entry_m,
                  const int* __restrict__ entry_vec, int* fits,
                  int* __restrict__ work, int M, int N, int R, int nnz) {
  __shared__ int s_diff[kSharedM];
  __shared__ int s_warp[kWarps];
  __shared__ int s_base;
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* diff = (M <= kSharedM) ? s_diff : fits;
  for (int m = tid; m < M; m += kThreads) diff[m] = 0;
  if (tid == 0) {
    s_base = 0;
    s_bad = node_ptr[0] != 0 || node_ptr[N] != nnz;
  }
  int q[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) q[r] = (r < R) ? req[r] : 0;
  __syncthreads();

  int base = 0;
  int bad = 0;
  for (int n = tid; n < N; n += kThreads) {
    int cum[kMaxR];
    int* wc = nullptr;                    // kWide: node n's running sums
    int ok;
    if constexpr (kWide) {
      wc = work + static_cast<long long>(n) * R;
      for (int r = 0; r < R; ++r)
        wc[r] = avail[static_cast<long long>(n) * R + r];
      ok = alloc_fit::fits(wc, req, R);
    } else {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        cum[r] = (r < R) ? avail[static_cast<long long>(n) * R + r] : 0;
      ok = fit_of(cum, q, R);
    }
    base += ok;
    const int begin = node_ptr[n];
    const int end = node_ptr[n + 1];
    if (begin < 0 || begin > end || end > nnz) {
      bad = 1;
      continue;
    }
    int prev = 0;
    for (int e = begin; e < end; ++e) {
      const int m = entry_m[e];
      if (m < prev || m >= M) {
        bad = 1;
        break;
      }
      prev = m;
      const int* v = entry_vec + static_cast<long long>(e) * R;
      if constexpr (kWide) {
        for (int r = 0; r < R; ++r) wc[r] += v[r];
      } else {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) cum[r] += v[r];
      }
      if (e + 1 == end || entry_m[e + 1] != m) {   // last entry of group m
        int now;
        if constexpr (kWide)
          now = alloc_fit::fits(wc, req, R);
        else
          now = fit_of(cum, q, R);
        if (now != ok) {
          atomicAdd(diff + m, now - ok);
          ok = now;
        }
      }
    }
  }
  // base: warp sums, one shared atomic per warp
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    base += __shfl_down_sync(0xffffffffu, base, d);
  if (lane == 0 && base != 0) atomicAdd(&s_base, base);
  if (bad) s_bad = 1;
  __syncthreads();

  // inclusive scan of diff[0..M) into fits, one contiguous segment per
  // thread: segment sums, a block scan of those, then each thread rewrites
  // its own segment (in place when diff is fits)
  const int per = (M + kThreads - 1) / kThreads;
  const int lo = min(M, tid * per);
  const int hi = min(M, lo + per);
  int sum = 0;
  for (int m = lo; m < hi; ++m) sum += diff[m];
  const int incl = warp_inclusive_sum(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_inclusive_sum(s_warp[lane], lane);
  __syncthreads();
  int run = s_base + (warp > 0 ? s_warp[warp - 1] : 0) + incl - sum;
  const int bad_all = s_bad;
  for (int m = lo; m < hi; ++m) {
    run += diff[m];
    fits[m] = bad_all ? -1 : run;
  }
}

}  // namespace

// kSharedM, for the tests that drive the global-memory branch
extern "C" int ebf_shadow_shared_m() { return kSharedM; }

// work: int32[N * R] scratch when R > kMaxR (8; else unused, may be null)
extern "C" int ebf_shadow_launch(const void* avail, const void* req,
                                 const void* node_ptr, const void* entry_m,
                                 const void* entry_vec, void* fits,
                                 void* work, int M, int N, int R, int nnz,
                                 int device, void* stream) {
  if (R < 1 || M < 1 || N < 0 || nnz < 0 ||
      (R > kMaxR && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto kernel = R > kMaxR ? ebf_shadow_kernel<true>
                                : ebf_shadow_kernel<false>;
  kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(avail), static_cast<const int*>(req),
      static_cast<const int*>(node_ptr), static_cast<const int*>(entry_m),
      static_cast<const int*>(entry_vec), static_cast<int*>(fits),
      static_cast<int*>(work), M, N, R, nnz);
  return static_cast<int>(cudaGetLastError());
}
