// alloc_fit.cuh: the per-node device code of the allocators, shared by
// alloc_score.cu (the batched probe of the vectorized dispatchers) and
// fleet_engine.cu (its prefilter and every allocator probe of the device
// event loop), so both decide fits and Best-Fit loads with the same
// arithmetic.
//
//   fits  = AND_r (a[r] >= q[r])                       (signed int32)
//   load  = sum_{r=0..R-1} (cap - a) / max(cap, 1)     (float32, r order)
//
// The load must be bitwise equal to the host's numpy float32 reconcile:
// subtract as ints, convert with round-to-nearest, divide correctly
// rounded (__fdiv_rn; the build never uses --use_fast_math), add in r
// order with __fadd_rn.  Nodes that are down or quarantined carry
// a = -1 and never fit, even where a request column is 0, because the
// compare is signed.
#pragma once

#include <cuda_runtime.h>

namespace alloc_fit {

// 1 iff availability a[0..R) hosts one rank of request q (R fixed).
template <int R>
__device__ __forceinline__ int fits(const int (&a)[R], const int* q) {
  int ok = 1;
#pragma unroll
  for (int r = 0; r < R; ++r) ok &= (a[r] >= q[r]);
  return ok;
}

// The same with R known only at run time.
__device__ __forceinline__ int fits(const int* a, const int* q, int R) {
  int ok = 1;
  for (int r = 0; r < R; ++r) ok &= (a[r] >= q[r]);
  return ok;
}

// One resource type's share in use.
__device__ __forceinline__ float used_share(int cap, int a) {
  return __fdiv_rn(__int2float_rn(cap - a), __int2float_rn(max(cap, 1)));
}

// Best-Fit load of one node: the shares summed in r order.
__device__ __forceinline__ float load(const int* cap, const int* a, int R) {
  float s = used_share(cap[0], a[0]);
  for (int r = 1; r < R; ++r) s = __fadd_rn(s, used_share(cap[r], a[r]));
  return s;
}

}  // namespace alloc_fit
