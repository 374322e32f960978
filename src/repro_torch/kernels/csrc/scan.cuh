// Warp and block scans shared by the port's kernels.
//
// `T` needs `+`, value-initialisation to zero (`T{}`) and `shfl_up` and
// `shfl_idx` specialisations (the int ones are here).
#pragma once

#include <cstdint>

constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T shfl_up(T v, unsigned delta);

template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src);

template <>
__device__ __forceinline__ int shfl_up<int>(int v, unsigned delta) {
  return __shfl_up_sync(FULL_MASK, v, delta);
}

template <>
__device__ __forceinline__ int shfl_idx<int>(int v, int src) {
  return __shfl_sync(FULL_MASK, v, src);
}

// Inclusive prefix of `v` over the warp's lanes, in lane order.
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T up = shfl_up(v, o);
    if (lane >= o) v = v + up;
  }
  return v;
}

// Exclusive prefix of the warps' values `v` (one value a warp, the same in
// each of its lanes) over the block's warps in warp order; the block's
// total goes to `*total`.  Every thread of the block must call it, once
// per block: it synchronises the block once, on the way in, and a second
// call would need a barrier before it, so that no warp overwrites a value
// that another still reads.
template <typename T, int TPB>
__device__ __forceinline__ T block_exclusive_scan_warps(T v, T* total) {
  static_assert(TPB % 32 == 0 && TPB <= 1024, "TPB must be whole warps");
  constexpr int WARPS = TPB / 32;
  __shared__ T warp_val[WARPS];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_val[warp] = v;
  __syncthreads();
  T before{}, all{};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const T x = warp_val[w];
    if (w < warp) before = before + x;
    all = all + x;
  }
  *total = all;
  return before;
}
