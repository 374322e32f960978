// Block-wide exclusive scan shared by the port's kernels.
//
// A warp scans with shuffles, warp 0 scans the warp totals, and every
// thread adds the totals of the warps before its own.  `T` needs `+`,
// value-initialisation to zero (`T{}`) and a `shfl_up` specialisation.
#pragma once

#include <cstdint>

constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T shfl_up(T v, unsigned delta);

template <>
__device__ __forceinline__ int shfl_up<int>(int v, unsigned delta) {
  return __shfl_up_sync(FULL_MASK, v, delta);
}

// Exclusive prefix of `v` over the block's threads in thread order; the
// block's total goes to `*total`.  Every thread of the block must call it
// (it synchronises the block, also on the way out so that the shared
// buffer can be reused by the next call).
template <typename T, int TPB>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  static_assert(TPB % 32 == 0 && TPB <= 1024, "TPB must be whole warps");
  constexpr int WARPS = TPB / 32;
  __shared__ T warp_tot[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T up = shfl_up(inc, o);
    if (lane >= o) inc = inc + up;
  }
  T ex = shfl_up(inc, 1);
  if (lane == 0) ex = T{};
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? warp_tot[lane] : T{};
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      T up = shfl_up(w, o);
      if (lane >= o) w = w + up;
    }
    if (lane < WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  T before = warp ? warp_tot[warp - 1] : T{};
  *total = warp_tot[WARPS - 1];
  __syncthreads();
  return before + ex;
}
