// Fused masked prefix sums of Stage 2 (the segment reductions of both
// component operators):
//
//   out_lo[i]  = sum_{j<=i} first[j] ? w_lo[j] : 0      (mod 2^32)
//   out_hi[i]  = sum_{j<=i} first[j] ? w_hi[j] : 0      (mod 2^32)
//   out_cnt[i] = sum_{j<=i} first[j]
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py::segment_reduce
// (body `_kernel`), which walks the table on a sequential grid and carries
// the running totals from block to block in scratch memory.  Hopper runs
// blocks in parallel and in no order, so nothing can be carried that way.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads 9 bytes per element
// (two uint32 weights, one bool flag) and writes 12 (three 32-bit sums):
// 21 bytes x T.  At T = 816,197 that is 17.1 MB, 5.1 us.  It does a few
// integer adds per element, far below the card's ALU rate: memory bound.
//
// Design: three launches.  (1) each block sums its tile of 2048 elements
// per lane; (2) one block scans the block totals into exclusive block
// offsets; (3) each block scans its tile again, 256 elements at a time,
// and adds its offset.  The inputs are read twice (about 30 bytes per
// element against the bound's 21); a single-pass scan with decoupled
// look-back would read them once.  The sums are uint32_t, whose
// wraparound is the defined mod 2^32 arithmetic the signatures need; the
// count lane is int32_t.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int TPB = 256;            // threads per block
constexpr int IPT = 8;              // elements per thread per tile
constexpr int TILE = TPB * IPT;     // elements per block

struct Lanes {
  uint32_t lo;
  uint32_t hi;
  int32_t cnt;
};

__device__ __forceinline__ Lanes operator+(Lanes a, Lanes b) {
  return Lanes{a.lo + b.lo, a.hi + b.hi, a.cnt + b.cnt};
}

__device__ __forceinline__ Lanes load(const uint32_t* w_lo,
                                      const uint32_t* w_hi,
                                      const uint8_t* first, long long i,
                                      int n) {
  if (i < n && first[i]) return Lanes{w_lo[i], w_hi[i], 1};
  return Lanes{};
}

}  // namespace

template <>
__device__ __forceinline__ Lanes shfl_up<Lanes>(Lanes v, unsigned delta) {
  return Lanes{__shfl_up_sync(FULL_MASK, v.lo, delta),
               __shfl_up_sync(FULL_MASK, v.hi, delta),
               __shfl_up_sync(FULL_MASK, v.cnt, delta)};
}

// (1) per-block totals of the masked lanes
__global__ void __launch_bounds__(TPB)
sr_block_totals(const uint32_t* __restrict__ w_lo,
                const uint32_t* __restrict__ w_hi,
                const uint8_t* __restrict__ first, Lanes* __restrict__ tot,
                int n) {
  const long long base = (long long)blockIdx.x * TILE;
  Lanes s{};
#pragma unroll
  for (int k = 0; k < IPT; ++k)
    s = s + load(w_lo, w_hi, first, base + k * TPB + threadIdx.x, n);
  Lanes total;
  block_exclusive_scan<Lanes, TPB>(s, &total);
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

// (2) exclusive scan of the block totals, in place, by one block
__global__ void __launch_bounds__(TPB)
sr_scan_totals(Lanes* __restrict__ tot, int nblocks) {
  Lanes carry{};
  for (int base = 0; base < nblocks; base += TPB) {
    const int i = base + threadIdx.x;
    Lanes v = i < nblocks ? tot[i] : Lanes{};
    Lanes total;
    Lanes ex = block_exclusive_scan<Lanes, TPB>(v, &total);
    if (i < nblocks) tot[i] = carry + ex;
    carry = carry + total;
  }
}

// (3) inclusive scan of each tile plus its block offset
__global__ void __launch_bounds__(TPB)
sr_scan_tiles(const uint32_t* __restrict__ w_lo,
              const uint32_t* __restrict__ w_hi,
              const uint8_t* __restrict__ first,
              const Lanes* __restrict__ offs, uint32_t* __restrict__ out_lo,
              uint32_t* __restrict__ out_hi, int32_t* __restrict__ out_cnt,
              int n) {
  const long long base = (long long)blockIdx.x * TILE;
  Lanes carry = offs[blockIdx.x];
  for (int k = 0; k < IPT; ++k) {
    const long long i = base + k * TPB + threadIdx.x;
    Lanes v = load(w_lo, w_hi, first, i, n);
    Lanes total;
    Lanes ex = block_exclusive_scan<Lanes, TPB>(v, &total);
    if (i < n) {
      Lanes inc = carry + ex + v;
      out_lo[i] = inc.lo;
      out_hi[i] = inc.hi;
      out_cnt[i] = inc.cnt;
    }
    carry = carry + total;
  }
}

extern "C" {

// int32 words of scratch the launch needs for `n` elements.
int segment_reduce_scratch_ints(int n) {
  const int nblocks = (n + TILE - 1) / TILE;
  return nblocks * (int)(sizeof(Lanes) / sizeof(int32_t));
}

// w_lo, w_hi: (n,) uint32; first: (n,) bool; outputs (n,) uint32, uint32,
// int32; scratch: segment_reduce_scratch_ints(n) int32 words.  Launches on
// `stream` and returns cudaGetLastError() (0 when every launch was taken).
int segment_reduce_launch(const void* w_lo, const void* w_hi,
                          const void* first, void* out_lo, void* out_hi,
                          void* out_cnt, void* scratch, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (n + TILE - 1) / TILE;
  Lanes* tot = (Lanes*)scratch;
  const uint32_t* lo = (const uint32_t*)w_lo;
  const uint32_t* hi = (const uint32_t*)w_hi;
  const uint8_t* f = (const uint8_t*)first;
  sr_block_totals<<<nblocks, TPB, 0, s>>>(lo, hi, f, tot, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sr_scan_totals<<<1, TPB, 0, s>>>(tot, nblocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sr_scan_tiles<<<nblocks, TPB, 0, s>>>(lo, hi, f, tot, (uint32_t*)out_lo,
                                        (uint32_t*)out_hi, (int32_t*)out_cnt,
                                        n);
  return (int)cudaGetLastError();
}

const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
