// The two sweeps of the 8-bit-digit LSD radix sort (core/radix.py):
//
// * radix_histogram: the 256-bucket histogram of every pruned digit of
//   1-2 msb-first uint32 key words, in one sweep -> (npass, 256) int32.
//   Replaces src/repro/kernels/radix_sort.py::radix_histogram
//   (`_hist_kernel`).
// * radix_rank: one pass's stable ranks
//   rank[i] = starts[d_i] + #{j < i : d_j == d_i} -> (T,) int32.
//   Replaces src/repro/kernels/radix_sort.py::radix_rank (`_rank_kernel`).
//
// The TPU kernels walk the table on a sequential grid and carry the
// histogram, or the per-digit running counts, from block to block in
// scratch memory.  Hopper runs blocks in parallel and in no order, so
// neither carries over block by block.
//
// Bounds on an H100 SXM (3.35 TB/s), at T = 816,197:
// * histogram: reads 4 bytes per word per element and writes npass x 1 KiB;
//   2 words: 6.5 MB, 1.95 us.  Memory bound: a few integer ops per digit.
// * rank: reads the 4-byte digit and writes the 4-byte rank (the 1 KiB of
//   starts aside): 6.5 MB, 1.95 us.  Memory bound.
//
// Design.
// * histogram: each block builds the npass x 256 histogram of its tile in
//   shared memory with shared atomics, then adds each non-zero bucket into
//   the zeroed output with one global atomicAdd.  The ragged tail is
//   masked.  Counts are order-free, so the atomics' order does not matter.
// * rank: stability is the trap, since shared atomics hand out ranks in no
//   order.  Three launches: (1) per-tile digit counts; (2) for each digit,
//   an exclusive scan of its counts across tiles, plus starts[d]; (3) each
//   tile ranks its elements with its 8 warps in order.  A warp first counts
//   its own contiguous sub-range; a per-digit scan over the warps gives
//   each warp its starting rank; then the warp walks its sub-range 32
//   elements at a time, in order, and gets each element's place among the
//   earlier equal digits of those 32 from __match_any_sync and __popc of
//   the lower lanes, while a per-warp running count in shared memory
//   carries from one 32 to the next.  The digits are read three times
//   (about 16 bytes per element against the bound's 8); a one-sweep kernel
//   with decoupled look-back would read them once.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int BUCKETS = 256;
constexpr int MAX_PASS = 8;  // 64 live bits / 8-bit digits

struct Plan {
  int npass;
  int shift[MAX_PASS];
  int width[MAX_PASS];
};

// histogram sweep
constexpr int H_TPB = 256;
constexpr int H_IPT = 16;
constexpr int H_TILE = H_TPB * H_IPT;

// rank sweeps
constexpr int R_TPB = BUCKETS;            // one thread per digit in step 2
constexpr int R_WARPS = R_TPB / 32;
constexpr int R_CHUNKS = 8;               // 32-element chunks per warp
constexpr int R_WARP_ITEMS = 32 * R_CHUNKS;
constexpr int R_TILE = R_WARPS * R_WARP_ITEMS;

}  // namespace

// Bits [shift, shift+width) of the conceptual key (hi << 32) | lo: the
// bit-field rule of core.radix.extract_digit.
__device__ __forceinline__ int digit_of(uint64_t key, int shift, int width) {
  return (int)((key >> shift) & ((1ull << width) - 1ull));
}

__global__ void __launch_bounds__(H_TPB)
radix_hist_kernel(const uint32_t* __restrict__ hi,
                  const uint32_t* __restrict__ lo, Plan plan,
                  int* __restrict__ out, int n) {
  __shared__ int h[MAX_PASS * BUCKETS];
  const int cells = plan.npass * BUCKETS;
  for (int j = threadIdx.x; j < cells; j += H_TPB) h[j] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * H_TILE;
  for (int k = 0; k < H_IPT; ++k) {
    const long long i = base + k * H_TPB + threadIdx.x;
    if (i >= n) break;
    uint64_t key = lo[i];
    if (hi != nullptr) key |= (uint64_t)hi[i] << 32;
    for (int p = 0; p < plan.npass; ++p)
      atomicAdd(&h[p * BUCKETS + digit_of(key, plan.shift[p],
                                          plan.width[p])], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += H_TPB)
    if (h[j] != 0) atomicAdd(&out[j], h[j]);
}

// rank (1): counts[tile][d] of each tile's digits
__global__ void __launch_bounds__(R_TPB)
radix_rank_count(const int* __restrict__ dig, int* __restrict__ counts,
                 int n) {
  __shared__ int h[BUCKETS];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * R_TILE;
  for (int k = 0; k < R_TILE / R_TPB; ++k) {
    const long long i = base + k * R_TPB + threadIdx.x;
    if (i < n) atomicAdd(&h[dig[i] & (BUCKETS - 1)], 1);
  }
  __syncthreads();
  counts[(long long)blockIdx.x * BUCKETS + threadIdx.x] = h[threadIdx.x];
}

// rank (2): block d turns counts[:, d] into starts[d] + exclusive prefix
__global__ void __launch_bounds__(R_TPB)
radix_rank_scan(int* __restrict__ counts, const int* __restrict__ starts,
                int ntiles) {
  const int d = blockIdx.x;
  int carry = starts[d];
  for (int base = 0; base < ntiles; base += R_TPB) {
    const int j = base + threadIdx.x;
    const long long at = (long long)j * BUCKETS + d;
    const int v = j < ntiles ? counts[at] : 0;
    int total;
    const int ex = block_exclusive_scan<int, R_TPB>(v, &total);
    if (j < ntiles) counts[at] = carry + ex;
    carry += total;
  }
}

// rank (3): stable ranks inside each tile, warps in order
__global__ void __launch_bounds__(R_TPB)
radix_rank_tile(const int* __restrict__ dig, const int* __restrict__ offs,
                int* __restrict__ out, int n) {
  __shared__ int wh[R_WARPS][BUCKETS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int w = 0; w < R_WARPS; ++w) wh[w][threadIdx.x] = 0;
  __syncthreads();
  const long long wbase =
      (long long)blockIdx.x * R_TILE + (long long)warp * R_WARP_ITEMS;
  for (int c = 0; c < R_CHUNKS; ++c) {
    const long long i = wbase + c * 32 + lane;
    if (i < n) atomicAdd(&wh[warp][dig[i] & (BUCKETS - 1)], 1);
  }
  __syncthreads();
  {
    // thread d: each warp's first rank for digit d
    const int d = threadIdx.x;
    int run = offs[(long long)blockIdx.x * BUCKETS + d];
    for (int w = 0; w < R_WARPS; ++w) {
      const int c = wh[w][d];
      wh[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (int c = 0; c < R_CHUNKS; ++c) {
    const long long i = wbase + c * 32 + lane;
    const bool valid = i < n;
    // masked lanes share a digit that no element has
    const int d = valid ? (dig[i] & (BUCKETS - 1)) : BUCKETS;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const int below = __popc(peers & lower);
    const int first_rank = valid ? wh[warp][d] : 0;
    __syncwarp();
    if (valid) {
      out[i] = first_rank + below;
      if (below == 0) wh[warp][d] = first_rank + __popc(peers);
    }
    __syncwarp();
  }
}

extern "C" {

// words: hi (nullptr for one word) and lo, (n,) uint32 each; shifts and
// widths: npass <= 8 host ints; out: (npass, 256) int32, zeroed by the
// caller.  Returns cudaGetLastError().
int radix_histogram_launch(const void* hi, const void* lo, const int* shifts,
                           const int* widths, int npass, void* out, int n,
                           void* stream) {
  if (npass < 0 || npass > MAX_PASS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || npass == 0) return (int)cudaSuccess;
  Plan plan{};
  plan.npass = npass;
  for (int p = 0; p < npass; ++p) {
    if (shifts[p] < 0 || widths[p] < 1 || widths[p] > 8 ||
        shifts[p] + widths[p] > 64)
      return (int)cudaErrorInvalidValue;
    plan.shift[p] = shifts[p];
    plan.width[p] = widths[p];
  }
  const int nblocks = (n + H_TILE - 1) / H_TILE;
  radix_hist_kernel<<<nblocks, H_TPB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)hi, (const uint32_t*)lo, plan, (int*)out, n);
  return (int)cudaGetLastError();
}

// int32 words of scratch radix_rank_launch needs for `n` digits.
int radix_rank_scratch_ints(int n) {
  return ((n + R_TILE - 1) / R_TILE) * BUCKETS;
}

// digits: (n,) int32 in [0, 256); starts: (256,) int32; out: (n,) int32;
// scratch: radix_rank_scratch_ints(n) int32 words.  Returns
// cudaGetLastError() (0 when every launch was taken).
int radix_rank_launch(const void* digits, const void* starts, void* out,
                      void* scratch, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (n + R_TILE - 1) / R_TILE;
  const int* dig = (const int*)digits;
  int* counts = (int*)scratch;
  radix_rank_count<<<ntiles, R_TPB, 0, s>>>(dig, counts, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_rank_scan<<<BUCKETS, R_TPB, 0, s>>>(counts, (const int*)starts,
                                            ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_rank_tile<<<ntiles, R_TPB, 0, s>>>(dig, counts, (int*)out, n);
  return (int)cudaGetLastError();
}

const char* radix_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
