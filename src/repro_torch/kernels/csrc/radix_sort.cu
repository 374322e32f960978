// The two sweeps of the 8-bit-digit LSD radix sort (core/radix.py):
//
// * radix_histogram: the 256-bucket histogram of every pruned digit of
//   1-2 msb-first uint32 key words, in one sweep -> (npass, 256) int32.
//   Replaces src/repro/kernels/radix_sort.py::radix_histogram
//   (`_hist_kernel`).
// * radix_rank: one pass's stable ranks
//   rank[i] = starts[d_i] + #{j < i : d_j == d_i} -> (T,) int32, and the
//   fused pass built on them, which takes the key words themselves, finds
//   each element's digit, and scatters the words and an int32 payload to
//   their ranks.  Replaces src/repro/kernels/radix_sort.py::radix_rank
//   (`_rank_kernel`).
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
//   starts aside): 6.5 MB, 1.95 us.  The fused pass reads the words and
//   the payload once and writes them once: 2 words, 24 bytes an element,
//   19.6 MB, 5.85 us.  Memory bound.
//
// Design.
// * histogram: each block builds the npass x 256 histogram of its tile in
//   shared memory with shared atomics, then adds each non-zero bucket into
//   the zeroed output with one global atomicAdd.  The ragged tail is
//   masked.  Counts are order-free, so the atomics' order does not matter.
//   It is Onesweep's upfront histogram: every pass's bucket starts from one
//   read of the keys.
// * rank: one sweep with decoupled look-back (Merrill and Garland's
//   single-pass prefix scan, as Onesweep ranks a radix pass), one launch
//   after one memset of the scratch.  Stability is the trap, since shared
//   atomics hand out ranks in no order, so ranks come from ordered warp
//   votes.  A block of 256 threads takes a tile of R_TILE elements; its 8
//   warps hold contiguous sub-ranges, 16 elements a lane in registers
//   (lane-strided, so loads coalesce).
//   1. Each warp walks its sub-range 32 elements at a time, in order: an
//      element's place among the earlier equal digits of those 32 is
//      __popc of the lower lanes among its peers (one ballot per digit
//      bit), and a per-warp running count per digit in shared memory
//      carries from one 32 to the next.
//      That gives every element its rank inside its warp, and the warps'
//      counts per digit.
//   2. Thread d sums digit d over the warps (each warp's start inside the
//      tile on the way), publishes the tile's count in the tile's status
//      word for d, (AGGREGATE, count), then looks back over the
//      predecessor tiles' words for d, LOOKBACK at a time: it adds
//      AGGREGATE counts, waits on NOT_READY, and stops at the first
//      INCLUSIVE.  It publishes (INCLUSIVE, prefix + count).  Tile 0
//      publishes INCLUSIVE at once.  Every thread publishes its digit,
//      also when the tile holds none of it (count 0), or a successor
//      would wait for ever.
//   3. rank = starts[d] + prefix + the warp's start + the element's rank
//      inside its warp.  The rank-only entry writes the ranks; the fused
//      entry scatters each element's words and payload to its rank (a
//      tile writes up to 256 runs, not coalesced further: a warp's store
//      touches up to 32 sectors, and these stores are most of a fused
//      pass's time; a shared-memory reorder of the tile before the write
//      would coalesce them).
//   Status words: flag (2 bits) and count (32 bits) in one 64-bit word,
//   written by one st.relaxed.gpu and read by ld.relaxed.gpu.  Aligned
//   64-bit accesses are single-copy atomic, so a reader sees a flag with
//   its own count, and the count is the only thing a tile learns from
//   another: there is no other data whose visibility a release/acquire
//   pair would have to order.  (On an H100, st.release.gpu for both
//   publishes and a fence.acq_rel.gpu after the look-back cost about a
//   quarter of the rank-only sweep: python -m
//   repro_torch.kernels.probe_radix_rank.)  Every count is below the
//   wrapper's limit of 2^31 - 2^16 elements.
//   Deadlock: blocks are scheduled in no order and a block may wait for a
//   predecessor, so the tile a block works on is NOT its blockIdx.x but the
//   next value of a global counter (atomicAdd) taken when it starts.  Tile
//   k is then only ever claimed after tiles 0..k-1 were claimed by blocks
//   that already run, so every tile it waits for makes progress.  With
//   blockIdx.x, a resident block could spin on a tile whose block cannot
//   be scheduled until the spinning one leaves.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
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

// rank sweep
constexpr int R_TPB = BUCKETS;            // thread d looks back for digit d
constexpr int R_WARPS = R_TPB / 32;
constexpr int R_ITEMS = 16;               // elements a lane holds
constexpr int R_WARP_ITEMS = 32 * R_ITEMS;
constexpr int R_TILE = R_WARPS * R_WARP_ITEMS;
constexpr int LOOKBACK = 4;               // predecessor words read at once

// status words: flag in bits 62-63, count in bits 0-31; 0 is NOT_READY
constexpr unsigned long long FLAG_MASK = 3ull << 62;
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;

// The fused pass's operands; all null (and shift, width unused) for the
// rank-only entry.
struct PassArgs {
  const uint32_t* hi;      // null for one key word
  const uint32_t* lo;
  int shift, width;
  const int* perm_in;      // null: the identity
  uint32_t* hi_out;
  uint32_t* lo_out;
  int* perm_out;
};

}  // namespace

// Bits [shift, shift+width) of the conceptual key (hi << 32) | lo: the
// bit-field rule of core.radix.extract_digit.
__device__ __forceinline__ int digit_of(uint64_t key, int shift, int width) {
  return (int)((key >> shift) & ((1ull << width) - 1ull));
}

// The lanes of the warp whose digit equals this lane's, among the valid
// ones: one ballot per digit bit (Onesweep's warp multi-split).
// __match_any_sync computes the same, but its throughput held a tile's 16
// rounds at several microseconds on an H100.
__device__ __forceinline__ unsigned peers_of(int digit, bool valid) {
  unsigned peers = __ballot_sync(FULL_MASK, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1;
    const unsigned set = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
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

// One sweep: FUSED = false reads digits and writes ranks; FUSED = true
// reads the key words (and payload), finds the digits, and scatters.
template <bool FUSED>
__global__ void __launch_bounds__(R_TPB)
radix_rank_onesweep(const int* __restrict__ dig, PassArgs pa,
                    const int* __restrict__ starts, int* __restrict__ out,
                    unsigned long long* __restrict__ status,
                    unsigned int* __restrict__ tile_counter, int n) {
  __shared__ int wh[R_WARPS][BUCKETS];
  __shared__ int tile_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(tile_counter, 1u);
  for (int w = 0; w < R_WARPS; ++w) wh[w][threadIdx.x] = 0;
  __syncthreads();
  const int tile = tile_s;
  const long long wbase =
      (long long)tile * R_TILE + (long long)warp * R_WARP_ITEMS;

  // the lane's elements, every load issued before any use; masked lanes
  // take a digit that no element has
  int d[R_ITEMS];
  uint32_t klo[R_ITEMS], khi[R_ITEMS];
  int pv[R_ITEMS];
#pragma unroll
  for (int c = 0; c < R_ITEMS; ++c) {
    const long long i = wbase + c * 32 + lane;
    d[c] = BUCKETS;
    klo[c] = khi[c] = 0u;
    pv[c] = 0;
    if (i < n) {
      if constexpr (FUSED) {
        klo[c] = pa.lo[i];
        if (pa.hi != nullptr) khi[c] = pa.hi[i];
        pv[c] = pa.perm_in != nullptr ? pa.perm_in[i] : (int)i;
      } else {
        d[c] = dig[i] & (BUCKETS - 1);
      }
    }
  }
  if constexpr (FUSED) {
#pragma unroll
    for (int c = 0; c < R_ITEMS; ++c)
      if (wbase + c * 32 + lane < n)
        d[c] = digit_of(((uint64_t)khi[c] << 32) | klo[c], pa.shift,
                        pa.width);
  }

  // 1. ranks inside the warp, 32 elements at a time in order
  const unsigned lower = (1u << lane) - 1u;
  int local[R_ITEMS];
#pragma unroll
  for (int c = 0; c < R_ITEMS; ++c) {
    const bool valid = d[c] < BUCKETS;
    const unsigned peers = peers_of(d[c], valid);
    const int below = __popc(peers & lower);
    const int run = valid ? wh[warp][d[c]] : 0;
    __syncwarp();
    local[c] = run + below;
    if (valid && below == 0) wh[warp][d[c]] = run + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. thread dg: the tile's count of digit dg, each warp's start inside
  // the tile, and the look-back for the count before the tile
  const int dg = threadIdx.x;
  int count = 0;
#pragma unroll
  for (int w = 0; w < R_WARPS; ++w) {
    const int c = wh[w][dg];
    wh[w][dg] = count;
    count += c;
  }
  unsigned long long* mine = status + (long long)tile * BUCKETS + dg;
  int prefix = 0;
  if (tile == 0) {
    store_relaxed(mine, INCLUSIVE | (unsigned)count);
  } else {
    store_relaxed(mine, AGGREGATE | (unsigned)count);
    int j = tile - 1;                  // the next predecessor to add
    bool done = false;
    while (!done) {
      unsigned long long s[LOOKBACK];
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q)
        s[q] = j - q >= 0
                   ? load_relaxed(status + (long long)(j - q) * BUCKETS + dg)
                   : INCLUSIVE;        // never reached: tile 0 is INCLUSIVE
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        const unsigned long long flag = s[q] & FLAG_MASK;
        if (flag == 0) break;          // NOT_READY: read again from j
        prefix += (int)(unsigned)s[q];
        --j;
        if (flag == INCLUSIVE) {
          done = true;
          break;
        }
      }
    }
    store_relaxed(mine, INCLUSIVE | (unsigned)(prefix + count));
  }
  const int base = starts[dg] + prefix;
#pragma unroll
  for (int w = 0; w < R_WARPS; ++w) wh[w][dg] += base;
  __syncthreads();

  // 3. ranks, written in place or used as scatter targets
#pragma unroll
  for (int c = 0; c < R_ITEMS; ++c) {
    const long long i = wbase + c * 32 + lane;
    if (i < n) {
      const int rank = wh[warp][d[c]] + local[c];
      if constexpr (FUSED) {
        pa.lo_out[rank] = klo[c];
        if (pa.hi_out != nullptr) pa.hi_out[rank] = khi[c];
        pa.perm_out[rank] = pv[c];
      } else {
        out[i] = rank;
      }
    }
  }
}

namespace {

int rank_tiles(int n) { return (n + R_TILE - 1) / R_TILE; }

// scratch: the tile counter (one 64-bit word), then 256 status words per
// tile, all zeroed on the stream, then the sweep.
template <bool FUSED>
cudaError_t launch_rank(const int* dig, const PassArgs& pa,
                        const int* starts, int* out, void* scratch, int n,
                        cudaStream_t s) {
  const int ntiles = rank_tiles(n);
  auto* words = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (1 + (size_t)ntiles * BUCKETS) * sizeof(*words), s);
  if (err != cudaSuccess) return err;
  radix_rank_onesweep<FUSED><<<ntiles, R_TPB, 0, s>>>(
      dig, pa, starts, out, words + 1, (unsigned int*)words, n);
  return cudaGetLastError();
}

}  // namespace

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

// The rank sweep's constants, in this order: elements of a tile, threads
// of a block, warps of a block, predecessor words read at once.
int radix_rank_config(long long* out) {
  out[0] = R_TILE;
  out[1] = R_TPB;
  out[2] = R_WARPS;
  out[3] = LOOKBACK;
  return (int)cudaSuccess;
}

// 64-bit words of scratch a rank sweep over `n` elements needs.
long long radix_rank_scratch_words(int n) {
  return 1 + (long long)rank_tiles(n) * BUCKETS;
}

// digits: (n,) int32 in [0, 256); starts: (256,) int32; out: (n,) int32;
// scratch: radix_rank_scratch_words(n) 64-bit words.  One memset and one
// launch; returns cudaGetLastError() (0 when both were taken).
int radix_rank_launch(const void* digits, const void* starts, void* out,
                      void* scratch, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return (int)launch_rank<false>((const int*)digits, PassArgs{},
                                 (const int*)starts, (int*)out, scratch, n,
                                 (cudaStream_t)stream);
}

// One fused LSD pass.  hi (nullptr for one word) and lo: (n,) uint32 key
// words in their current order; the digit is bits [shift, shift + width)
// of (hi << 32) | lo, width 1..8; perm_in: (n,) int32 payload (nullptr:
// the identity); starts: (256,) int32 bucket starts of that digit.
// Writes each element's words and payload at its stable rank into hi_out
// (nullptr iff hi is), lo_out and perm_out.  scratch as for
// radix_rank_launch.  Returns cudaGetLastError().
int radix_pass_launch(const void* hi, const void* lo, int shift, int width,
                      const void* perm_in, const void* starts, void* hi_out,
                      void* lo_out, void* perm_out, void* scratch, int n,
                      void* stream) {
  if ((hi == nullptr) != (hi_out == nullptr) || width < 1 || width > 8 ||
      shift < 0 || shift + width > (hi != nullptr ? 64 : 32))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  PassArgs pa{(const uint32_t*)hi, (const uint32_t*)lo, shift, width,
              (const int*)perm_in, (uint32_t*)hi_out, (uint32_t*)lo_out,
              (int*)perm_out};
  return (int)launch_rank<true>(nullptr, pa, (const int*)starts, nullptr,
                                scratch, n, (cudaStream_t)stream);
}

const char* radix_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
