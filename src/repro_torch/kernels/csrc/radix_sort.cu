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
//   2 words: 6.5 MB, 1.95 us.  Memory bound by its bytes; a key costs a few
//   integer ops and a shared atomic per pass.
// * rank: reads the 4-byte digit and writes the 4-byte rank (the 1 KiB of
//   starts aside): 6.5 MB, 1.95 us.  The fused pass reads the words and
//   the payload once and writes them once: 2 words, 24 bytes an element,
//   19.6 MB, 5.85 us.  Memory bound.
//
// Design.
// * histogram: one memset of the output and one launch on a persistent
//   grid (H_BLOCKS_PER_SM blocks of H_THREADS an SM, sized by the wrapper's
//   plan from the SM count).  Block b walks a contiguous share of the key
//   vectors (4 keys a lane, one 16-byte load a word; a lane loads
//   H_UNROLL vectors before it counts any, so a 1024-thread block keeps
//   64 KiB of 2-word keys in flight).  The scalar-load variant (template
//   VEC = false) serves words off 16 bytes; the vector variant reads a
//   vector that T cuts (the last T mod 4 keys) with scalar loads.  Each
//   key adds one to its bucket of every pass in the block's histograms in
//   shared memory with one atomicAdd, which nvcc compiles to
//   ATOMS.POPC.INC: the card adds the lanes of a warp that hit one bucket
//   in one operation, the warp aggregation that the keys' skew asks for
//   (the keys come in the context's order, so a warp's 32 digits of a high
//   pass are mostly one value).  Aggregating in software first was slower
//   on an H100: peers_of's ballot per digit bit and one atomic per
//   distinct digit, one shuffle and ballot a key to catch a warp on one
//   digit, per-lane runs of equal digits, and per-warp sub-histograms
//   (python -m repro_torch.kernels.probe_radix_histogram).  Each block
//   then adds each non-zero bucket into the output with one global
//   atomicAdd.  Counts are order-free, so the atomics' order does not
//   matter.  It is Onesweep's upfront histogram: every pass's bucket
//   starts from one read of the keys.
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
//   Status words and tile claims: lookback.cuh.  Every count is below the
//   wrapper's limit of 2^31 - 2^16 elements.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

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
constexpr int H_THREADS = 1024;           // threads of a block
constexpr int H_BLOCKS_PER_SM = 1;        // blocks an SM of the grid
constexpr int H_KEYS = 4;                 // keys of a lane's vector
constexpr int H_UNROLL = 2;               // vectors a lane loads at once
constexpr int H_COPIES = 1;               // copies of each shared bucket

// rank sweep
constexpr int R_TPB = BUCKETS;            // thread d looks back for digit d
constexpr int R_WARPS = R_TPB / 32;
constexpr int R_ITEMS = 16;               // elements a lane holds
constexpr int R_WARP_ITEMS = 32 * R_ITEMS;
constexpr int R_TILE = R_WARPS * R_WARP_ITEMS;
constexpr int LOOKBACK = 4;               // predecessor words read at once

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

// The shared counter this lane adds digit d of pass p to: copy
// lane % H_COPIES of the bucket, the copies of a bucket side by side.
__device__ __forceinline__ int slot(int p, int d, int lane) {
  return (p * BUCKETS + d) * H_COPIES + lane % H_COPIES;
}

// Adds one pass's digits of this lane's keys, d[0 .. keys), into the
// shared histograms, one atomic a key.  Every lane of the warp calls it.
__device__ __forceinline__ void add_digits(int* h, int p,
                                           const int (&d)[H_KEYS], int keys,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < H_KEYS; ++k)
    if (k < keys) atomicAdd(&h[slot(p, d[k], lane)], 1);
}

// Key vector v (keys 4v .. 4v + 3) of a word: one 16-byte load where VEC
// and all four keys lie below n, else one load a key (0 past n).
template <bool VEC>
__device__ __forceinline__ uint4 load_keys(const uint32_t* __restrict__ w,
                                           long long v, long long n) {
  const long long e = H_KEYS * v;
  if (VEC && e + H_KEYS <= n)
    return __ldg(reinterpret_cast<const uint4*>(w) + v);
  uint4 k = make_uint4(0u, 0u, 0u, 0u);
  if (e < n) k.x = __ldg(w + e);
  if (e + 1 < n) k.y = __ldg(w + e + 1);
  if (e + 2 < n) k.z = __ldg(w + e + 2);
  if (e + 3 < n) k.w = __ldg(w + e + 3);
  return k;
}

// Counts the first `keys` keys of this lane's vector in every pass.
template <int NW>
__device__ __forceinline__ void count_vector(int* h, uint4 hi, uint4 lo,
                                             int keys, const Plan& plan,
                                             int lane) {
  const uint32_t l[H_KEYS] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t u[H_KEYS] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int p = 0; p < MAX_PASS; ++p) {
    if (p >= plan.npass) break;
    int d[H_KEYS];
#pragma unroll
    for (int k = 0; k < H_KEYS; ++k)
      d[k] = NW == 2 ? digit_of(((uint64_t)u[k] << 32) | l[k], plan.shift[p],
                                plan.width[p])
                     : (int)((l[k] >> plan.shift[p]) &
                             ((1u << plan.width[p]) - 1u));
    add_digits(h, p, d, keys, lane);
  }
}

// VEC: 16-byte loads (every word 16-byte aligned).  NW: key words (hi is
// unused for 1).  Block b counts key vectors [b * per, (b + 1) * per) of
// the ceil(n / 4), per = ceil(vectors / gridDim.x), into its shared
// histograms, then adds them into the zeroed out.
template <bool VEC, int NW>
__global__ void __launch_bounds__(H_THREADS, H_BLOCKS_PER_SM)
radix_hist_kernel(const uint32_t* __restrict__ hi,
                  const uint32_t* __restrict__ lo, Plan plan,
                  int* __restrict__ out, int n) {
  extern __shared__ int h[];
  const int cells = plan.npass * BUCKETS;
  for (int j = threadIdx.x; j < H_COPIES * cells; j += H_THREADS) h[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long vectors = ((long long)n + H_KEYS - 1) / H_KEYS;
  const long long per = (vectors + gridDim.x - 1) / gridDim.x;
  const long long v0 = (long long)blockIdx.x * per;
  const long long v1 = min(vectors, v0 + per);
  // base is warp-uniform, so every lane of a warp takes each step
  for (long long base = v0 + warp * 32; base < v1;
       base += H_UNROLL * H_THREADS) {
    uint4 kl[H_UNROLL], kh[H_UNROLL];
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const long long v = base + u * H_THREADS + lane;
      kl[u] = kh[u] = make_uint4(0u, 0u, 0u, 0u);
      if (v < v1) {
        kl[u] = load_keys<VEC>(lo, v, n);
        if constexpr (NW == 2) kh[u] = load_keys<VEC>(hi, v, n);
      }
    }
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const long long vbase = base + u * H_THREADS;
      if (vbase >= v1) break;
      const long long v = vbase + lane;
      const int keys =
          v < v1 ? (int)min((long long)H_KEYS, (long long)n - H_KEYS * v) : 0;
      count_vector<NW>(h, kh[u], kl[u], keys, plan, lane);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += H_THREADS) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < H_COPIES; ++k) c += h[j * H_COPIES + k];
    if (c != 0) atomicAdd(&out[j], c);
  }
}

// One sweep: FUSED = false reads digits and writes ranks; FUSED = true
// reads the key words (and payload), finds the digits, and scatters.
template <bool FUSED>
__global__ void __launch_bounds__(R_TPB)
radix_rank_onesweep(const int* __restrict__ dig, PassArgs pa,
                    const int* __restrict__ starts, int* __restrict__ out,
                    unsigned long long* __restrict__ scratch, int n) {
  __shared__ int wh[R_WARPS][BUCKETS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int w = 0; w < R_WARPS; ++w) wh[w][threadIdx.x] = 0;
  const int tile = claim_tile(scratch);
  unsigned long long* status = status_words(scratch);
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

// scratch (lookback.cuh): the tile counter, then 256 status words per
// tile, all zeroed on the stream, then the sweep.
template <bool FUSED>
cudaError_t launch_rank(const int* dig, const PassArgs& pa,
                        const int* starts, int* out, void* scratch, int n,
                        cudaStream_t s) {
  const int ntiles = rank_tiles(n);
  cudaError_t err =
      zero_lookback_scratch(scratch, (long long)ntiles * BUCKETS, s);
  if (err != cudaSuccess) return err;
  radix_rank_onesweep<FUSED><<<ntiles, R_TPB, 0, s>>>(
      dig, pa, starts, out, (unsigned long long*)scratch, n);
  return cudaGetLastError();
}

template <bool VEC, int NW>
cudaError_t launch_hist(const uint32_t* hi, const uint32_t* lo,
                        const Plan& plan, int* out, int n, int blocks,
                        cudaStream_t s) {
  const size_t smem = (size_t)H_COPIES * plan.npass * BUCKETS * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        radix_hist_kernel<VEC, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  radix_hist_kernel<VEC, NW><<<blocks, H_THREADS, smem, s>>>(hi, lo, plan,
                                                            out, n);
  return cudaGetLastError();
}

template <bool VEC, int NW>
const void* hist_kernel() {
  return (const void*)radix_hist_kernel<VEC, NW>;
}

}  // namespace

extern "C" {

// words: hi (nullptr for one word) and lo, (n,) uint32 each; shifts and
// widths: npass <= 8 host ints; out: (npass, 256) int32, zeroed here by a
// memset on the stream; vector: 1 for 16-byte loads, which needs hi and lo
// on 16-byte boundaries (else the plan is refused), 0 for one load a key;
// blocks: the persistent grid.  One memset and one launch; returns
// cudaGetLastError().
int radix_histogram_launch(const void* hi, const void* lo, const int* shifts,
                           const int* widths, int npass, void* out, int n,
                           int vector, int blocks, void* stream) {
  if (npass < 0 || npass > MAX_PASS || n < 0 || blocks < 1 ||
      (vector != 0 && vector != 1))
    return (int)cudaErrorInvalidValue;
  if (vector && (((uintptr_t)lo | (uintptr_t)hi) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  Plan plan{};
  plan.npass = npass;
  for (int p = 0; p < npass; ++p) {
    if (shifts[p] < 0 || widths[p] < 1 || widths[p] > 8 ||
        shifts[p] + widths[p] > (hi != nullptr ? 64 : 32))
      return (int)cudaErrorInvalidValue;
    plan.shift[p] = shifts[p];
    plan.width[p] = widths[p];
  }
  if (npass == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)npass * BUCKETS * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const auto* h = (const uint32_t*)hi;
  const auto* l = (const uint32_t*)lo;
  if (hi != nullptr)
    err = vector ? launch_hist<true, 2>(h, l, plan, (int*)out, n, blocks, s)
                 : launch_hist<false, 2>(h, l, plan, (int*)out, n, blocks, s);
  else
    err = vector ? launch_hist<true, 1>(h, l, plan, (int*)out, n, blocks, s)
                 : launch_hist<false, 1>(h, l, plan, (int*)out, n, blocks, s);
  return (int)err;
}

// The histogram sweep's constants and what the runtime reports of the
// variant (vector: 16-byte loads or not; words: 1 or 2) as loaded, into
// out[0..7]: threads of a block, blocks an SM, keys of a lane's vector,
// vectors a lane loads at once, copies of each shared bucket, the largest
// npass; registers a thread and local memory bytes a thread
// (cudaFuncGetAttributes).  Returns a CUDA error code.
int radix_histogram_config(int vector, int words, long long* out) {
  if ((vector != 0 && vector != 1) || (words != 1 && words != 2))
    return (int)cudaErrorInvalidValue;
  const void* k = vector ? (words == 2 ? hist_kernel<true, 2>()
                                       : hist_kernel<true, 1>())
                         : (words == 2 ? hist_kernel<false, 2>()
                                       : hist_kernel<false, 1>());
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  const long long v[8] = {H_THREADS, H_BLOCKS_PER_SM, H_KEYS,
                          H_UNROLL,  H_COPIES,        MAX_PASS,
                          attr.numRegs, (long long)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return (int)cudaSuccess;
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
