// Fused masked prefix sums of Stage 2 (the segment reductions of both
// component operators), in the exclusive (T + 1) layout the path reads:
//
//   ex_lo[i]  = sum_{j<i} first[j] ? w_lo[j] : 0      (mod 2^32)
//   ex_hi[i]  = sum_{j<i} first[j] ? w_hi[j] : 0      (mod 2^32)
//   ex_cnt[i] = sum_{j<i} first[j]                      for i in [0, T]
//
// (the inclusive sums are ex[1:]).  Replaces the TPU kernel
// src/repro/kernels/segment_reduce.py::segment_reduce (body `_kernel`),
// which walks the table on a sequential grid and carries the running
// totals from block to block in scratch memory.  Hopper runs blocks in
// parallel and in no order, so nothing can be carried that way.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads 9 bytes per element
// (two uint32 weights, one bool flag) and writes 12 (three 32-bit sums):
// 21 bytes x T.  At T = 816,197 that is 17.1 MB, 5.1 us.  It does a few
// integer adds per element, far below the card's ALU rate: memory bound.
//
// Design: one sweep with decoupled look-back (lookback.cuh), one launch
// after one memset of the scratch, so the inputs are read once.  A block
// of TPB threads claims a tile of TILE elements from the tile counter.
// Warp w of the block holds the tile's w-th stretch of 32 x ITEMS
// elements as ITEMS / 4 chunks of 128, and lane l holds the 4 contiguous
// elements 4l .. 4l + 3 of each chunk: one 16-byte load of each weight
// lane and one 4-byte load of the flags a chunk, 512 contiguous bytes a
// warp instruction, and the stores the same.  (Runs of 16 contiguous
// elements a thread, four 16-byte loads at a 64-byte stride across the
// lanes, were slower on an H100: python -m
// repro_torch.kernels.probe_segment_reduce, variant `blocked`.)  The
// scalar-load variant (VEC = false) serves inputs off 16 bytes; a chunk
// that T cuts is read one element at a time.  A lane sums its 4 elements of a chunk, a warp
// scans the lane sums (shuffles), and the chunks' totals carry from one
// chunk to the next; one block-wide scan of the warp totals (scan.cuh,
// one barrier) gives each warp its start inside the tile and the tile's
// totals.  The three lanes are independent scans, and a 96-bit aggregate
// has no single-copy-atomic store beside a flag, so a tile publishes three
// status words, one per lane, and warp w in 0..2 walks back over lane w's
// words alone, LOOKBACK predecessors a step, adding AGGREGATE values up to
// the first INCLUSIVE one and reading again from the first NOT_READY one.
// After one more barrier every lane writes its chunks, and the lane
// holding element T - 1 writes ex[T].  Three barriers a tile: the claim,
// the scan, the look-back.  The sums are uint32_t, whose wraparound is the
// defined mod 2^32 arithmetic the signatures need; the count lane is
// int32_t.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"
#include "scan.cuh"

namespace {

constexpr int TPB = 256;            // threads of a block
constexpr int ITEMS = 16;           // elements a thread holds, 4 a chunk
constexpr int CHUNKS = ITEMS / 4;   // chunks of 128 elements a warp
constexpr int TILE = TPB * ITEMS;   // elements of a tile
constexpr int LANES = 3;            // lo, hi, count: a status word each
constexpr int LOOKBACK = 32;        // predecessor words a warp reads at once

struct Lanes {
  uint32_t lo;
  uint32_t hi;
  int32_t cnt;
};

__device__ __forceinline__ Lanes operator+(Lanes a, Lanes b) {
  return Lanes{a.lo + b.lo, a.hi + b.hi, a.cnt + b.cnt};
}

int tiles_of(int n) { return (n + TILE - 1) / TILE; }

}  // namespace

template <>
__device__ __forceinline__ Lanes shfl_up<Lanes>(Lanes v, unsigned delta) {
  return Lanes{__shfl_up_sync(FULL_MASK, v.lo, delta),
               __shfl_up_sync(FULL_MASK, v.hi, delta),
               __shfl_up_sync(FULL_MASK, v.cnt, delta)};
}

template <>
__device__ __forceinline__ Lanes shfl_idx<Lanes>(Lanes v, int src) {
  return Lanes{__shfl_sync(FULL_MASK, v.lo, src),
               __shfl_sync(FULL_MASK, v.hi, src),
               __shfl_sync(FULL_MASK, v.cnt, src)};
}

// The sum of `v` over the warp.
__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// One lane's look-back, by a whole warp: publishes `agg` as the tile's
// AGGREGATE (tile 0: INCLUSIVE) in st[tile], adds the predecessors'
// values, nearest first, up to and including the first INCLUSIVE one,
// publishes the tile's INCLUSIVE value, and returns the sum before the
// tile.  A step reads LOOKBACK words (LOOKBACK / 32 a lane; wider steps
// were no faster at 200 tiles: the probe's variant `wide`), adds only the
// words before the first NOT_READY one and reads again from there.
__device__ __forceinline__ uint32_t warp_lookback(unsigned long long* st,
                                                  int tile, uint32_t agg,
                                                  int lane) {
  constexpr int R = LOOKBACK / 32;
  if (tile == 0) {
    if (lane == 0) store_relaxed(st, INCLUSIVE | agg);
    return 0u;
  }
  if (lane == 0) store_relaxed(st + tile, AGGREGATE | agg);
  uint32_t mine = 0u;                  // this lane's share of the prefix
  int j = tile - 1;                    // the nearest predecessor not added
  bool done = false;
  while (!done) {
    unsigned long long w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j - 32 * r - lane;
      // below tile 0 (never added: tile 0 is INCLUSIVE once it is ready)
      w[r] = k >= 0 ? load_relaxed(st + k) : INCLUSIVE;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned long long flag = w[r] & FLAG_MASK;
      const unsigned not_ready = __ballot_sync(FULL_MASK, flag == 0);
      const unsigned incl = __ballot_sync(FULL_MASK, flag == INCLUSIVE);
      // the lanes below the first NOT_READY one, and those up to and
      // including the first INCLUSIVE one
      const unsigned before_nr = not_ready ? (not_ready & -not_ready) - 1u
                                           : FULL_MASK;
      const unsigned upto_in =
          incl ? ((incl & -incl) << 1) - 1u : FULL_MASK;
      const unsigned take = before_nr & upto_in;
      if ((take >> lane) & 1u) mine += (uint32_t)w[r];
      j -= __popc(take);
      if (incl & take) {
        done = true;
        break;
      }
      if (take != FULL_MASK) break;    // a NOT_READY word: read again
    }
  }
  const uint32_t prefix = warp_sum(mine);
  if (lane == 0)
    store_relaxed(st + tile, INCLUSIVE | (uint32_t)(prefix + agg));
  return prefix;
}

// VEC: 16-byte loads (w_lo, w_hi and first on 16-byte boundaries).  The
// outputs hold n + 1 elements each and start on 16-byte boundaries.
template <bool VEC>
__global__ void __launch_bounds__(TPB)
sr_onesweep(const uint32_t* __restrict__ w_lo,
            const uint32_t* __restrict__ w_hi,
            const uint8_t* __restrict__ first, uint32_t* __restrict__ ex_lo,
            uint32_t* __restrict__ ex_hi, int32_t* __restrict__ ex_cnt,
            unsigned long long* __restrict__ scratch, int n) {
  __shared__ uint32_t tile_prefix[LANES];
  const int tile = claim_tile(scratch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // element 0 of this lane's share of chunk 0; chunk c adds 128 c
  const long long e0 =
      (long long)tile * TILE + (long long)warp * 32 * ITEMS + 4 * lane;

  // masked weights, and the flags as bits of `mask`
  uint32_t lo[ITEMS], hi[ITEMS];
  unsigned mask = 0u;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long e = e0 + 128 * c;
    if (VEC && e + 4 <= n) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(w_lo + e));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(w_hi + e));
      const unsigned f = __ldg(reinterpret_cast<const unsigned*>(first + e));
      lo[4 * c] = a.x; lo[4 * c + 1] = a.y;
      lo[4 * c + 2] = a.z; lo[4 * c + 3] = a.w;
      hi[4 * c] = b.x; hi[4 * c + 1] = b.y;
      hi[4 * c + 2] = b.z; hi[4 * c + 3] = b.w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if ((f >> (8 * r)) & 0xffu) mask |= 1u << (4 * c + r);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long i = e + r;
        lo[4 * c + r] = hi[4 * c + r] = 0u;
        if (i < n) {
          lo[4 * c + r] = __ldg(w_lo + i);
          hi[4 * c + r] = __ldg(w_hi + i);
          if (__ldg(first + i)) mask |= 1u << (4 * c + r);
        }
      }
    }
  }

  // each chunk's start for this lane inside the warp's stretch
  Lanes start[CHUNKS];
  Lanes carry{};
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    Lanes sum{};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * c + r;
      const bool on = (mask >> k) & 1u;
      lo[k] = on ? lo[k] : 0u;
      hi[k] = on ? hi[k] : 0u;
      sum = sum + Lanes{lo[k], hi[k], (int32_t)on};
    }
    const Lanes inc = warp_inclusive_scan(sum);
    Lanes ex = shfl_up(inc, 1);
    if (lane == 0) ex = Lanes{};
    start[c] = carry + ex;
    carry = carry + shfl_idx(inc, 31);
  }

  Lanes total;
  const Lanes before = block_exclusive_scan_warps<Lanes, TPB>(carry, &total);
  if (warp < LANES) {
    const uint32_t agg = warp == 0 ? total.lo
                         : warp == 1 ? total.hi : (uint32_t)total.cnt;
    const uint32_t p = warp_lookback(
        status_words(scratch) + (long long)warp * gridDim.x, tile, agg, lane);
    if (lane == 0) tile_prefix[warp] = p;
  }
  __syncthreads();

  const Lanes base =
      Lanes{tile_prefix[0], tile_prefix[1], (int32_t)tile_prefix[2]} + before;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long e = e0 + 128 * c;
    Lanes acc = base + start[c];
    uint32_t a[4], b[4];
    int32_t q[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * c + r;
      a[r] = acc.lo;
      b[r] = acc.hi;
      q[r] = acc.cnt;
      acc = acc + Lanes{lo[k], hi[k], (int32_t)((mask >> k) & 1u)};
    }
    if (e + 4 <= n) {
      *reinterpret_cast<uint4*>(ex_lo + e) =
          make_uint4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<uint4*>(ex_hi + e) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<int4*>(ex_cnt + e) =
          make_int4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (e + r < n) {
          ex_lo[e + r] = a[r];
          ex_hi[e + r] = b[r];
          ex_cnt[e + r] = q[r];
        }
      }
    }
    if (e < n && e + 4 >= n) {         // the chunk that holds element n - 1
      ex_lo[n] = acc.lo;
      ex_hi[n] = acc.hi;
      ex_cnt[n] = acc.cnt;
    }
  }
}

namespace {

template <bool VEC>
const void* sweep_kernel() {
  return (const void*)sr_onesweep<VEC>;
}

}  // namespace

extern "C" {

// int32 words of scratch a launch over `n` elements needs: the tile
// counter and three 64-bit status words a tile (lookback.cuh).
int segment_reduce_scratch_ints(int n) {
  return (int)(lookback_scratch_bytes((long long)LANES * tiles_of(n)) /
               sizeof(int32_t));
}

// w_lo, w_hi: (n,) uint32; first: (n,) bool; ex_lo, ex_hi, ex_cnt: (n + 1,)
// uint32, uint32, int32 on 16-byte boundaries, the exclusive sums; scratch:
// segment_reduce_scratch_ints(n) int32 words, 8-byte aligned; vector: 1 for
// 16-byte loads, which needs w_lo, w_hi and first on 16-byte boundaries
// (else the plan is refused), 0 for one load an element.  One memset and
// one launch on `stream`; returns cudaGetLastError().
int segment_reduce_launch(const void* w_lo, const void* w_hi,
                          const void* first, void* ex_lo, void* ex_hi,
                          void* ex_cnt, void* scratch, int n, int vector,
                          void* stream) {
  if (n < 0 || (vector != 0 && vector != 1))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)ex_lo | (uintptr_t)ex_hi | (uintptr_t)ex_cnt) % 16 != 0 ||
      (uintptr_t)scratch % 8 != 0 ||
      (vector &&
       ((uintptr_t)w_lo | (uintptr_t)w_hi | (uintptr_t)first) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = tiles_of(n);
  cudaError_t err = zero_lookback_scratch(scratch, (long long)LANES * ntiles,
                                          s);
  if (err != cudaSuccess) return (int)err;
  const auto* lo = (const uint32_t*)w_lo;
  const auto* hi = (const uint32_t*)w_hi;
  const auto* f = (const uint8_t*)first;
  auto* words = (unsigned long long*)scratch;
  if (vector)
    sr_onesweep<true><<<ntiles, TPB, 0, s>>>(
        lo, hi, f, (uint32_t*)ex_lo, (uint32_t*)ex_hi, (int32_t*)ex_cnt,
        words, n);
  else
    sr_onesweep<false><<<ntiles, TPB, 0, s>>>(
        lo, hi, f, (uint32_t*)ex_lo, (uint32_t*)ex_hi, (int32_t*)ex_cnt,
        words, n);
  return (int)cudaGetLastError();
}

// The sweep's constants and what the runtime reports of the variant
// (vector: 16-byte loads or not) as loaded, into out[0..6]: threads of a
// block, elements a thread holds, elements of a tile, status words a tile,
// predecessor words a warp reads at once; registers a thread and local
// memory bytes a thread (cudaFuncGetAttributes).  Returns a CUDA error
// code.
int segment_reduce_config(int vector, long long* out) {
  if (vector != 0 && vector != 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, vector ? sweep_kernel<true>() : sweep_kernel<false>());
  if (err != cudaSuccess) return (int)err;
  const long long v[7] = {TPB,      ITEMS,        TILE,
                          LANES,    LOOKBACK,     attr.numRegs,
                          (long long)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
