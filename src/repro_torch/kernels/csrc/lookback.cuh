// Decoupled look-back (Merrill and Garland's single-pass prefix scan),
// shared by the port's one-sweep kernels: radix_rank (radix_sort.cu) and
// segment_reduce (segment_reduce.cu).
//
// Tiles.  Blocks are scheduled in no order and a block may wait for a
// predecessor tile, so the tile a block works on is NOT its blockIdx.x but
// the next value of a global counter, taken when the block starts
// (claim_tile).  Tile k is then only ever claimed after tiles 0..k-1 were
// claimed by blocks that already run, so every tile it waits for makes
// progress.  With blockIdx.x a resident block could spin on a tile whose
// block cannot be scheduled until the spinning one leaves.
//
// Status words.  A tile publishes each of its running values in a 64-bit
// word: the flag in bits 62-63, the 32-bit value in bits 0-31; 0 is
// NOT_READY, so zeroed scratch (one cudaMemsetAsync on the stream before
// the launch) starts every tile NOT_READY.  Words are written by one
// st.relaxed.gpu and read by ld.relaxed.gpu.  Aligned 64-bit accesses are
// single-copy atomic, so a reader sees a flag with its own value, and the
// value is the only thing a tile learns from another: there is no other
// data whose visibility a release/acquire pair would have to order.  (On
// an H100, st.release.gpu publishes and a fence.acq_rel.gpu after the
// look-back cost about a quarter of the rank sweep: python -m
// repro_torch.kernels.probe_radix_rank.)  A value wider than 32 bits has
// no single-copy-atomic store beside its flag, so a tile with several
// values publishes one word for each.
//
// Scratch layout: the tile counter in word 0, then the status words.
#pragma once

#include <cuda_runtime.h>

constexpr unsigned long long FLAG_MASK = 3ull << 62;
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;

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

// The tile this block works on: the next value of the counter in word 0
// of the scratch.  Every thread of the block must call it; it
// synchronises the block, so shared memory written before the call is
// visible to the whole block after it.
__device__ __forceinline__ int claim_tile(unsigned long long* scratch) {
  __shared__ int tile;
  if (threadIdx.x == 0)
    tile = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  return tile;
}

// The status words after the counter.
__device__ __forceinline__ unsigned long long* status_words(
    unsigned long long* scratch) {
  return scratch + 1;
}

// Bytes of scratch for `words` status words.
inline size_t lookback_scratch_bytes(long long words) {
  return (size_t)(1 + words) * sizeof(unsigned long long);
}

// Zero the scratch on the stream: the counter and every status word.
inline cudaError_t zero_lookback_scratch(void* scratch, long long words,
                                         cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0, lookback_scratch_bytes(words), s);
}
