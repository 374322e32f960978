// Exact tricluster density numerators (box counts):
//
//   num[t] = sum_{g,m,b} X[t,g] * Y[t,m] * Z[t,b] * I[g,m,b]
//
// for T candidate triclusters with 0/1 membership masks X (T,G), Y (T,M),
// Z (T,B) against the dense 0/1 tensor I (G,M,B).
//
// Replaces the TPU kernel
// src/repro/kernels/tricluster_density.py::tricluster_density (body
// `_kernel`), which walks a (T/bt, G/bg) grid in order, runs C = Y @ I[g]
// on the MXU for each step, reduces C against Z and X on the VPU, and
// carries each row tile's sums over the g axis in a VMEM accumulator.
// Hopper runs blocks in parallel and in no order, so the g loop goes inside
// a block that owns a tile of 32 rows t: blocks never share a row, and no
// atomics are needed.
//
// Bound on an H100 SXM: the function reads G*M*B + T*(G+M+B) bytes and
// writes 4T; its dense work is 2*T*G*M*B operations on 0/1 operands.  At
// the MovieLens-1M shape (T = 356,877, G x M x B = 6,040 x 3,952 x 5) that
// is 3.69 GB (1.10 ms at 3.35 TB/s) against 8.52e13 operations (43.0 ms at
// the 1,979 TOP/s int8 tensor-core rate, which computes 0/1 products with
// int32 sums exactly): operation bound.
//
// Design: bit-parallel on CUDA cores.  The operands are 0/1, so the m sum
// of a (t, g, b) triple is popc(Ybits[t] & Ibits[g,b]) over 32-bit words
// that pack 32 values of m each: one AND and one POPC do 32 of the dense
// products, every one of them, whatever the data (nothing is skipped).
//   (1) td_pack_tensor packs I once into Ibits (G, B, ceil(M/32)) words,
//       one warp ballot per word, into scratch the wrapper allocates.
//   (2) td_count: each block packs its 32 Y rows into shared memory by
//       ballots (in chunks of 128 words, 4,096 values of m), stages its Z
//       and X tiles, and each warp takes every eighth g; lane i owns row
//       t0 + i, so the Ibits words a warp reads are the same for all its
//       lanes (one broadcast load) and the Ybits rows are read from shared
//       memory without bank conflicts (row stride 129 words).  Every
//       (t, g, b) count is computed and then weighted by X[t,g]*Z[t,b].
// Counts are int32 and the result is written as float32 at the end, exact
// for any count below 2^24.  Offsets are 64-bit: T*G passes 2^31 at the
// MovieLens shape.  Ragged T, G, M and B are masked; nothing is padded.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;           // threads per block
constexpr int NWARP = TPB / 32;    // warps per block
constexpr int TT = 32;             // rows t per block: one per lane
constexpr int WC = 128;            // packed words of m per chunk
constexpr int GC = 64;             // g values per X stage
constexpr int BC = 32;             // b values per Z stage
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(TPB)
td_pack_tensor(const uint8_t* __restrict__ tensor, uint32_t* __restrict__ bits,
               long long n_g, int n_m, int n_b, int n_w) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * NWARP;
  const long long words = n_g * n_b * n_w;
  for (long long idx = ((long long)blockIdx.x * TPB + threadIdx.x) >> 5;
       idx < words; idx += nwarps) {
    const int w = (int)(idx % n_w);
    const long long gb = idx / n_w;
    const int b = (int)(gb % n_b);
    const long long g = gb / n_b;
    const int m = w * 32 + lane;
    const bool bit = m < n_m && tensor[(g * n_m + m) * n_b + b] != 0;
    const uint32_t word = __ballot_sync(FULL_MASK, bit);
    if (lane == 0) bits[idx] = word;
  }
}

__global__ void __launch_bounds__(TPB)
td_count(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
         const uint8_t* __restrict__ z, const uint32_t* __restrict__ bits,
         float* __restrict__ out, long long n_t, int n_g, int n_m, int n_b,
         int n_w) {
  __shared__ uint32_t ys[TT][WC + 1];
  __shared__ uint8_t xs[TT][GC + 4];
  __shared__ uint8_t zs[TT][BC + 4];
  __shared__ int part[NWARP][TT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * TT;
  int acc = 0;  // this thread's count for row t0 + lane over its g values
  for (int w0 = 0; w0 < n_w; w0 += WC) {
    const int wc = min(WC, n_w - w0);
    __syncthreads();  // the previous chunk's readers of ys are done
    for (int idx = warp; idx < TT * wc; idx += NWARP) {
      const int tt = idx / wc;
      const int wl = idx - tt * wc;
      const long long t = t0 + tt;
      const int m = (w0 + wl) * 32 + lane;
      const bool bit = t < n_t && m < n_m && y[t * n_m + m] != 0;
      const uint32_t word = __ballot_sync(FULL_MASK, bit);
      if (lane == 0) ys[tt][wl] = word;
    }
    for (int b0 = 0; b0 < n_b; b0 += BC) {
      const int bc = min(BC, n_b - b0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < TT * bc; idx += TPB) {
        const int tt = idx / bc;
        const int bl = idx - tt * bc;
        const long long t = t0 + tt;
        zs[tt][bl] = t < n_t ? z[t * n_b + b0 + bl] : 0;
      }
      for (int g0 = 0; g0 < n_g; g0 += GC) {
        const int gc = min(GC, n_g - g0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TT * gc; idx += TPB) {
          const int tt = idx / gc;
          const int gl = idx - tt * gc;
          const long long t = t0 + tt;
          xs[tt][gl] = t < n_t ? x[t * n_g + g0 + gl] : 0;
        }
        __syncthreads();
        for (int gl = warp; gl < gc; gl += NWARP) {
          const bool xg = xs[lane][gl] != 0;
          const long long g = g0 + gl;
          for (int bl = 0; bl < bc; ++bl) {
            const uint32_t* ib = bits + (g * n_b + b0 + bl) * n_w + w0;
            int cnt = 0;
            for (int wl = 0; wl < wc; ++wl)
              cnt += __popc(ys[lane][wl] & __ldg(ib + wl));
            if (xg && zs[lane][bl] != 0) acc += cnt;
          }
        }
      }
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < TT) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += part[w][threadIdx.x];
    const long long t = t0 + threadIdx.x;
    if (t < n_t) out[t] = (float)s;
  }
}

}  // namespace

extern "C" {

// uint32 words of scratch the launch needs: the packed tensor.
long long tricluster_density_scratch_words(long long n_g, long long n_m,
                                           long long n_b) {
  return n_g * n_b * ((n_m + 31) / 32);
}

// tensor: (n_g, n_m, n_b) uint8 0/1; x, y, z: (n_t, n_g), (n_t, n_m),
// (n_t, n_b) uint8 0/1, all contiguous; scratch:
// tricluster_density_scratch_words(...) uint32 words; out: (n_t,) float32.
// Launches on `stream` and returns cudaGetLastError() (0 when every launch
// was taken).
int tricluster_density_launch(const void* tensor, const void* x,
                              const void* y, const void* z, void* scratch,
                              void* out, long long n_t, long long n_g,
                              long long n_m, long long n_b, void* stream) {
  if (n_t <= 0) return (int)cudaSuccess;
  if (n_g > 0x7fffffffLL || n_m > 0x7fffffffLL - 31 || n_b > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_w = (int)((n_m + 31) / 32);
  const long long words = n_g * n_b * n_w;
  uint32_t* bits = (uint32_t*)scratch;
  if (words > 0) {
    long long blocks = (words + NWARP - 1) / NWARP;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    td_pack_tensor<<<(unsigned)blocks, TPB, 0, s>>>(
        (const uint8_t*)tensor, bits, n_g, (int)n_m, (int)n_b, n_w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long nblocks = (n_t + TT - 1) / TT;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  td_count<<<(unsigned)nblocks, TPB, 0, s>>>(
      (const uint8_t*)x, (const uint8_t*)y, (const uint8_t*)z, bits,
      (float*)out, n_t, (int)n_g, (int)n_m, (int)n_b, n_w);
  return (int)cudaGetLastError();
}

const char* tricluster_density_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
