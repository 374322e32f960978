// Order-independent set signatures of 0/1 mask rows:
//
//   sig[t] = sum_e mask[t, e] * r[e]      (mod 2^32)
//
// Replaces the TPU kernel src/repro/kernels/signature.py::signature (body
// `_kernel`), which walks a (T/bt, E/be) grid in order and carries each
// row tile's partial sums from one E block to the next in a VMEM
// accumulator.  Hopper runs blocks in parallel and in no order, so the E
// loop goes inside the block: one warp owns a whole row.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads T*E mask bytes,
// 4E bytes of r and writes 4T bytes.  At the MovieLens-1M shape's mode 0
// (T = 356,877, E = 6,040) that is 2.16 GB, 0.64 ms.  It does one
// multiply-add per mask byte, far below the card's ALU rate: memory bound.
//
// Design: one row per warp, eight warps per block.  The lanes read the
// row's mask in 16-byte vectors, neighbouring lanes on neighbouring
// vectors (after a short unaligned head, since a row starts at t*E bytes),
// multiply each byte by its r[e] and accumulate in uint32_t, whose
// wraparound is the defined mod 2^32 arithmetic; a shuffle reduction ends
// the row.  Lane v's 16 weights r[e .. e+15] lie 64 bytes from lane v+1's,
// so read from global memory each of the 16 weight loads of a warp touches
// 16 cache lines: the L1 cache, not the device memory, would set the pace.
// So each block stages r once in shared memory, with one pad word after
// every 16 (element e at e + e/16): lane v's k-th weight then lies at
// 17v + const(k), a different bank for each of 32 neighbouring lanes.  The
// blocks are persistent (as many as fit on the card at once), each walking
// rows with a stride, so r is staged once per block and not once per eight
// rows.  Where r does not fit in shared memory (E above SMEM_COLS), the
// same loop reads it through the read-only cache instead.  Row offsets are
// 64-bit: T*E passes 2^31 at the MovieLens shape.  Ragged E is handled by
// the head and tail loops; nothing is padded.
#include <cuda_runtime.h>

#include <cstdint>

// The block's padded copy of r (dynamic shared memory).
extern __shared__ uint32_t sig_r_shared[];

namespace {

constexpr int TPB = 256;                  // threads per block
constexpr int ROWS_PER_BLOCK = TPB / 32;  // one warp per row
constexpr unsigned FULL_MASK = 0xffffffffu;
// Columns whose padded weights fit the 227 KB a block may use.
constexpr long long SMEM_COLS = 53248;

__host__ __device__ __forceinline__ long long padded(long long e) {
  return e + (e >> 4);
}

// Weights r[e] from the block's shared copy (padded) or global memory.
template <bool SMEM>
struct Weights {
  const uint32_t* p;  // r in global memory
  __device__ __forceinline__ uint32_t operator[](long long e) const {
    if constexpr (SMEM) {
      return sig_r_shared[padded(e)];
    } else {
      return __ldg(p + e);
    }
  }
};

template <bool SMEM>
__device__ __forceinline__ uint32_t word_dot(uint32_t w, Weights<SMEM> r,
                                             long long e) {
  // the four mask bytes of `w` (little-endian) against r[e .. e+3]
  return (w & 0xffu) * r[e] + ((w >> 8) & 0xffu) * r[e + 1] +
         ((w >> 16) & 0xffu) * r[e + 2] + (w >> 24) * r[e + 3];
}

template <bool SMEM>
__global__ void __launch_bounds__(TPB)
signature_rows(const uint8_t* __restrict__ mask,
               const uint32_t* __restrict__ r_global,
               uint32_t* __restrict__ out, long long n_rows,
               long long n_cols) {
  const Weights<SMEM> r{r_global};
  if constexpr (SMEM) {
    for (long long e = threadIdx.x; e < n_cols; e += TPB)
      sig_r_shared[padded(e)] = r_global[e];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * ROWS_PER_BLOCK;
  for (long long t = (long long)blockIdx.x * ROWS_PER_BLOCK +
                     (threadIdx.x >> 5);
       t < n_rows; t += stride) {  // the same rows for all 32 lanes
    const uint8_t* row = mask + t * n_cols;
    uint32_t acc = 0;
    // unaligned head: bytes up to the row's first 16-byte boundary
    long long head = (long long)((16 - ((uintptr_t)row & 15)) & 15);
    if (head > n_cols) head = n_cols;
    for (long long e = lane; e < head; e += 32) acc += row[e] * r[e];
    // aligned body: one 16-byte vector per lane and step
    const long long nvec = (n_cols - head) >> 4;
    const uint4* body = reinterpret_cast<const uint4*>(row + head);
    for (long long v = lane; v < nvec; v += 32) {
      const uint4 w = body[v];
      const long long e = head + (v << 4);
      acc += word_dot(w.x, r, e) + word_dot(w.y, r, e + 4) +
             word_dot(w.z, r, e + 8) + word_dot(w.w, r, e + 12);
    }
    // ragged tail
    for (long long e = head + (nvec << 4) + lane; e < n_cols; e += 32)
      acc += row[e] * r[e];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_xor_sync(FULL_MASK, acc, d);
    if (lane == 0) out[t] = acc;
  }
}

template <bool SMEM>
cudaError_t launch(const uint8_t* mask, const uint32_t* r, uint32_t* out,
                   long long n_rows, long long n_cols, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err;
  if constexpr (SMEM) {
    // a per-device attribute: set it on every launch, for the current card
    err = cudaFuncSetAttribute(signature_rows<SMEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, signature_rows<SMEM>, TPB, smem);
  if (err != cudaSuccess) return err;
  long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  signature_rows<SMEM><<<(unsigned)blocks, TPB, smem, stream>>>(
      mask, r, out, n_rows, n_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: (n_rows, n_cols) uint8 0/1 (bool bytes), row-major and contiguous;
// r: (n_cols,) uint32; out: (n_rows,) uint32.  Launches on `stream` and
// returns the first CUDA error (0 when the launch was taken).
int signature_launch(const void* mask, const void* r, void* out,
                     long long n_rows, long long n_cols, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const uint8_t* m = (const uint8_t*)mask;
  const uint32_t* w = (const uint32_t*)r;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_cols <= SMEM_COLS) {
    const size_t smem = (size_t)(padded(n_cols) + 1) * sizeof(uint32_t);
    return (int)launch<true>(m, w, o, n_rows, n_cols, smem, s);
  }
  return (int)launch<false>(m, w, o, n_rows, n_cols, 0, s);
}

const char* signature_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
