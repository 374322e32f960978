// RMSNorm over the last axis of a (rows, D) matrix:
//
//   O[r, :] = X[r, :] * rsqrt(mean_c(X[r, c]^2) + eps) * W[:]
//
// with the statistics and the products in fp32 and one rounding to X's
// type at the end.  X and O are contiguous, fp32 or bf16; W is (D,), fp32
// or bf16.  Any number of rows: nothing is padded.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// `_kernel`), which normalises (br, D) row blocks, br = 256, on a
// sequential grid and needs rows padded to a multiple of br.  Rows are
// independent, so here every row is its own unit of work and the ragged
// edge needs no padding.
//
// Bound on an H100 SXM: bytes.  Each element is read once and written
// once (W is reused from cache), 2 x rows x D x 2 bytes in bf16: at
// granite-moe-3b-a800m's prefill (4 x 2046 rows of D 1536) 50.3 MB, 15 us
// at 3.35 TB/s; the arithmetic (3 flops an element) is far below the
// fp32 rate.
//
// Design, the simple one.  D <= 1024 (every norm of the LM families but
// internvl2's d_model 8192): one warp per row, eight rows per block of
// 256 threads; lanes stride over the row (neighbouring lanes on
// neighbouring elements), sum their squares in fp32 and reduce by warp
// shuffles.  D > 1024: one block of 256 threads per row, the warps' sums
// reduced through shared memory.  The second pass re-reads the row, which
// is then in L1 (a row is at most 32 KB); the write rounds once to X's
// type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS_PER_BLOCK = 8;   // warps per block of the warp kernel
constexpr int NT = 256;             // threads per block, both kernels
constexpr int WARP_MAX_D = 1024;    // widest row the warp kernel takes
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT)
    rmsnorm_warp(const T* __restrict__ x, const W* __restrict__ w,
                 T* __restrict__ o, long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;                 // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
  T* orow = o + row * d;
  for (int c = lane; c < d; c += 32)
    orow[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(w[c]));
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT)
    rmsnorm_block(const T* __restrict__ x, const W* __restrict__ w,
                  T* __restrict__ o, int d, float eps) {
  __shared__ float part[NT / 32];
  __shared__ float scale;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += NT) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < NT / 32 ? part[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) scale = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;
  T* orow = o + row * d;
  for (int c = threadIdx.x; c < d; c += NT)
    orow[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(w[c]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* o, long long rows,
                   int d, float eps, cudaStream_t s) {
  if (d <= WARP_MAX_D) {
    const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_warp<T, W><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (const W*)w, (T*)o, rows, d, eps);
  } else {
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_block<T, W><<<(unsigned)rows, NT, 0, s>>>(
        (const T*)x, (const W*)w, (T*)o, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, o: (rows, d) contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// w: (d,) contiguous, fp32 (w_bf16 = 0) or bf16 (w_bf16 = 1).  Launches
// on `stream` and returns cudaGetLastError() (0 when taken).
int rmsnorm_launch(const void* x, const void* w, void* o, long long rows,
                   int d, int x_bf16, int w_bf16, float eps, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (x_bf16)
    err = w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, o, rows, d,
                                                        eps, s)
                 : launch<__nv_bfloat16, float>(x, w, o, rows, d, eps, s);
  else
    err = w_bf16 ? launch<float, __nv_bfloat16>(x, w, o, rows, d, eps, s)
                 : launch<float, float>(x, w, o, rows, d, eps, s);
  return (int)err;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
