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
// once, W once: 2 x rows x D x 2 bytes in bf16; at granite-moe-3b-a800m's
// prefill (4 x 2046 rows of D 1536) 50.3 MB, 15 us at 3.35 TB/s.  The
// arithmetic (about 4 flops an element) is far below the fp32 rate.
//
// Three kernels; the wrapper's pure-Python `plan` picks one per call and
// this file's `rmsnorm_config` hands it the constants it decides with.
//
// * rmsnorm_vec, the fast path: a row's bytes a multiple of 16, X, W and O
//   16-byte aligned, D <= VEC_MAX_D.  A persistent grid of VEC_BLOCKS_PER_SM
//   blocks per SM; each warp loads the weight once, as fp32, into registers
//   (its lanes always hold the same columns), then strides over rows.  A
//   lane issues all of its VPL 16-byte loads of the row (8 bf16 or 4 fp32
//   each, neighbouring lanes on neighbouring vectors) before it sums, so the
//   row is read once and stays in registers; the sum of squares is reduced
//   by shuffles and the row written once, by 16-byte stores.  VPL, the
//   vectors a lane holds, is a template parameter from LANE_VECTORS; lanes
//   past the row's last vector hold nothing.  VEC_MAX_D keeps x and the
//   fp32 weight (D / 32 floats a lane) within the 128 registers a thread
//   may use at two blocks of 256 threads per SM.
// * rmsnorm_warp (other rows of D <= WARP_MAX_D: odd widths, misaligned
//   views): one warp per row, eight rows per block, scalar loads strided by
//   32; the second pass re-reads the row from L1.
// * rmsnorm_block (D > WARP_MAX_D off the vector path, e.g. internvl2's
//   8192): one block of 256 threads per row, the warps' sums reduced
//   through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;             // threads per block, every kernel
constexpr int WARPS = NT / 32;      // rows in flight per block
constexpr int WARP_MAX_D = 1024;    // widest row of the warp kernel
constexpr int VEC_MAX_D = 1536;     // widest row of the vector kernel
constexpr int VEC_BYTES = 16;       // one vector load or store
constexpr int VEC_BLOCKS_PER_SM = 2;
// the vectors per lane instantiated; a row takes the first that covers it
constexpr int LANE_VECTORS[] = {1, 2, 3, 4, 6, 8, 12};
constexpr int N_LANE_VECTORS = sizeof(LANE_VECTORS) / sizeof(int);
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

// 16 bytes of T as fp32 values, and back.  A bf16 pair sits in one 32-bit
// word, element 0 in the low half; widening a bf16 is a 16-bit shift.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ void bf16x2_unpack(uint32_t u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16x2_pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // .x = a, low
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    bf16x2_unpack(v.x, f);
    bf16x2_unpack(v.y, f + 2);
    bf16x2_unpack(v.z, f + 4);
    bf16x2_unpack(v.w, f + 6);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(bf16x2_pack(f[0], f[1]), bf16x2_pack(f[2], f[3]),
                      bf16x2_pack(f[4], f[5]), bf16x2_pack(f[6], f[7]));
  }
};

// N consecutive weights from p (aligned to their own size x N) as fp32.
template <int N>
__device__ __forceinline__ void load_w(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float* f) {
  if constexpr (N == 8) {
    Vec<__nv_bfloat16>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
    static_assert(N == 4, "a vector of x holds 4 or 8 elements");
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    bf16x2_unpack(v.x, f);
    bf16x2_unpack(v.y, f + 2);
  }
}

template <typename T, typename W, int VPL>
__global__ void __launch_bounds__(NT, VEC_BLOCKS_PER_SM)
    rmsnorm_vec(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ o, long long rows, int d, float eps) {
  constexpr int EPV = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int nvec = d / EPV;
  // the weight of this lane's columns, once per warp
  float wf[VPL][EPV];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      load_w<EPV>(w + (long long)v * EPV, wf[k]);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) wf[k][e] = 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       row < rows; row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 xv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k)       // every load issued before any use
      if (lane + 32 * k < nvec) xv[k] = xr[lane + 32 * k];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nvec) {
        float f[EPV];
        Vec<T>::unpack(xv[k], f);
#pragma unroll
        for (int e = 0; e < EPV; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    uint4* orow = reinterpret_cast<uint4*>(o + row * d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nvec) {
        float f[EPV];
        Vec<T>::unpack(xv[k], f);
#pragma unroll
        for (int e = 0; e < EPV; ++e) f[e] = f[e] * r * wf[k][e];
        orow[lane + 32 * k] = Vec<T>::pack(f);
      }
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(NT)
    rmsnorm_warp(const T* __restrict__ x, const W* __restrict__ w,
                 T* __restrict__ o, long long rows, int d, float eps) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
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
  __shared__ float part[WARPS];
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
    float t = threadIdx.x < WARPS ? part[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) scale = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;
  T* orow = o + row * d;
  for (int c = threadIdx.x; c < d; c += NT)
    orow[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(w[c]));
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

template <typename T, typename W, int VPL>
cudaError_t launch_vec(const void* x, const void* w, void* o,
                       long long rows, int d, float eps, cudaStream_t s) {
  // a count that is no row's smallest cover is never launched: not built
  if constexpr ((VPL - 1) * 32 * Vec<T>::N >= VEC_MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > (long long)sms * VEC_BLOCKS_PER_SM)
      blocks = (long long)sms * VEC_BLOCKS_PER_SM;
    rmsnorm_vec<T, W, VPL><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (const W*)w, (T*)o, rows, d, eps);
    return cudaGetLastError();
  }
}

// The vectors a lane holds for a row of d elements of T: the first of
// LANE_VECTORS that covers the row (the wrapper's plan computes the same).
template <typename T>
int lane_vectors(int d) {
  const int nvec = d / Vec<T>::N;
  for (int i = 0; i < N_LANE_VECTORS; ++i)
    if (32 * LANE_VECTORS[i] >= nvec) return LANE_VECTORS[i];
  return 0;
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* o, long long rows,
                   int d, float eps, int path, int vpl, cudaStream_t s) {
  if (path == 0) {                                   // vector
    const uintptr_t misaligned = ((uintptr_t)x | (uintptr_t)w |
                                  (uintptr_t)o) & (VEC_BYTES - 1);
    if (misaligned || (d * (int)sizeof(T)) % VEC_BYTES != 0 ||
        d > VEC_MAX_D || vpl != lane_vectors<T>(d))
      return cudaErrorInvalidValue;
    switch (vpl) {
      case 1: return launch_vec<T, W, 1>(x, w, o, rows, d, eps, s);
      case 2: return launch_vec<T, W, 2>(x, w, o, rows, d, eps, s);
      case 3: return launch_vec<T, W, 3>(x, w, o, rows, d, eps, s);
      case 4: return launch_vec<T, W, 4>(x, w, o, rows, d, eps, s);
      case 6: return launch_vec<T, W, 6>(x, w, o, rows, d, eps, s);
      case 8: return launch_vec<T, W, 8>(x, w, o, rows, d, eps, s);
      case 12: return launch_vec<T, W, 12>(x, w, o, rows, d, eps, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == 1) {                                   // warp
    if (d > WARP_MAX_D) return cudaErrorInvalidValue;
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_warp<T, W><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)x, (const W*)w, (T*)o, rows, d, eps);
    return cudaGetLastError();
  }
  if (path == 2) {                                   // block
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_block<T, W><<<(unsigned)rows, NT, 0, s>>>(
        (const T*)x, (const W*)w, (T*)o, d, eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The constants the wrapper's plan decides with, in this order: threads
// per block, WARP_MAX_D, VEC_MAX_D, VEC_BYTES, VEC_BLOCKS_PER_SM, the
// number of LANE_VECTORS, then LANE_VECTORS itself; `out` holds 16 int64.
int rmsnorm_config(long long* out) {
  const long long head[] = {NT, WARP_MAX_D, VEC_MAX_D, VEC_BYTES,
                            VEC_BLOCKS_PER_SM, N_LANE_VECTORS};
  int j = 0;
  for (long long v : head) out[j++] = v;
  for (int i = 0; i < N_LANE_VECTORS; ++i) out[j++] = LANE_VECTORS[i];
  for (; j < 16; ++j) out[j] = 0;
  return (int)cudaSuccess;
}

// x, o: (rows, d) contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// w: (d,) contiguous, fp32 (w_bf16 = 0) or bf16 (w_bf16 = 1).  path: 0
// vector (vpl vectors a lane), 1 warp, 2 block, as the wrapper's plan
// chose; a path that does not take these arguments is refused with
// cudaErrorInvalidValue.  Launches on `stream` and returns
// cudaGetLastError() (0 when taken).
int rmsnorm_launch(const void* x, const void* w, void* o, long long rows,
                   int d, int x_bf16, int w_bf16, float eps, int path,
                   int vpl, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (x_bf16)
    err = w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, o, rows, d,
                                                        eps, path, vpl, s)
                 : launch<__nv_bfloat16, float>(x, w, o, rows, d, eps, path,
                                                vpl, s);
  else
    err = w_bf16 ? launch<float, __nv_bfloat16>(x, w, o, rows, d, eps, path,
                                                vpl, s)
                 : launch<float, float>(x, w, o, rows, d, eps, path, vpl, s);
  return (int)err;
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
