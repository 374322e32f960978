// Causal / sliding-window GQA flash attention, forward only:
//
//   O[b,h,i,:] = sum_j softmax_j(scale * Q[b,h,i,:] . K[b,h/g,j,:]) V[b,h/g,j,:]
//
// over the keys j that the mask keeps: j < Skv, j <= q_offset + i when
// causal, j > q_offset + i - window when a window is given.  Q is
// (B, Hq, Sq, D), K and V are (B, Hkv, Skv, D), all contiguous, in fp32 or
// bf16; O is Q's shape and type.  Query head h reads KV head h / group.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_kernel`), which walks the KV blocks on the last,
// sequential grid axis and carries the online-softmax state (m, l, acc)
// from step to step in VMEM scratch.  Hopper runs blocks in no order, so
// here the KV walk is a loop inside the block and the state lives in
// registers.  Like the TPU kernel it skips KV tiles that no (query, key)
// pair of the block can use (beyond Skv, after the causal diagonal, before
// the window), masks scores with the finite -1e30 (never -inf: a row whose
// scores in one tile are all masked would compute -inf - -inf = NaN; with
// -1e30 the next real tile's alpha = exp(-1e30 - m) = 0 wipes that tile's
// contribution), and clamps the final l to 1e-30.  Ragged Sq and Skv are
// masked in the kernel: nothing is padded; out-of-range K and V rows are
// read as zeros.
//
// Bound on an H100 SXM: 4 * B * Hq * Sq * Skv * D / 2 flops for a causal
// run (two products, half the score matrix), against 989 TFLOP/s of bf16
// tensor cores; at B 4 x Hq 24 x S 2048 x D 64 that is 51.5 GFLOP, 52 us,
// while Q, K, V and O move 67 MB (20 us at 3.35 TB/s): operations bound.
//
// Design, the simple one: CUDA cores in fp32 (no wgmma, no TMA).  A block
// of 256 threads takes 64 query rows of one (batch, head); each thread
// owns 4 rows x 4 keys of each 64 x 64 score tile and 4 rows x D/16 output
// columns (rows ty + 16 i, columns tx + 16 j, so a warp reads its K and V
// columns from 16 distinct banks).  Q (pre-scaled), K and V tiles sit in
// shared memory as fp32 (stride D + 1 for Q and K); the probability tile P
// goes through shared memory between the two products.  Statistics and the
// accumulator are fp32; the output is rounded to the input type once.
// Shared memory is 29-115 KB by head dim, above the 48 KB default from
// D = 64 on, so the launch raises the block's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads per block, a 16 x 16 grid
constexpr int RPT = BQ / 16;  // score rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, group, sq, skv;
  int causal, has_window, window, q_offset;
  float scale;
};

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

// reductions over the 16 threads that share a row (lanes differing in
// their low 4 bits)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  constexpr int QS = D + 1;      // row stride of the Q and K tiles
  constexpr int PS = BK + 1;     // row stride of the P tile
  constexpr int DPT = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][QS], scaled
  float* ks = qs + BQ * QS;      // [BK][QS]
  float* vs = ks + BK * QS;      // [BK][D]
  float* ps = vs + BK * D;       // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;               // b * Hq + h
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  const long long kvh = (long long)b * a.hkv + h / a.group;
  const T* Q = (const T*)a.q + (long long)bh * a.sq * D;
  const T* K = (const T*)a.k + kvh * a.skv * D;
  const T* V = (const T*)a.v + kvh * a.skv * D;
  T* O = (T*)a.o + (long long)bh * a.sq * D;

  const int q0 = blockIdx.x * BQ;          // first q row of the block
  const int q_start = q0 + a.q_offset;     // its position among the keys

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    const float x =
        q0 + r < a.sq ? to_f32(Q[(long long)(q0 + r) * D + c]) : 0.f;
    qs[r * QS + c] = x * a.scale;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (a.skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_start = ik * BK;
    // block-level relevance: can any (q, k) pair of the tile pass the mask?
    bool relevant = true;
    if (a.causal) relevant &= k_start <= q_start + BQ - 1;
    if (a.has_window) relevant &= k_start + BK - 1 > q_start - a.window;
    if (!relevant) continue;               // uniform across the block

    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      const bool in = k_start + r < a.skv;
      const long long g = (long long)(k_start + r) * D + c;
      ks[r * QS + c] = in ? to_f32(K[g]) : 0.f;
      vs[r * D + c] = in ? to_f32(V[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_start + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k_start + tx + 16 * j;
        bool keep = kpos < a.skv;
        if (a.causal) keep &= kpos <= qpos;
        if (a.has_window) keep &= kpos > qpos - a.window;
        s[i][j] = keep ? s[i][j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = e;
        sum += e;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      O[(long long)r * D + tx + 16 * j] = from_f32<T>(acc[i][j] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  // The limit is a per-device attribute: set it on every launch (cheap)
  // so that a launch on any card of the process may use it.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, batch * a.hq);
  flash_fwd<T, D><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Args& a, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, s);
    case 32: return launch<T, 32>(a, batch, s);
    case 64: return launch<T, 64>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, hq, sq, d); k, v: (batch, hkv, skv, d); o like q; all
// contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); d in {16, 32, 64,
// 128}; hq a multiple of hkv.  window is read only when has_window.
// Launches on `stream` and returns cudaGetLastError() (0 when taken).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int hq, int hkv, int sq,
                           int skv, int d, int is_bf16, int causal,
                           int has_window, int window, int q_offset,
                           float scale, void* stream) {
  if (batch <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, hq, hkv, hq / hkv, sq, skv,
         causal, has_window, window, q_offset, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_dim<__nv_bfloat16>(a, batch, d, s)
                       : launch_dim<float>(a, batch, d, s));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
