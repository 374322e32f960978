// Single-token GQA decode attention over a KV cache:
//
//   O[b,h,:] = sum_j softmax_j(scale * Q[b,h,:] . K[b,h/g,j,:]) V[b,h/g,j,:]
//
// over the keys j that the mask keeps: j < kv_len (the query sits at
// position kv_len - 1) and, when a window is given, j > kv_len - 1 -
// window.  Q and O are (B, Hq, D) contiguous; K and V are (B, Hkv, S, D)
// read through their strides (the last one 1), so a permuted view of a
// (B, S, Hkv, D) cache is read where it lies.  fp32 or bf16; the
// statistics and the sums are fp32, the output is rounded to Q's type once.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body `_kernel`), which gives every (batch, query head)
// its own grid row, walks the KV blocks on the sequential grid axis and
// carries (m, l, acc) across the steps in VMEM scratch.  Here a block owns
// one (batch, kv head) and the G = Hq / Hkv query heads that share it, so
// each K/V tile is read from device memory once for the whole group, and
// the KV walk is a loop inside the block.  As on the TPU: tiles wholly
// past the query or before the window are skipped, scores are masked with
// the finite -1e30 (a tile whose keys are all masked then contributes
// exp(-1e30 - m) = 0 once a real key has been seen, never NaN), and the
// final l is clamped at 1e-30.
//
// Bound on an H100 SXM: bytes.  The keys the mask keeps are read once
// each, K and V: 2 x B x Hkv x kv_len x D x 2 bytes in bf16; at
// granite-moe-3b-a800m's decode (B 4, Hkv 8, D 64, kv_len 2080) 17.0 MB,
// 5.1 us at 3.35 TB/s (34 MB and 10 us in fp32); the flops (4 per key,
// query head and D) are far below any rate.
//
// Design, the simple one: one block of 128 threads per (batch, kv head),
// B x Hkv blocks in all (32 at granite-moe's decode: a quarter of the 132
// SMs; splitting the KV range over more blocks, with a combine pass, is
// the next step).  Per 64-key tile: the block loads K and V into shared
// memory as fp32 (16-byte vector loads where the strides allow; K rows
// padded to D + 1 floats so that the lanes' dot products hit distinct
// banks), each thread computes scores of (head, key) pairs, one warp per
// head does that head's online-softmax update over the tile, and each
// thread updates the accumulator of (head, column) pairs in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // threads per block
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;   // 227 KB, the most a block may use

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, group, d, kv_len;
  long long sb, sh, ss;    // element strides of K and V: batch, head, key
  int has_window, window, vec;
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

// elements of T in 16 bytes, and a 16-byte load widened to fp32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
    dst[2] = f.z;
    dst[3] = f.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// floats of shared memory a block needs
__host__ __device__ inline size_t smem_floats(int group, int d) {
  return (size_t)group * d          // qs: scaled queries
         + (size_t)BK * (d + 1)     // ks
         + (size_t)BK * d           // vs
         + (size_t)group * BK       // ps: scores, then probabilities
         + (size_t)group * d        // acc
         + 3 * (size_t)group;       // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_fwd(Args a) {
  extern __shared__ float smem[];
  const int G = a.group, D = a.d, KS = D + 1;
  float* qs = smem;
  float* ks = qs + G * D;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;
  float* acc = ps + G * BK;
  float* m = acc + G * D;
  float* l = m + G;
  float* alpha = l + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / a.hkv;
  const int kvh = blockIdx.x - b * a.hkv;
  const long long qrow = (long long)b * a.hq + (long long)kvh * G;
  const T* Q = (const T*)a.q + qrow * D;
  const T* K = (const T*)a.k + b * a.sb + kvh * a.sh;
  const T* V = (const T*)a.v + b * a.sb + kvh * a.sh;
  T* O = (T*)a.o + qrow * D;

  for (int i = tid; i < G * D; i += NT) {
    qs[i] = to_f32(Q[i]) * a.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m[g] = NEG;
    l[g] = 0.f;
  }

  const int qpos = a.kv_len - 1;
  int lo = 0;
  if (a.has_window && qpos - a.window + 1 > 0) lo = qpos - a.window + 1;
  const int t_first = lo / BK;
  const int t_last = qpos / BK;

  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * BK;
    __syncthreads();                 // the last tile's readers are done
    if (a.vec) {
      constexpr int N = Vec16<T>::N;
      const int per_row = D / N;
      for (int i = tid; i < BK * per_row; i += NT) {
        const int r = i / per_row;
        const int c = (i - r * per_row) * N;
        float kv[N], vv[N];
        if (k0 + r < a.kv_len) {
          const long long off = (long long)(k0 + r) * a.ss + c;
          Vec16<T>::load(K + off, kv);
          Vec16<T>::load(V + off, vv);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ks[r * KS + c + e] = kv[e];
          vs[r * D + c + e] = vv[e];
        }
      }
    } else {
      for (int i = tid; i < BK * D; i += NT) {
        const int r = i / D;
        const int c = i - r * D;
        const bool in = k0 + r < a.kv_len;
        const long long off = (long long)(k0 + r) * a.ss + c;
        ks[r * KS + c] = in ? to_f32(K[off]) : 0.f;
        vs[r * D + c] = in ? to_f32(V[off]) : 0.f;
      }
    }
    __syncthreads();

    // scores of (head, key) pairs; a warp shares its head, so the q reads
    // broadcast and the K rows (stride D + 1) fall in distinct banks.  Four
    // interleaved partial sums (D is a multiple of 4), added pairwise: at
    // granite-moe-3b-a800m's decode the scores reach the hundreds, where
    // one chain of D fmas gave the output several times the fp32 plain
    // version's error against float64; four chains bring it to the plain
    // version's level
    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK;
      const int key = i - g * BK;
      const int kpos = k0 + key;
      const float* qg = qs + g * D;
      const float* kr = ks + key * KS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qg[c], kr[c], s0);
        s1 = fmaf(qg[c + 1], kr[c + 1], s1);
        s2 = fmaf(qg[c + 2], kr[c + 2], s2);
        s3 = fmaf(qg[c + 3], kr[c + 3], s3);
      }
      const float s = (s0 + s1) + (s2 + s3);
      bool keep = kpos <= qpos;
      if (a.has_window) keep &= kpos > qpos - a.window;
      ps[i] = keep ? s : NEG;
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int g = warp; g < G; g += NW) {
      const float s0 = ps[g * BK + lane];
      const float s1 = ps[g * BK + lane + 32];
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      ps[g * BK + lane] = p0;
      ps[g * BK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha[g] = al;
        l[g] = l[g] * al + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, (head, column) pairs
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const int c = i - g * D;
      const float* pg = ps + g * BK;
      float x = 0.f;
#pragma unroll 8
      for (int key = 0; key < BK; ++key) x = fmaf(pg[key], vs[key * D + c], x);
      acc[i] = acc[i] * alpha[g] + x;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    O[i] = from_f32<T>(acc[i] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.group, a.d) * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  // The limit is a per-device attribute: set it on every launch (cheap)
  // so that a launch on any card of the process may use it.
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  decode_fwd<T><<<batch * a.hkv, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory, in bytes, that a launch with these dimensions needs (the
// wrapper refuses what exceeds the 227 KB a block may use).
long long decode_attention_smem_bytes(int group, int d) {
  return (long long)(smem_floats(group, d) * sizeof(float));
}

// q, o: (batch, hq, d) contiguous; k, v: (batch, hkv, s, d) with element
// strides sb, sh, ss and unit stride on d, the same for both; fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); hq a multiple of hkv; 1 <= kv_len
// <= s; window >= 1, read only when has_window.  vec = 1 when d and the
// strides are multiples of 16 bytes and k and v start on 16 bytes.
// Launches on `stream` and returns cudaGetLastError() (0 when taken).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, int batch, int hq, int hkv, int s,
                            int d, long long sb, long long sh, long long ss,
                            int kv_len, int has_window, int window,
                            float scale, int is_bf16, int vec,
                            void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || kv_len < 1 || kv_len > s ||
      (has_window && window < 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, hq, hkv, hq / hkv, d, kv_len, sb, sh, ss,
         has_window, window, vec, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(a, batch, st)
                       : launch<float>(a, batch, st));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
