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
// each K/V tile is read from device memory once for the whole group.  As
// on the TPU: tiles wholly past the query or before the window are never
// read, masked scores are the finite -1e30, and the final l is clamped at
// 1e-30.
//
// Bound on an H100 SXM: bytes.  The keys the mask keeps are read once
// each, K and V: 2 x B x Hkv x kv_len x D x 2 bytes in bf16; at
// granite-moe-3b-a800m's decode (B 4, Hkv 8, D 64, kv_len 2049) 16.8 MB,
// 5.0 us at 3.35 TB/s (34 MB and 10 us in fp32); the flops (4 per key,
// query head and D) are far below any rate.  In serving the cache comes
// from device memory, not L2: 32 layers' caches and the weights pass
// between two reads of one layer's.
//
// Design: split-KV (flash-decoding), two kernels.  B x Hkv blocks alone
// fill a quarter of the 132 SMs at granite-moe's decode (32), so the grid
// is (B x Hkv, n_split): each block walks one range of whole 64-key tiles
// of [lo, kv_len).  The wrapper picks the ranges (kernels/
// decode_attention.py: about two blocks per SM; n_split = 1 when B x Hkv
// fills that alone; at granite-moe's decode 9 splits of 4 tiles).  K and V
// tiles are staged in the input type (bf16 stays bf16) in a ring of 2-4
// stages filled by 16-byte cp.async.cg copies through the view's strides,
// so the next tiles load while one computes (rows padded by 16 bytes: the
// lanes' 16-byte reads of neighbouring rows fall on distinct banks);
// unaligned views take a scalar copy path into the same ring.  Per tile:
// each thread computes scores of (head, key) pairs in four interleaved
// fp32 chains (one chain of D fmas erred several times the fp32 plain
// version at the real activations' scores, which reach the hundreds), one
// warp per head does that head's online-softmax update, and each thread
// updates the accumulator of (head, column) pairs in shared memory.  With
// one split the block writes O itself; otherwise it writes its (acc, m,
// l) to an fp32 scratch (B, Hq, n_split, D + 2) and decode_combine forms
// O = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30): a
// split with no live key (l = 0, m = -1e30) weighs 0, never NaN.  When
// the wrapper asks for it (lse != nullptr) the kernel that writes O also
// writes the fp32 log-sum-exp of the scaled scores, m + log l (the
// combine: m* + log sum_s e^(m_s - m*) l_s), (B, Hq): the state ranks
// that each hold a block of a ring's slots combine their outputs with.
// Any D that is a multiple of 8 runs, and any group (the wrapper zero-pads
// any other D to the next multiple of 8): a K/V row is D / 8 (bf16) or
// D / 4 (fp32) 16-byte chunks at a stride of D + 16 bytes, and the scores
// read q and K in 16-byte steps; nothing is a power of two.
// At Zamba2's MHA decode (G = 1, D 112) a block holds one query head;
// 2-4 ring stages take 63-124 KB in bf16, and in fp32 2-3 take 120-179 KB
// (four would pass the 227 KB a block may use, so the launch steps down
// to three).  Where even two stages and the group's state pass it (large
// G x D: fp32 at D 256, bf16 at D 512 and G 16) the launch takes the wide
// path below, which splits the group and O's columns over blocks and
// streams K and V in 64-column slices, in bounded shared memory.
// Measured by chip_smoke.py on one H100 80GB HBM3 at 700 W at granite-
// moe's decode: 0.0224 ms with the cache in L2, 0.0246 ms with it out of
// L2 (PyTorch's SDPA 0.0110 / 0.0147 ms), five times the bytes' bound.
// Where the rest goes is not measured; each block's four tiles of serial
// work (three barriers a tile) and the second launch are the suspects.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_STAGES = 4;
constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;   // 227 KB, the most a block may use

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;              // (B, Hq) or nullptr
  float* part;             // (B, Hq, n_split, D + 2) when n_split > 1
  int hq, hkv, group, d, kv_len;
  long long sb, sh, ss;    // element strides of K and V: batch, head, key
  int has_window, window, vec, stages;
  int t_first, tiles_per_split;
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

// 16 bytes of T in shared memory, widened to fp32
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void get(const float* src, float* dst) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
    dst[2] = f.z;
    dst[3] = f.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void get(const __nv_bfloat16* src,
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; zero-fills the destination when !in (src
// must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

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

// bytes of shared memory a block needs: the K/V ring, then fp32 state
__host__ __device__ inline size_t ring_bytes(int stages, int d, int es) {
  return (size_t)stages * 2 * BK * ((size_t)d * es + 16);
}
__host__ __device__ inline size_t smem_bytes(int stages, int group, int d,
                                             int es) {
  return ring_bytes(stages, d, es) +
         sizeof(float) * ((size_t)group * d        // qs: scaled queries
                          + (size_t)group * BK     // ps: scores, then P
                          + (size_t)group * d      // acc
                          + 3 * (size_t)group);    // m, l, alpha
}

// The online softmax of a key tile for G heads: scores ps[g][0..BK)
// become P, and m, l and alpha (the factor for acc) are updated; one warp
// per head, two keys per lane.  A masked key weighs exactly 0, so a split
// whose keys are all masked keeps l = 0
__device__ __forceinline__ void heads_softmax(float* ps, float* m, float* l,
                                              float* alpha, int G) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += NW) {
    const float s0 = ps[g * BK + lane];
    const float s1 = ps[g * BK + lane + 32];
    const float m_old = m[g];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
    const float p0 = s0 == NEG ? 0.f : expf(s0 - m_new);
    const float p1 = s1 == NEG ? 0.f : expf(s1 - m_new);
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
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_split(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = Chunk<T>::N;         // elements in 16 bytes
  const int G = a.group, D = a.d, S = a.stages;
  const int RS = D + N;                  // ring row stride: 16 bytes padding
  T* ring = reinterpret_cast<T*>(smem);  // [S][K, V][BK][RS]
  float* qs = reinterpret_cast<float*>(smem + ring_bytes(S, D, sizeof(T)));
  float* ps = qs + G * D;
  float* acc = ps + G * BK;
  float* m = acc + G * D;
  float* l = m + G;
  float* alpha = l + G;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.hkv;
  const int kvh = blockIdx.x - b * a.hkv;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const long long qrow = (long long)b * a.hq + (long long)kvh * G;
  const T* Q = (const T*)a.q + qrow * D;
  const T* K = (const T*)a.k + b * a.sb + kvh * a.sh;
  const T* V = (const T*)a.v + b * a.sb + kvh * a.sh;

  const int qpos = a.kv_len - 1;
  const int t0 = a.t_first + split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, qpos / BK + 1);   // [t0, t1)

  // tile t into ring stage (t - t0) % S: cp.async when the rows are
  // 16-byte aligned, plain loads and stores otherwise; keys at or past
  // kv_len read as zeros
  auto load_tile = [&](int t) {
    T* kd = ring + (size_t)((t - t0) % S) * 2 * BK * RS;
    T* vd = kd + BK * RS;
    const int k0 = t * BK;
    if (a.vec) {
      const int per_row = D / N;
      for (int i = tid; i < BK * per_row; i += NT) {
        const int r = i / per_row;
        const int c = (i - r * per_row) * N;
        const bool in = k0 + r < a.kv_len;
        const long long off = (long long)(in ? k0 + r : 0) * a.ss + c;
        cp_async16(smem_addr(kd + r * RS + c), K + off, in);
        cp_async16(smem_addr(vd + r * RS + c), V + off, in);
      }
    } else {
      for (int i = tid; i < BK * D; i += NT) {
        const int r = i / D;
        const int c = i - r * D;
        const bool in = k0 + r < a.kv_len;
        const long long off = (long long)(k0 + r) * a.ss + c;
        kd[r * RS + c] = in ? K[off] : from_f32<T>(0.f);
        vd[r * RS + c] = in ? V[off] : from_f32<T>(0.f);
      }
    }
  };

  for (int i = 0; i < S - 1; ++i) {      // the ring's first S - 1 tiles
    if (t0 + i < t1) load_tile(t0 + i);
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += NT) {
    qs[i] = to_f32(Q[i]) * a.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m[g] = NEG;
    l[g] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BK;
    cp_async_wait(S - 2);                // tile t landed (this thread's part)
    __syncthreads();                     // ... every thread's; tile t - 1's
                                         // readers are done with its stage
    if (t + S - 1 < t1) load_tile(t + S - 1);
    cp_async_commit();
    const T* ks = ring + (size_t)((t - t0) % S) * 2 * BK * RS;
    const T* vs = ks + BK * RS;

    // scores of (head, key) pairs; a warp shares its head, so the q reads
    // broadcast, and its lanes' 16-byte reads of neighbouring K rows fall
    // on distinct banks.  Four interleaved partial sums (element c goes to
    // chain c % 4), added pairwise
    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK;
      const int key = i - g * BK;
      const int kpos = k0 + key;
      const float* qg = qs + g * D;
      const T* kr = ks + key * RS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int c = 0; c < D; c += N) {
        float kf[N];
        Chunk<T>::get(kr + c, kf);
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + c + e);
          s0 = fmaf(qv.x, kf[e], s0);
          s1 = fmaf(qv.y, kf[e + 1], s1);
          s2 = fmaf(qv.z, kf[e + 2], s2);
          s3 = fmaf(qv.w, kf[e + 3], s3);
        }
      }
      const float s = (s0 + s1) + (s2 + s3);
      bool keep = kpos <= qpos;
      if (a.has_window) keep &= kpos > qpos - a.window;
      ps[i] = keep ? s : NEG;
    }
    __syncthreads();

    heads_softmax(ps, m, l, alpha, G);
    __syncthreads();

    // acc = acc * alpha + P V, (head, column) pairs
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const int c = i - g * D;
      const float* pg = ps + g * BK;
      float x = 0.f;
#pragma unroll 8
      for (int key = 0; key < BK; ++key)
        x = fmaf(pg[key], to_f32(vs[key * RS + c]), x);
      acc[i] = acc[i] * alpha[g] + x;
    }
  }
  __syncthreads();
  if (n_split == 1) {
    T* O = (T*)a.o + qrow * D;
    for (int i = tid; i < G * D; i += NT)
      O[i] = from_f32<T>(acc[i] / fmaxf(l[i / D], 1e-30f));
    if (a.lse != nullptr)
      for (int g = tid; g < G; g += NT)
        a.lse[qrow + g] = l[g] > 0.f ? m[g] + logf(l[g]) : -INFINITY;
  } else {
    const int W = D + 2;
    for (int i = tid; i < G * W; i += NT) {
      const int g = i / W;
      const int c = i - g * W;
      a.part[((qrow + g) * n_split + split) * W + c] =
          c < D ? acc[g * D + c] : (c == D ? m[g] : l[g]);
    }
  }
}

// ---------------------------------------------------------- the wide path ---
// Where the K/V ring (two stages of whole D-wide rows) and the group's fp32
// state do not fit the 227 KB a block may use (fp32 at D 256 and a group of
// 2, bf16 at D 512 and a group of 16), a block instead owns at most WG
// query heads of its KV head (the group split: ceil(G / WG) blocks a KV
// head) and WDV of O's columns (the column split: ceil(D / WDV) blocks),
// and streams K and V through a two-stage ring in 64-column slices: a tile
// is ceil(D / 64) K slices, each with the heads' q slice, then its columns'
// V slices.  Every (head, key) score is summed in the fast path's four
// chains in the same column order, so the column blocks' m and l agree bit
// for bit; each reads the tile's K again.  Shared memory: 62 KB in fp32,
// 46 KB in bf16, whatever G and D are.
constexpr int WG = 16;               // query heads a block owns at most
constexpr int WC = 64;               // columns of a K or V slice
constexpr int WDV = 256;             // O columns a block owns at most
constexpr int WR = WG * BK / NT;     // (head, key) pairs a thread

__host__ __device__ inline size_t wide_slice_bytes(int es) {
  return (size_t)BK * (WC * es + 16);
}
__host__ __device__ inline size_t wide_stage_bytes(int es) {
  return wide_slice_bytes(es) + sizeof(float) * WG * WC;   // + q slice
}
__host__ __device__ inline size_t wide_smem_bytes(int es) {
  return 2 * wide_stage_bytes(es) +
         sizeof(float) * ((size_t)WG * BK + (size_t)WG * WDV + 3 * WG);
}
// whether a launch takes the wide path: a two-stage ring and the group's
// state pass the 227 KB
__host__ __device__ inline bool wide(int group, int d, int es) {
  return smem_bytes(2, group, d, es) > MAX_SMEM;
}
// blocks a (batch, kv head) takes: 1 on the fast path
__host__ __device__ inline int blocks_per_head(int group, int d, int es) {
  return wide(group, d, es)
             ? ((group + WG - 1) / WG) * ((d + WDV - 1) / WDV) : 1;
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_wide(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = Chunk<T>::N;
  constexpr int RS = WC + N;             // slice row stride: 16 bytes padding
  const size_t stage = wide_stage_bytes(sizeof(T));
  float* ps = reinterpret_cast<float*>(smem + 2 * stage);   // [WG][BK]
  float* acc = ps + WG * BK;                                // [WG][WDV]
  float* m = acc + WG * WDV;
  float* l = m + WG;
  float* alpha = l + WG;

  const int D = a.d;
  const int tid = threadIdx.x;
  const int n_g = (a.group + WG - 1) / WG;
  const int b = blockIdx.x / (a.hkv * n_g);
  const int rest = blockIdx.x - b * a.hkv * n_g;
  const int kvh = rest / n_g;
  const int g0 = (rest - kvh * n_g) * WG;
  const int G = min(WG, a.group - g0);   // this block's heads
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int c0 = blockIdx.z * WDV;
  const int nv = min(WDV, D - c0);       // this block's columns
  const long long qrow = (long long)b * a.hq + (long long)kvh * a.group + g0;
  const T* Q = (const T*)a.q + qrow * D;
  const T* K = (const T*)a.k + b * a.sb + kvh * a.sh;
  const T* V = (const T*)a.v + b * a.sb + kvh * a.sh;

  const int qpos = a.kv_len - 1;
  const int t0 = a.t_first + split * a.tiles_per_split;
  const int t1 = min(t0 + a.tiles_per_split, qpos / BK + 1);   // [t0, t1)
  const int nkc = (D + WC - 1) / WC;     // K slices a tile
  const int per_tile = nkc + (nv + WC - 1) / WC;
  const int n_steps = (t1 - t0) * per_tile;

  // step i's slice into ring stage i & 1 (keys at or past kv_len and
  // columns at or past D read as zeros); a K slice also brings the heads'
  // q slice, scaled, as fp32
  auto load_step = [&](int i) {
    unsigned char* st = smem + (i & 1) * stage;
    T* kv = reinterpret_cast<T*>(st);
    float* qsl = reinterpret_cast<float*>(st + wide_slice_bytes(sizeof(T)));
    const int tt = i / per_tile;
    const int j = i - tt * per_tile;
    const int k0 = (t0 + tt) * BK;
    const bool is_k = j < nkc;
    const int col = is_k ? j * WC : c0 + (j - nkc) * WC;
    const T* src = is_k ? K : V;
    if (a.vec) {
      constexpr int PER = WC / N;
      for (int x = tid; x < BK * PER; x += NT) {
        const int r = x / PER;
        const int c = (x - r * PER) * N;
        const bool in = k0 + r < a.kv_len && col + c < D;
        const long long off = in ? (long long)(k0 + r) * a.ss + col + c : 0;
        cp_async16(smem_addr(kv + r * RS + c), src + off, in);
      }
    } else {
      for (int x = tid; x < BK * WC; x += NT) {
        const int r = x / WC;
        const int c = x - r * WC;
        const bool in = k0 + r < a.kv_len && col + c < D;
        kv[r * RS + c] = in ? src[(long long)(k0 + r) * a.ss + col + c]
                            : from_f32<T>(0.f);
      }
    }
    if (is_k)
      for (int x = tid; x < WG * WC; x += NT) {
        const int g = x / WC;
        const int c = x - g * WC;
        qsl[x] = g < G && col + c < D
                     ? to_f32(Q[(long long)g * D + col + c]) * a.scale
                     : 0.f;
      }
  };

  for (int x = tid; x < WG * WDV; x += NT) acc[x] = 0.f;
  for (int g = tid; g < WG; g += NT) {
    m[g] = NEG;
    l[g] = 0.f;
  }
  float sc[WR][4];
  if (n_steps > 0) load_step(0);
  cp_async_commit();
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait(0);                    // step i landed (this thread's part)
    __syncthreads();                     // ... every thread's; stage i ^ 1
                                         // is free
    if (i + 1 < n_steps) load_step(i + 1);
    cp_async_commit();
    const unsigned char* st = smem + (i & 1) * stage;
    const T* kv = reinterpret_cast<const T*>(st);
    const float* qsl =
        reinterpret_cast<const float*>(st + wide_slice_bytes(sizeof(T)));
    const int tt = i / per_tile;
    const int j = i - tt * per_tile;
    if (j < nkc) {
      // the (head, key) pairs' four chains over the slice's columns
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        if (j == 0) sc[r][0] = sc[r][1] = sc[r][2] = sc[r][3] = 0.f;
        const int x = tid + r * NT;
        const int g = x / BK;
        const int key = x - g * BK;
        if (g >= G) continue;
        const float* qg = qsl + g * WC;
        const T* kr = kv + key * RS;
#pragma unroll
        for (int c = 0; c < WC; c += N) {
          float kf[N];
          Chunk<T>::get(kr + c, kf);
#pragma unroll
          for (int e = 0; e < N; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + c + e);
            sc[r][0] = fmaf(qv.x, kf[e], sc[r][0]);
            sc[r][1] = fmaf(qv.y, kf[e + 1], sc[r][1]);
            sc[r][2] = fmaf(qv.z, kf[e + 2], sc[r][2]);
            sc[r][3] = fmaf(qv.w, kf[e + 3], sc[r][3]);
          }
        }
      }
      if (j == nkc - 1) {                // the tile's scores are whole
        const int k0 = (t0 + tt) * BK;
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const int x = tid + r * NT;
          const int g = x / BK;
          const int kpos = k0 + x - g * BK;
          if (g >= G) continue;
          const float sv = (sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3]);
          bool keep = kpos <= qpos;
          if (a.has_window) keep &= kpos > qpos - a.window;
          ps[x] = keep ? sv : NEG;
        }
        __syncthreads();
        heads_softmax(ps, m, l, alpha, G);
        __syncthreads();
      }
    } else {
      // acc = acc * alpha + P V over the slice's columns
      const int cv = (j - nkc) * WC;
      for (int x = tid; x < G * WC; x += NT) {
        const int g = x / WC;
        const int c = x - g * WC;
        if (cv + c >= nv) continue;
        const float* pg = ps + g * BK;
        float y = 0.f;
#pragma unroll 8
        for (int key = 0; key < BK; ++key)
          y = fmaf(pg[key], to_f32(kv[key * RS + c]), y);
        float* ac = acc + g * WDV + cv + c;
        *ac = *ac * alpha[g] + y;
      }
    }
  }
  __syncthreads();
  if (n_split == 1) {
    T* O = (T*)a.o + qrow * D + c0;
    for (int x = tid; x < G * nv; x += NT) {
      const int g = x / nv;
      const int c = x - g * nv;
      O[(long long)g * D + c] =
          from_f32<T>(acc[g * WDV + c] / fmaxf(l[g], 1e-30f));
    }
    if (a.lse != nullptr && blockIdx.z == 0)
      for (int g = tid; g < G; g += NT)
        a.lse[qrow + g] = l[g] > 0.f ? m[g] + logf(l[g]) : -INFINITY;
  } else {
    const int W = D + 2;
    for (int x = tid; x < G * nv; x += NT) {
      const int g = x / nv;
      const int c = x - g * nv;
      a.part[((qrow + g) * n_split + split) * W + c0 + c] = acc[g * WDV + c];
    }
    if (blockIdx.z == 0)
      for (int g = tid; g < G; g += NT) {
        float* pr = a.part + ((qrow + g) * n_split + split) * W + D;
        pr[0] = m[g];
        pr[1] = l[g];
      }
  }
}

// O[row, c] from the splits' (acc, m, l): one thread per output element
template <typename T>
__global__ void __launch_bounds__(NT) decode_combine(const float* part, T* o,
                                                     float* lse, int rows,
                                                     int n_split, int d) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= rows * d) return;
  const int row = i / d;
  const int c = i - row * d;
  const int W = d + 2;
  const float* p = part + (long long)row * n_split * W;
  float ms = NEG;
  for (int s = 0; s < n_split; ++s) ms = fmaxf(ms, p[s * W + d]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(p[s * W + d] - ms);
    num = fmaf(w, p[s * W + c], num);
    den = fmaf(w, p[s * W + d + 1], den);
  }
  o[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
  if (lse != nullptr && c == 0)
    lse[row] = den > 0.f ? ms + logf(den) : -INFINITY;
}

template <typename T>
cudaError_t launch(Args a, int batch, int n_split, cudaStream_t stream) {
  cudaError_t err;
  if (!wide(a.group, a.d, sizeof(T))) {
    // the deepest ring (up to the split's tile count) that fits
    int stages = a.tiles_per_split < 2 ? 2
                 : a.tiles_per_split > MAX_STAGES ? MAX_STAGES
                                                  : a.tiles_per_split;
    while (stages > 2 &&
           smem_bytes(stages, a.group, a.d, sizeof(T)) > MAX_SMEM)
      --stages;
    const size_t bytes = smem_bytes(stages, a.group, a.d, sizeof(T));
    a.stages = stages;
    // The limit is a per-device attribute: set it on every launch (cheap)
    // so that a launch on any card of the process may use it.
    err = cudaFuncSetAttribute(decode_split<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    decode_split<T><<<dim3(batch * a.hkv, n_split), NT, bytes, stream>>>(a);
  } else {
    const size_t bytes = wide_smem_bytes(sizeof(T));
    err = cudaFuncSetAttribute(decode_wide<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(batch * a.hkv * ((a.group + WG - 1) / WG), n_split,
                    (a.d + WDV - 1) / WDV);
    decode_wide<T><<<grid, NT, bytes, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int rows = batch * a.hq;
  decode_combine<T><<<(rows * a.d + NT - 1) / NT, NT, 0, stream>>>(
      a.part, (T*)a.o, a.lse, rows, n_split, a.d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks a launch with these dimensions gives each (batch, kv head) for
// each split: 1 where a two-stage ring of whole rows and the group's state
// fit the 227 KB a block may use, else the wide path's group and column
// blocks.  The wrapper plans the splits over that many blocks.
int decode_attention_blocks(int group, int d, int is_bf16) {
  return blocks_per_head(group, d, is_bf16 ? 2 : 4);
}

// q, o: (batch, hq, d) contiguous; k, v: (batch, hkv, s, d) with element
// strides sb, sh, ss and unit stride on d, the same for both; fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); hq a multiple of hkv; d a multiple
// of 8; 1 <= kv_len <= s; window >= 1, read only when has_window.  vec = 1
// when d and the strides are multiples of 16 bytes and k and v start on
// 16 bytes.  The split plan: the keys [lo, kv_len) (lo = kv_len - window,
// at least 0) lie in tiles t_first = lo / 64 .. (kv_len - 1) / 64; split s
// takes tiles_per_split of them from t_first + s * tiles_per_split, and
// none is empty.  part: fp32 (batch, hq, n_split, d + 2), read only when
// n_split > 1.  lse: fp32 (batch, hq), written when not null.  Launches on `stream` (a second kernel combines the
// splits when n_split > 1) and returns cudaGetLastError() (0 when taken).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* part, int batch,
                            int hq, int hkv,
                            int s, int d, long long sb, long long sh,
                            long long ss, int kv_len, int has_window,
                            int window, float scale, int is_bf16, int vec,
                            int t_first, int tiles_per_split, int n_split,
                            void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d % 8 != 0 || kv_len < 1 ||
      kv_len > s || (has_window && window < 1))
    return (int)cudaErrorInvalidValue;
  const int lo = has_window && kv_len - window > 0 ? kv_len - window : 0;
  const int t_last = (kv_len - 1) / BK;
  if (t_first != lo / BK || tiles_per_split < 1 || n_split < 1 ||
      n_split >= 65536 ||
      t_first + (n_split - 1) * tiles_per_split > t_last ||
      t_first + n_split * tiles_per_split <= t_last ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, (float*)lse, (float*)part, hq, hkv, hq / hkv, d,
         kv_len, sb, sh,
         ss, has_window, window, vec, 2, t_first, tiles_per_split, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(a, batch, n_split, st)
                       : launch<float>(a, batch, n_split, st));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
