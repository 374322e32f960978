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
// registers.  Like the TPU kernel both designs below skip KV tiles that no
// (query, key) pair of the block can use (beyond Skv, after the causal
// diagonal, before the window), mask scores with the finite -1e30 (never
// -inf: a row whose scores in one tile are all masked would compute -inf -
// -inf = NaN; with -1e30 the next real tile's alpha = exp(-1e30 - m) = 0
// wipes that tile's contribution), and clamp the final l to 1e-30.  Ragged
// Sq and Skv are masked in the kernel: nothing is padded; out-of-range K
// and V rows are read as zeros.
//
// Bound on an H100 SXM: 4 * B * Hq * Sq * Skv * D / 2 flops for a causal
// run (two products, half the score matrix), against 989 TFLOP/s of bf16
// tensor cores; at B 4 x Hq 24 x S 2048 x D 64 that is 51.5 GFLOP, 52 us,
// while Q, K, V and O move 67 MB (20 us at 3.35 TB/s): operations bound.
//
// The kernel is picked by dtype.
//
// bf16: tensor cores (flash_fwd_bf16).  A block of 4 warps takes 64 query
// rows of one (batch, head), 16 rows a warp; the warp's Q fragments are
// loaded once (ldmatrix) and stay in registers for the whole KV walk.  K
// and V tiles of 64 keys arrive as bf16 by 16-byte cp.async.cg copies into
// a two-stage ring, so tile t+1 loads while tile t computes (one barrier a
// tile); rows are padded by 16 bytes, which puts the 8 rows of every
// ldmatrix on distinct banks.  S = Q K^T is mma.sync m16n8k16 (bf16 in,
// fp32 sums); the scale (times log2 e) multiplies the fp32 scores, never a
// bf16 copy of Q, and the online softmax (exp2) stays in registers, rows
// reduced over the quad of lanes that share them.  P is rounded to bf16 in
// registers and is the A operand of the P V mma.sync as it stands: the
// m16n8 accumulator layout of two neighbouring key tiles is the m16n8k16 A
// layout, so P never touches shared memory; V fragments come from
// ldmatrix.trans.  l sums the fp32 P.  Causal launches put the last
// (heaviest) query tiles first, so the tail of the grid is short.  The
// output goes through the warp's own Q rows of shared memory and out in
// 16-byte stores.  Rounding P to bf16 is what sets the tolerance: an
// output errs by about 2^-8 (P V)/l on top of its own rounding
// (chip_smoke.py phase 2 and tests/test_torch_cuda.py state the gate).
// Measured by chip_smoke.py on one H100 80GB HBM3 at 700 W, at the shape
// above: 0.231 ms (223 TFLOP/s, 23% of the bound's rate), against 0.142 ms
// for PyTorch's SDPA.  mma.sync is expected to reach about 2/3 of the
// wgmma rate on this card; wgmma with TMA loads and a warp-specialised
// producer is the next step.
//
// fp32: CUDA cores (flash_fwd_f32), the simple design.  No bf16 or TF32
// tensor-core product holds fp32's 2e-5 tolerance, so fp32 keeps it: a
// block of 256 threads takes 64 query rows; each thread owns 4 rows x 4
// keys of each 64 x 64 score tile and 4 rows x D/16 output columns (rows
// ty + 16 i, columns tx + 16 j, so a warp reads its K and V columns from
// 16 distinct banks).  Q (pre-scaled), K and V tiles sit in shared memory
// as fp32 (stride D + 1 for Q and K); the probability tile P goes through
// shared memory between the two products.
//
// Head dims: any, as the Pallas kernel takes.  Both designs are built for
// every multiple of 16 up to 128 (16, 32, 48, 64, 80, 96, 112, 128) and for
// 192 and 256; the wrapper zero-pads any other D up to 256 to the next of
// them, and any D above 256 to a multiple of 16, which the column split
// below runs.  Nothing in either design needs a power of two: bf16 takes
// D / 16 k-steps of Q K^T (5 at D 80, 7 at D 112), each one ldmatrix.x4 of
// Q and one of K per pair of 8-key column tiles, and D / 16
// ldmatrix.x4.trans of V per 16 keys, each feeding two 8-column tiles of O
// (10 at D 80); rows of D / 8 16-byte chunks at a stride of D + 8
// elements, 2 D + 16 bytes: D / 8 + 1 16-byte groups, odd at every such D
// (7 at D 48, 11 at D 80, 13 at D 96; 3 to 33 from D 16 to 256), so the 8
// rows of an ldmatrix, an odd number of groups apart modulo the 8 groups of
// a 128-byte bank line, start on 8 distinct groups.  fp32 takes D / 16
// output columns a thread (5 at D 80).  At D 192 and 256 the bf16 kernel
// keeps O (D / 2 fp32 registers a thread) but not Q in registers: each
// k-step reads the warp's Q fragment from shared memory again.
//
// Above 256 (the *_cols kernels) the grid's third axis splits O's columns,
// 128 a block: every block of a query tile computes the whole S = Q K^T of
// each KV tile, streaming Q and K through shared memory in 64-column
// slices in one fixed order, so the blocks' m and l agree bit for bit, and
// multiplies P by its own 128 columns of V.  S is computed ceil(D / 128)
// times over; registers and shared memory stay those of D 128 whatever D
// is.
//
// Statistics and accumulators are fp32 in both; the output is rounded to
// the input type once.  Shared memory: bf16 640 (D + 8) bytes, 15-169 KB
// (56 KB at D 80), 36 KB split; fp32 256 (3 D + 67) bytes, 29-214 KB (79
// KB at D 80), 81 KB split; so the launch raises the block's limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// ---------------------------------------------------------------- fp32 ---
namespace f32 {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads per block, a 16 x 16 grid
constexpr int RPT = BQ / 16;  // score rows per thread
constexpr int CPT = BK / 16;  // score columns per thread

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

constexpr int PS = BK + 1;     // row stride of the P tile

// s += Q K^T over N columns of the Q and K tiles (row stride QS) in shared
// memory, in column order: this thread's rows ty + 16 i, keys tx + 16 j
template <int N, int QS>
__device__ __forceinline__ void qk(float (&s)[RPT][CPT], const float* qs,
                                   const float* ks, int tx, int ty) {
#pragma unroll 8
  for (int d = 0; d < N; ++d) {
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
}

// The mask and the online softmax of the key tile at k_start (P through
// ps), then acc += P V over this thread's DPT columns tx + 16 j of the V
// tile (row stride VS); a block-wide barrier between the two
template <int DPT, int VS>
__device__ __forceinline__ void softmax_pv(float (&s)[RPT][CPT],
                                           float (&m)[RPT], float (&l)[RPT],
                                           float (&acc)[RPT][DPT], float* ps,
                                           const float* vs, const Args& a,
                                           int q_start, int k_start, int tx,
                                           int ty) {
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
    for (int j = 0; j < DPT; ++j) vv[j] = vs[c * VS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32(Args a) {
  constexpr int QS = D + 1;      // row stride of the Q and K tiles
  constexpr int DPT = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][QS], scaled
  float* ks = qs + BQ * QS;      // [BK][QS]
  float* vs = ks + BK * QS;      // [BK][D]
  float* ps = vs + BK * D;       // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;               // b * Hq + h
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  const long long kvh = (long long)b * a.hkv + h / a.group;
  const float* Q = (const float*)a.q + (long long)bh * a.sq * D;
  const float* K = (const float*)a.k + kvh * a.skv * D;
  const float* V = (const float*)a.v + kvh * a.skv * D;
  float* O = (float*)a.o + (long long)bh * a.sq * D;

  const int q0 = blockIdx.y * BQ;          // first q row of the block
  const int q_start = q0 + a.q_offset;     // its position among the keys

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    const float x = q0 + r < a.sq ? Q[(long long)(q0 + r) * D + c] : 0.f;
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
      ks[r * QS + c] = in ? K[g] : 0.f;
      vs[r * D + c] = in ? V[g] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    qk<D, QS>(s, qs, ks, tx, ty);
    softmax_pv<DPT, D>(s, m, l, acc, ps, vs, a, q_start, k_start, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      O[(long long)r * D + tx + 16 * j] = acc[i][j] / li;
  }
}

// ------------------------------------------------ column split, D > 256 ---
constexpr int KC = 64;     // columns of a Q and a K slice
constexpr int DV = 128;    // columns of O a block owns

constexpr size_t cols_smem_bytes() {
  return sizeof(float) *
         (BQ * (KC + 1) + BK * (KC + 1) + BK * DV + BQ * (BK + 1));
}

// Any D: block (bh, query tile, z) owns O's columns [z DV, z DV + DV).
// Every block of a query tile sums each score over d = 0 .. D - 1 in the
// same order, through 64-column slices of Q (scaled) and K in shared
// memory, so its m and l are the other blocks' bit for bit; then P times
// its own 128 columns of V.  Shared memory 81 KB whatever D is.
__global__ void __launch_bounds__(NT) flash_fwd_f32_cols(Args a, int d) {
  constexpr int QS = KC + 1;     // row stride of the Q and K slices
  constexpr int DPT = DV / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][QS], scaled
  float* ks = qs + BQ * QS;      // [BK][QS]
  float* vs = ks + BK * QS;      // [BK][DV]
  float* ps = vs + BK * DV;      // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  const int c0 = blockIdx.z * DV;
  const long long kvh = (long long)b * a.hkv + h / a.group;
  const float* Q = (const float*)a.q + (long long)bh * a.sq * d;
  const float* K = (const float*)a.k + kvh * a.skv * d;
  const float* V = (const float*)a.v + kvh * a.skv * d;
  float* O = (float*)a.o + (long long)bh * a.sq * d;
  const int q0 = blockIdx.y * BQ;
  const int q_start = q0 + a.q_offset;

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
    bool relevant = true;
    if (a.causal) relevant &= k_start <= q_start + BQ - 1;
    if (a.has_window) relevant &= k_start + BK - 1 > q_start - a.window;
    if (!relevant) continue;               // uniform across the block

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c1 = 0; c1 < d; c1 += KC) {
      __syncthreads();                     // the last slice's readers (and
                                           // the last tile's) are done
      for (int i = tid; i < BQ * KC; i += NT) {
        const int r = i / KC;
        const int c = i - r * KC;
        const bool in = q0 + r < a.sq && c1 + c < d;
        qs[r * QS + c] =
            in ? Q[(long long)(q0 + r) * d + c1 + c] * a.scale : 0.f;
        const bool kin = k_start + r < a.skv && c1 + c < d;
        ks[r * QS + c] = kin ? K[(long long)(k_start + r) * d + c1 + c] : 0.f;
      }
      if (c1 == 0)
        for (int i = tid; i < BK * DV; i += NT) {
          const int r = i / DV;
          const int c = i - r * DV;
          const bool in = k_start + r < a.skv && c0 + c < d;
          vs[i] = in ? V[(long long)(k_start + r) * d + c0 + c] : 0.f;
        }
      __syncthreads();
      qk<KC, QS>(s, qs, ks, tx, ty);
    }
    softmax_pv<DPT, DV>(s, m, l, acc, ps, vs, a, q_start, k_start, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) O[(long long)r * d + c] = acc[i][j] / li;
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------- bf16 ---
namespace bf16 {

constexpr int BQ = 64;        // query rows per block, 16 a warp
constexpr int BK = 64;        // keys per KV tile
constexpr int NW = BQ / 16;   // warps per block
constexpr int NT = 32 * NW;
constexpr int PAD = 8;        // bf16 elements (16 bytes) of row padding
constexpr float LOG2E = 1.4426950408889634f;

using bf = __nv_bfloat16;

template <int D>
constexpr size_t smem_bytes() {   // Q, and two stages of K and of V
  return sizeof(bf) * (size_t)(BQ + 4 * BK) * (D + PAD);
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL_MASK, x, 1);
  return x + __shfl_xor_sync(FULL_MASK, x, 2);
}

// rows [row0, row0 + rows) of a (n, D) bf16 matrix into shared memory
// (row stride D + PAD) by 16-byte cp.async; rows at or past n read zeros
template <int D>
__device__ __forceinline__ void load_rows(bf* dst, const bf* src, int row0,
                                          int rows, int n) {
  constexpr int CH = D / 8;        // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool in = row0 + r < n;
    const bf* g = src + (long long)(in ? row0 + r : 0) * D + c;
    cp_async16(smem_addr(dst + r * (D + PAD) + c), g, in);
  }
}

constexpr int NS = BK / 8;     // 8-key column tiles of S

// S (the warp's 16 rows x 64 keys) += one 16-column k-step: ``qa`` the
// step's Q fragment, ``kst`` the step's first column of the K tile (row
// stride RS)
template <int RS>
__device__ __forceinline__ void qk_step(float (&s)[NS][4], const uint32_t* qa,
                                        const bf* kst, int lane) {
#pragma unroll
  for (int np = 0; np < NS / 2; ++np) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(smem_addr(kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                      ((lane >> 3) & 1) * 8),
            b0, b1, b2, b3);
    mma(s[2 * np], qa, b0, b1);
    mma(s[2 * np + 1], qa, b2, b3);
  }
}

// The mask (only on tiles that cross an edge of it) and the online softmax
// of the key tile at k_start: the scale enters exp2's argument, p = 2^(s
// sl2 - m sl2), one fma; m, l and o are updated and s holds P (fp32)
template <int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4],
                                               float (&o)[NO][4],
                                               float (&m)[2], float (&l)[2],
                                               const Args& a, int k_start,
                                               int q_start, int qpos0,
                                               int tig, float sl2) {
  const bool full =
      k_start + BK <= a.skv && (!a.causal || k_start + BK - 1 <= q_start) &&
      (!a.has_window || k_start > q_start + BQ - 1 - a.window);
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sl2;
      if (!full) {
        const int kpos = k_start + j * 8 + 2 * tig + (e & 1);
        const int qpos = qpos0 + (e >> 1) * 8;
        bool keep = kpos < a.skv;
        if (a.causal) keep &= kpos <= qpos;
        if (a.has_window) keep &= kpos > qpos - a.window;
        x = keep ? x : NEG;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// O (the warp's 16 rows x 8 NO columns) += P V: P (bf16, in registers) is
// the A operand, V (64 keys, row stride RS) by ldmatrix.trans
template <int RS, int NO>
__device__ __forceinline__ void pv(const float (&s)[NS][4], float (&o)[NO][4],
                                   const bf* vst, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                            pack(s[2 * kk][2], s[2 * kk][3]),
                            pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(smem_addr(vst + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * RS +
                              dp * 16 + (lane >> 4) * 8),
                    b0, b1, b2, b3);
      mma(o[2 * dp], pa, b0, b1);
      mma(o[2 * dp + 1], pa, b2, b3);
    }
  }
}

// The KV tiles [t_lo, t_hi] that some (q, k) pair of the query tile whose
// row 0 sits at key position q_start can use (beyond Skv, after the
// causal diagonal and before the window none can)
__device__ __forceinline__ void kv_tiles(const Args& a, int q_start,
                                         int& t_lo, int& t_hi) {
  t_hi = (a.skv + BK - 1) / BK - 1;
  if (a.causal) {
    const int last = q_start + BQ - 1;
    t_hi = min(t_hi, last >= 0 ? last / BK : -1);
  }
  t_lo = 0;
  if (a.has_window) {
    const int x = q_start - a.window - BK + 2;   // k_start + BK - 1 > q - w
    if (x > 0) t_lo = (x + BK - 1) / BK;
  }
}

// O / l for the warp's 16 rows and 8 NO columns, through the warp's own
// rows of shared memory (ow, row stride RS) and out in 16-byte stores to
// O (row stride ld, its column col0 first), rows below sq and columns
// below d only
template <int RS, int NO>
__device__ __forceinline__ void store_o(const float (&o)[NO][4],
                                        const float (&l)[2], bf* ow, bf* O,
                                        int ld, int row0, int sq, int col0,
                                        int d, int lane) {
  const int g = lane >> 2;
  const int tig = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(ow + g * RS + c) =
        pack(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * RS + c) =
        pack(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NO; i += 32) {
    const int r = i / NO;
    const int c = (i - r * NO) * 8;
    if (row0 + r < sq && col0 + c < d)
      *reinterpret_cast<uint4*>(O + (long long)(row0 + r) * ld + col0 + c) =
          *reinterpret_cast<const uint4*>(ow + r * RS + c);
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_bf16(Args a) {
  constexpr int RS = D + PAD;      // shared-memory row stride
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int NO = D / 8;        // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* qs = reinterpret_cast<bf*>(smem_raw);    // [BQ][RS]
  bf* ks = qs + BQ * RS;                       // [2][BK][RS]
  bf* vs = ks + 2 * BK * RS;                   // [2][BK][RS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;                   // b * Hq + h
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  // causal: the last, heaviest query tiles first
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const long long kvh = (long long)b * a.hkv + h / a.group;
  const bf* Q = (const bf*)a.q + (long long)bh * a.sq * D;
  const bf* K = (const bf*)a.k + kvh * a.skv * D;
  const bf* V = (const bf*)a.v + kvh * a.skv * D;
  bf* O = (bf*)a.o + (long long)bh * a.sq * D;
  const int q0 = qt * BQ;
  const int q_start = q0 + a.q_offset;         // key position of q row q0

  int t_lo, t_hi;
  kv_tiles(a, q_start, t_lo, t_hi);

  load_rows<D>(qs, Q, q0, BQ, a.sq);
  if (t_lo <= t_hi) {
    load_rows<D>(ks, K, t_lo * BK, BK, a.skv);
    load_rows<D>(vs, V, t_lo * BK, BK, a.skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the warp's 16 query rows as m16n8k16 A fragments: up to D 128 loaded
  // once for the whole walk; above, KD x 4 registers would crowd out O's
  // D / 2, so each k-step reads its fragment from shared memory again
  constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                        (lane >> 4) * 8),
              qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }

  // this thread's rows of the warp's 16: g and g + 8; columns 2 * tig + {0,1}
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int qpos0 = q_start + warp * 16 + g;
  const float sl2 = a.scale * LOG2E;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG, NEG};                     // running max, log2 units
  float l[2] = {0.f, 0.f};                     // this thread's partial sums

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t > t_lo) {
      cp_async_wait_all();     // tile t (issued last iteration) landed
      __syncthreads();         // ... for every thread; stage st ^ 1 is free
    }
    if (t < t_hi) {            // tile t + 1 loads while tile t computes
      load_rows<D>(ks + (st ^ 1) * BK * RS, K, (t + 1) * BK, BK, a.skv);
      load_rows<D>(vs + (st ^ 1) * BK * RS, V, (t + 1) * BK, BK, a.skv);
    }
    cp_async_commit();
    const bf* kst = ks + st * BK * RS;
    const bf* vst = vs + st * BK * RS;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (!QREG)
        ldsm_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                          (lane >> 4) * 8),
                qf[0][0], qf[0][1], qf[0][2], qf[0][3]);
      qk_step<RS>(s, qf[QREG ? kk : 0], kst + kk * 16, lane);
    }

    online_softmax(s, o, m, l, a, t * BK, q_start, qpos0, tig, sl2);
    pv<RS>(s, o, vst, lane);
  }

  // through the warp's own 16 rows of qs: only this warp read them
  store_o<RS>(o, l, qs + warp * 16 * RS, O, D, q0 + warp * 16, a.sq, 0, D,
              lane);
}

// ------------------------------------------------ column split, D > 256 ---
constexpr int KC = 64;     // columns of a Q and a K slice
constexpr int DV = 128;    // columns of O a block owns
constexpr int SRS = KC + PAD;   // row strides: 9 and 17 16-byte groups, odd
constexpr int VRS = DV + PAD;
constexpr int STAGE = (BQ + BK) * SRS;   // elements: a Q and a K slice, or
                                         // a V slice (BK * VRS, fewer)

constexpr size_t cols_smem_bytes() { return sizeof(bf) * 2 * STAGE; }

// rows [row0, row0 + rows) x columns [col0, col0 + COLS) of an (n, ld) bf16
// matrix into shared memory (row stride COLS + PAD) by 16-byte cp.async;
// rows at or past n and columns at or past ld (a multiple of 8) read zeros
template <int COLS>
__device__ __forceinline__ void load_block(bf* dst, const bf* src, int ld,
                                           int row0, int rows, int n,
                                           int col0) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool in = row0 + r < n && col0 + c < ld;
    const bf* g = src + (in ? (long long)(row0 + r) * ld + col0 + c : 0);
    cp_async16(smem_addr(dst + r * (COLS + PAD) + c), g, in);
  }
}

// Any D (a multiple of 16): block (bh, query tile, z) owns O's columns
// [z DV, z DV + DV).  Every block of a query tile computes the whole S = Q
// K^T of each KV tile, streaming Q's and K's 64-column slices through a
// two-stage ring in the same order, so its m and l are the other blocks'
// bit for bit; then P times its own 128 columns of V.  A tile is d / 64
// slice steps and one V step, each one cp.async stage that loads while the
// step before it computes (one barrier a step).  Registers: O's 128
// columns (64 a thread) and S (32), whatever D is; shared memory 36 KB.
__global__ void __launch_bounds__(NT) flash_fwd_bf16_cols(Args a, int d) {
  constexpr int NO = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* ring = reinterpret_cast<bf*>(smem_raw);  // [2][STAGE]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.hq;
  const int h = bh - b * a.hq;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int c0 = blockIdx.z * DV;
  const long long kvh = (long long)b * a.hkv + h / a.group;
  const bf* Q = (const bf*)a.q + (long long)bh * a.sq * d;
  const bf* K = (const bf*)a.k + kvh * a.skv * d;
  const bf* V = (const bf*)a.v + kvh * a.skv * d;
  bf* O = (bf*)a.o + (long long)bh * a.sq * d;
  const int q0 = qt * BQ;
  const int q_start = q0 + a.q_offset;

  int t_lo, t_hi;
  kv_tiles(a, q_start, t_lo, t_hi);
  const int nkc = (d + KC - 1) / KC;           // slice steps a tile
  const int per_tile = nkc + 1;                // ... and its V step
  const int n_steps = t_lo <= t_hi ? (t_hi - t_lo + 1) * per_tile : 0;

  // step i's operands into ring stage i & 1
  auto load_step = [&](int i) {
    bf* st = ring + (i & 1) * STAGE;
    const int tt = i / per_tile;
    const int j = i - tt * per_tile;
    const int k0 = (t_lo + tt) * BK;
    if (j < nkc) {
      load_block<KC>(st, Q, d, q0, BQ, a.sq, j * KC);
      load_block<KC>(st + BQ * SRS, K, d, k0, BK, a.skv, j * KC);
    } else {
      load_block<DV>(st, V, d, k0, BK, a.skv, c0);
    }
  };

  const int g = lane >> 2;
  const int tig = lane & 3;
  const int qpos0 = q_start + warp * 16 + g;
  const float sl2 = a.scale * LOG2E;
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  float s[NS][4];

  if (n_steps > 0) load_step(0);
  cp_async_commit();
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();       // step i landed
    __syncthreads();           // ... for every thread; stage i ^ 1 is free
    if (i + 1 < n_steps) load_step(i + 1);
    cp_async_commit();
    const bf* st = ring + (i & 1) * STAGE;
    const int tt = i / per_tile;
    const int j = i - tt * per_tile;
    if (j < nkc) {             // S += Q[:, slice] K[:, slice]^T
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(smem_addr(st + (warp * 16 + (lane & 15)) * SRS + kk * 16 +
                          (lane >> 4) * 8),
                qa[0], qa[1], qa[2], qa[3]);
        qk_step<SRS>(s, qa, st + BQ * SRS + kk * 16, lane);
      }
    } else {                   // the softmax, then O += P V[:, cols]
      online_softmax(s, o, m, l, a, (t_lo + tt) * BK, q_start, qpos0, tig,
                     sl2);
      pv<VRS>(s, o, st, lane);
    }
  }

  // through the ring, once every warp is past its last read of it; the
  // block's columns below d
  cp_async_wait_all();
  __syncthreads();
  store_o<VRS>(o, l, ring + warp * 16 * VRS, O, d, q0 + warp * 16, a.sq, c0,
               d, lane);
}

}  // namespace bf16

template <int D, bool IS_BF16>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int BQ = IS_BF16 ? bf16::BQ : f32::BQ;
  constexpr int NT = IS_BF16 ? bf16::NT : f32::NT;
  constexpr size_t bytes =
      IS_BF16 ? bf16::smem_bytes<D>() : f32::smem_bytes<D>();
  void (*kernel)(Args) = IS_BF16 ? bf16::flash_fwd_bf16<D>
                                 : f32::flash_fwd_f32<D>;
  // The limit is a per-device attribute: set it on every launch (cheap)
  // so that a launch on any card of the process may use it.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + BQ - 1) / BQ);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// D above 256: the column split, ceil(d / 128) blocks across O's columns
template <bool IS_BF16>
cudaError_t launch_cols(const Args& a, int batch, int d,
                        cudaStream_t stream) {
  constexpr int BQ = IS_BF16 ? bf16::BQ : f32::BQ;
  constexpr int NT = IS_BF16 ? bf16::NT : f32::NT;
  constexpr int DV = IS_BF16 ? bf16::DV : f32::DV;
  constexpr size_t bytes =
      IS_BF16 ? bf16::cols_smem_bytes() : f32::cols_smem_bytes();
  void (*kernel)(Args, int) = IS_BF16 ? bf16::flash_fwd_bf16_cols
                                      : f32::flash_fwd_f32_cols;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.sq + BQ - 1) / BQ, (d + DV - 1) / DV);
  kernel<<<grid, NT, bytes, stream>>>(a, d);
  return cudaGetLastError();
}

template <bool IS_BF16>
cudaError_t launch_dim(const Args& a, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, IS_BF16>(a, batch, s);
    case 32: return launch<32, IS_BF16>(a, batch, s);
    case 48: return launch<48, IS_BF16>(a, batch, s);
    case 64: return launch<64, IS_BF16>(a, batch, s);
    case 80: return launch<80, IS_BF16>(a, batch, s);
    case 96: return launch<96, IS_BF16>(a, batch, s);
    case 112: return launch<112, IS_BF16>(a, batch, s);
    case 128: return launch<128, IS_BF16>(a, batch, s);
    case 192: return launch<192, IS_BF16>(a, batch, s);
    case 256: return launch<256, IS_BF16>(a, batch, s);
    default:
      return d > 256 && d % 16 == 0 ? launch_cols<IS_BF16>(a, batch, d, s)
                                    : cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (batch, hq, sq, d); k, v: (batch, hkv, skv, d); o like q; all
// contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1, and every pointer
// on 16 bytes); d a multiple of 16 up to 128, 192, 256, or a multiple of
// 16 above 256; hq a multiple of hkv; ceil(sq / 64) < 65536.  window is read only when has_window.  Launches on
// `stream` and returns cudaGetLastError() (0 when taken).
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
  return (int)(is_bf16 ? launch_dim<true>(a, batch, d, s)
                       : launch_dim<false>(a, batch, d, s));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
