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
//
// Bound on an H100 SXM: the function reads G*M*B + T*(G+M+B) bytes and
// writes 4T; its dense work is 2*T*G*M*B operations on 0/1 operands.  At
// the MovieLens-1M shape (T = 356,877, G x M x B = 6,040 x 3,952 x 5) that
// is 3.69 GB (1.10 ms at 3.35 TB/s) against 8.52e13 operations (43.0 ms at
// the 1,979 TOP/s int8 tensor-core rate, which computes 0/1 products with
// int32 sums exactly): operation bound.
//
// Design: the same factoring as the TPU kernel, on the int8 tensor cores.
// With N = G*B columns n = g*B + b,
//   C[t, n] = sum_m Y[t,m] * I'[n,m]       (a T x M x N product)
//   num[t]  = sum_n C[t,n] * X[t,g(n)] * Z[t,b(n)]
// and C never leaves registers.
//   (1) td_image lays I out as the product's B operand: I' (Np, Kp) bytes,
//       K-major, I'[g*B + b][m] = I[g,m,b] != 0, with M rounded up to Kp (a
//       multiple of K_CHUNK) and N up to Np (a multiple of TILE_N), the
//       padding zero.  Y (T, M) is the A operand, read in place.  Both are
//       K-major: the "TN" layout that 8-bit mma.sync takes.
//   (2) td_tile: one block of 4 warps (2 along t, 2 along n) owns a 128 t x
//       128 n output tile; each warp a 64 x 64 sub-tile of 32 m16n8 int32
//       fragments (the accumulators take 128 of a thread's registers, so an
//       SM holds two such blocks).  The K loop walks 128-byte chunks of m
//       through a 3-stage cp.async.cg ring in shared memory (rows padded to
//       144 bytes, so the 8 row addresses of an ldmatrix phase fall on
//       distinct banks; 110,592 bytes a block); operands are loaded by
//       ldmatrix and multiplied by mma.sync m16n8k32 u8 x u8 -> s32.  Rows
//       t >= T and the K tail of Y are zero-filled by cp.async's src-size;
//       where M % 16 != 0 or Y's base is off 16 bytes, Y's chunks are
//       loaded by plain byte loads instead.  128-byte chunks halve the
//       barriers of 64-byte ones; a 256 x 128 tile of 8 warps would read
//       a quarter fewer operand bytes from L2 but fits one block an SM,
//       and a block waiting at its barrier then leaves the SM idle.
//   (3) The epilogue stages X[t-tile, the tile's g range] and Z[t-tile, the
//       tile's b range] in the ring's memory, weights each int32 fragment
//       element by X[t,g(n)] * Z[t,b(n)] (0 past N), reduces the weighted
//       values per row over the lane quad and the two n-warps in 64-bit, and
//       adds each row's sum with one 64-bit integer atomicAdd into a (T,)
//       uint64 scratch.  Integer sums are exact and their order does not
//       matter, so every run gives the same bits.
//   (4) td_finish converts the sums to float32, exact below 2^24.
// Blocks are rasterised in groups of GROUP_T = 16 t-tiles: block ids run
// over the 16 t-tiles of a group for one n-tile, then the next n-tile.  The
// blocks in flight then share about 16 Y panels and 16 I' panels of ~0.5
// MB each (at the MovieLens shape) in the 50 MB L2, so Y is read from
// device memory about once and I' (120 MB) once per group: about 22 GB,
// under the operation bound.
// Offsets are 64-bit: T*G and T*M pass 2^31 at the MovieLens shape.
// wgmma with TMA loads is the next step: mma.sync is expected to reach
// about two thirds of the tensor cores' rate.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_T = 128;        // rows t per block
constexpr int TILE_N = 128;        // columns n = g*B + b per block
constexpr int WARPS_T = TILE_T / 64;  // warps along t, 64 rows each
constexpr int WARPS_N = TILE_N / 64;  // warps along n, 64 columns each
constexpr int NT = 32 * WARPS_T * WARPS_N;  // threads per tile block
constexpr int K_CHUNK = 128;       // bytes of m per ring stage
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int ROW = K_CHUNK + 16;  // padded shared-memory row, bytes
constexpr int PIECES = K_CHUNK / 16;  // 16-byte pieces of a row's chunk
constexpr int GROUP_T = 16;        // t-tiles per raster group
constexpr int STAGE_BYTES = (TILE_T + TILE_N) * ROW;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 110,592
constexpr int AUX_TPB = 256;       // threads per block of the small passes
constexpr long long MAX_AUX_BLOCKS = 132LL * 64;

static_assert(2 * TILE_T * TILE_N + WARPS_N * TILE_T * 8 <= SMEM_BYTES,
              "the epilogue's staging fits in the ring");
static_assert(TILE_T * PIECES % NT == 0 && TILE_N * PIECES % NT == 0,
              "every thread copies whole pieces");

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), u8 in, s32 sums
__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// I (G, M, B) -> I' (n_pad, kp): one thread writes 16 bytes of one row.
__global__ void __launch_bounds__(AUX_TPB)
td_image(const uint8_t* __restrict__ tensor, uint8_t* __restrict__ image,
         int n_cols, int n_pad, int n_m, int n_b, int kp) {
  const int kw = kp / 16;
  const long long words = (long long)n_pad * kw;
  for (long long idx = (long long)blockIdx.x * AUX_TPB + threadIdx.x;
       idx < words; idx += (long long)gridDim.x * AUX_TPB) {
    const int n = (int)(idx / kw);
    const int m0 = (int)(idx - (long long)n * kw) * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (n < n_cols) {
      const int g = n / n_b;
      const int b = n - g * n_b;
      const uint8_t* src = tensor + ((long long)g * n_m + m0) * n_b + b;
      const int cnt = min(16, n_m - m0);
      for (int i = 0; i < cnt; ++i)
        if (__ldg(src + (long long)i * n_b) != 0)
          w[i >> 2] |= 1u << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(image + (long long)n * kp + m0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct TileArgs {
  const uint8_t* x;
  const uint8_t* y;
  const uint8_t* z;
  const uint8_t* image;
  unsigned long long* sums;
  long long n_t;
  int n_g, n_m, n_b, n_cols, kp, tiles_t, tiles_n;
};

// One K chunk of Y's tile (A) and I''s tile (B) into ring stage `st`.
// Piece p of a tile is row p / PIECES, bytes 16 * (p % PIECES) of the
// chunk.
template <bool ALIGNED>
__device__ __forceinline__ void load_chunk(const TileArgs& a, uint8_t* st,
                                           long long t0, long long n0,
                                           int k0) {
  uint8_t* as = st;
  uint8_t* bs = st + TILE_T * ROW;
#pragma unroll
  for (int i = 0; i < TILE_T * K_CHUNK / 16 / NT; ++i) {
    const int p = threadIdx.x + i * NT;
    const int r = p / PIECES;
    const int c = (p % PIECES) * 16;
    const long long t = t0 + r;
    const int k = k0 + c;
    if constexpr (ALIGNED) {   // M % 16 == 0: a piece is all in or all out
      const bool in = t < a.n_t && k < a.n_m;
      cp_async16(smem_addr(as + r * ROW + c),
                 in ? a.y + t * a.n_m + k : a.y, in);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (t < a.n_t) {
        const uint8_t* src = a.y + t * a.n_m + k;
        const int cnt = min(16, a.n_m - k);
        for (int j = 0; j < cnt; ++j)
          w[j >> 2] |= (uint32_t)__ldg(src + j) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(as + r * ROW + c) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < TILE_N * K_CHUNK / 16 / NT; ++i) {
    const int p = threadIdx.x + i * NT;
    const int r = p / PIECES;
    const int c = (p % PIECES) * 16;
    cp_async16(smem_addr(bs + r * ROW + c),
               a.image + (n0 + r) * a.kp + k0 + c, true);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(NT, 2) td_tile(const TileArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N;   // rows wm*64 .. +63 of the tile
  const int wn = warp % WARPS_N;   // columns wn*64 .. +63
  const int grp = lane >> 2;       // fragment row (and B column) in an 8
  const int tig = lane & 3;

  // raster order: GROUP_T t-tiles for each n-tile, then the next n-tile
  const long long pid = blockIdx.x;
  const long long per_group = (long long)GROUP_T * a.tiles_n;
  const long long group = pid / per_group;
  const int first = (int)(group * GROUP_T);
  const int gsize = min(a.tiles_t - first, GROUP_T);
  const int local = (int)(pid - group * per_group);
  const long long t0 = (long long)(first + local % gsize) * TILE_T;
  const long long n0 = (long long)(local / gsize) * TILE_N;
  const int chunks = a.kp / K_CHUNK;

  int acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_chunk<ALIGNED>(a, smem + s * STAGE_BYTES, t0, n0, s * K_CHUNK);
    cp_async_commit();
  }
  // ldmatrix lane addresses: matrix j = lane / 8, its row lane % 8
  const int lj = lane >> 3, lr = lane & 7;
  const int a_off = (wm * 64 + (lj & 1) * 8 + lr) * ROW + (lj >> 1) * 16;
  const int b_off = TILE_T * ROW + (wn * 64 + (lj >> 1) * 8 + lr) * ROW +
                    (lj & 1) * 16;
  const uint32_t smem0 = smem_addr(smem);
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<STAGES - 2>();   // chunk kc has landed
    __syncthreads();               // ... for every thread; kc-1 is consumed
    const int nk = kc + STAGES - 1;
    if (nk < chunks)
      load_chunk<ALIGNED>(a, smem + (nk % STAGES) * STAGE_BYTES, t0, n0,
                          nk * K_CHUNK);
    cp_async_commit();
    const uint32_t st = smem0 + (kc % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < K_CHUNK / 32; ++ks) {
      uint32_t af[4][4], bf[8][2];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
        ldsm_x4(st + a_off + mb * 16 * ROW + ks * 32, af[mb][0], af[mb][1],
                af[mb][2], af[mb][3]);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ldsm_x4(st + b_off + p * 16 * ROW + ks * 32, bf[2 * p][0],
                bf[2 * p][1], bf[2 * p + 1][0], bf[2 * p + 1][1]);
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          mma_u8(acc[mb][nb], af[mb], bf[nb][0], bf[nb][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free for the epilogue

  // Stage X[t-tile, g_lo .. g_lo + gcount) and Z[t-tile, b range]: the
  // tile's columns n0 .. n0 + 127 have g = n / B from g_lo on, and b =
  // n % B.  With B <= TILE_N every b is staged; with B > TILE_N the tile's
  // b values are (b_lo + j) mod B for local column j, staged in that order.
  uint8_t* xs = smem;                                  // [TILE_T][TILE_N]
  uint8_t* zs = smem + TILE_T * TILE_N;                // [TILE_T][TILE_N]
  unsigned long long* red =
      reinterpret_cast<unsigned long long*>(smem + 2 * TILE_T * TILE_N);
  const int nb_ = a.n_b;
  const int n0i = (int)n0;
  const int g_lo = n0i / nb_;
  const int n_last = min(n0i + TILE_N, a.n_cols) - 1;
  const int gcount = n_last / nb_ - g_lo + 1;
  const bool wide = nb_ > TILE_N;
  const int b_lo = wide ? n0i - g_lo * nb_ : 0;
  const int zcount = wide ? TILE_N : nb_;
  for (int i = threadIdx.x; i < TILE_T * gcount; i += NT) {
    const int r = i / gcount;
    const int c = i - r * gcount;
    const long long t = t0 + r;
    xs[r * TILE_N + c] =
        t < a.n_t && a.x[t * a.n_g + g_lo + c] != 0 ? 1 : 0;
  }
  for (int i = threadIdx.x; i < TILE_T * zcount; i += NT) {
    const int r = i / zcount;
    const int c = i - r * zcount;
    const long long t = t0 + r;
    const int b = wide ? (b_lo + c) % nb_ : c;
    zs[r * TILE_N + c] = t < a.n_t && a.z[t * nb_ + b] != 0 ? 1 : 0;
  }
  __syncthreads();

  // this thread's 16 columns: j = wn*64 + nb*8 + tig*2 + e
  int xc[8][2], zc[8][2];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0i + wn * 64 + nb * 8 + tig * 2 + e;
      const int g = n / nb_;
      const int b = n - g * nb_;
      xc[nb][e] = n < a.n_cols ? g - g_lo : -1;
      zc[nb][e] = wide ? (b - b_lo + nb_) % nb_ : b;
    }
  unsigned long long rs[4][2];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 64 + mb * 16 + h * 8 + grp;
      const uint8_t* xr = xs + r * TILE_N;
      const uint8_t* zr = zs + r * TILE_N;
      unsigned long long s = 0;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (xc[nb][e] >= 0 && (xr[xc[nb][e]] & zr[zc[nb][e]]))
            s += (unsigned)acc[mb][nb][h * 2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      rs[mb][h] = s;
    }
  if (tig == 0) {
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[wn * TILE_T + wm * 64 + mb * 16 + h * 8 + grp] = rs[mb][h];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < TILE_T; r += NT) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < WARPS_N; ++w) s += red[w * TILE_T + r];
    if (s != 0 && t0 + r < a.n_t) atomicAdd(a.sums + t0 + r, s);
  }
}

__global__ void __launch_bounds__(AUX_TPB)
td_finish(const unsigned long long* __restrict__ sums,
          float* __restrict__ out, long long n_t) {
  for (long long t = (long long)blockIdx.x * AUX_TPB + threadIdx.x; t < n_t;
       t += (long long)gridDim.x * AUX_TPB)
    out[t] = __ull2float_rn(sums[t]);
}

long long round_up(long long v, long long to) {
  return (v + to - 1) / to * to;
}

unsigned aux_blocks(long long work) {
  const long long blocks = (work + AUX_TPB - 1) / AUX_TPB;
  return (unsigned)(blocks < 1 ? 1 : blocks > MAX_AUX_BLOCKS ? MAX_AUX_BLOCKS
                                                            : blocks);
}

}  // namespace

extern "C" {

// uint32 words of the I' image in scratch: (G*B rounded up to TILE_N) rows
// of (M rounded up to K_CHUNK) bytes.  The launch's scratch holds the image, then
// n_t uint64 row sums: this many words plus 2 * n_t.
long long tricluster_density_scratch_words(long long n_g, long long n_m,
                                           long long n_b) {
  return round_up(n_g * n_b, TILE_N) * round_up(n_m, K_CHUNK) / 4;
}

// tensor: (n_g, n_m, n_b) uint8 0/1; x, y, z: (n_t, n_g), (n_t, n_m),
// (n_t, n_b) uint8 0/1, all contiguous; scratch:
// tricluster_density_scratch_words(...) + 2 * n_t uint32 words, 8-byte
// aligned; out: (n_t,) float32.  Launches on `stream` and returns
// cudaGetLastError() (0 when every launch was taken).
int tricluster_density_launch(const void* tensor, const void* x,
                              const void* y, const void* z, void* scratch,
                              void* out, long long n_t, long long n_g,
                              long long n_m, long long n_b, void* stream) {
  if (n_t <= 0) return (int)cudaSuccess;
  const long long n_cols = n_g * n_b;
  const long long n_pad = round_up(n_cols, TILE_N);
  const long long kp = round_up(n_m, K_CHUNK);
  const long long tiles_t = (n_t + TILE_T - 1) / TILE_T;
  const long long tiles_n = n_pad / TILE_N;
  if (n_g > 0x7fffffffLL || n_b > 0x7fffffffLL || n_pad > 0x7fffffffLL ||
      kp > 0x7fffffffLL || tiles_t > 0x7fffffffLL ||
      tiles_t * tiles_n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* image = (uint8_t*)scratch;
  unsigned long long* sums = (unsigned long long*)(image + n_pad * kp);
  cudaError_t err = cudaMemsetAsync(sums, 0, (size_t)n_t * 8, s);
  if (err != cudaSuccess) return (int)err;
  if (n_cols > 0 && n_m > 0) {
    td_image<<<aux_blocks(n_pad * kp / 16), AUX_TPB, 0, s>>>(
        (const uint8_t*)tensor, image, (int)n_cols, (int)n_pad, (int)n_m,
        (int)n_b, (int)kp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const TileArgs a{(const uint8_t*)x, (const uint8_t*)y,
                     (const uint8_t*)z, image, sums, n_t, (int)n_g,
                     (int)n_m, (int)n_b, (int)n_cols, (int)kp,
                     (int)tiles_t, (int)tiles_n};
    const bool aligned = n_m % 16 == 0 && ((uintptr_t)y & 15) == 0;
    auto kernel = aligned ? td_tile<true> : td_tile<false>;
    // a per-device attribute: set it on every launch, for the current card
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(tiles_t * tiles_n), NT, SMEM_BYTES, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  td_finish<<<aux_blocks(n_t), AUX_TPB, 0, s>>>(sums, (float*)out, n_t);
  return (int)cudaGetLastError();
}

// The tile kernel's constants and what the runtime reports of it, into
// out[0..7]: TILE_T, TILE_N, K_CHUNK, STAGES, GROUP_T; the dynamic shared
// memory a launch asks for; and, from cudaFuncGetAttributes on the variant
// `aligned` (Y by cp.async) or not (Y by byte loads) as loaded, its
// registers a thread and local memory bytes a thread.  Returns a CUDA
// error code.
int tricluster_density_config(int aligned, long long* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, aligned ? td_tile<true> : td_tile<false>);
  if (err != cudaSuccess) return (int)err;
  const long long v[8] = {TILE_T,  TILE_N,       K_CHUNK,
                          STAGES,  GROUP_T,      SMEM_BYTES,
                          attr.numRegs, (long long)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

const char* tricluster_density_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
