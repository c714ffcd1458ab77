// Causal flash attention, forward and backward, for Hopper (sm_90a), bf16.
//
// Replace: jukebox_tpu/ops/pallas/flash_attention.py, the Pallas kernels
// behind `flash_dense_attn`:
//
//   flash_fwd   <- _fwd_call / _fwd_kernel     (online softmax, fp32 lse)
//   flash_dq    <- _attn_padded_bwd / _dq_kernel
//   flash_dkv   <- _attn_padded_bwd / _dkv_kernel
//
// Layout: heads [BH, L, hd] bf16, row-major and contiguous (the wrapper,
// jukebox_tpu_torch/ops/flash_attention.py, splits [B, L, S] into heads and
// merges them back, and computes dd = sum(g * out) in fp32 between the
// passes, as the JAX wrapper does outside its kernels). lse and dd are fp32
// [BH, L]. hd is any multiple of 8 up to 256; inside a block the head dim is
// zero-padded to a multiple of 16 and the ragged L edge is masked (rows past
// L load as zeros and are never written), so no padded copy is made.
//
// Arithmetic, as the Pallas kernels:
//   s  = scale * (q . k)  in fp32 (bf16 x bf16 products summed in fp32 by
//        the tensor cores, then scaled: (q_fp32 * scale) . k_fp32 up to fp32
//        rounding), s = -1e9 where q_pos < kv_pos; kv tiles strictly above
//        the diagonal are skipped.
//   fwd: m, l online in fp32; l sums the UNdropped p; the p that multiplies
//        V is dropped by the keep mask and scaled by 1 / (1 - rate);
//        out = acc / l, lse = m + log l.
//   dq:  p = exp(s - lse); dp = g . v (dropped and scaled like p);
//        ds = p * (dp - dd); dq = scale * ds . k.
//   dkv: dv = p_dropᵀ . g, dk = scale * dsᵀ . q.
//   The keep mask is the murmur3 finaliser of the GLOBAL (seed, bh, q_pos,
//   kv_pos) of _keep_mask, bit for bit; kept when h >= uint32(rate * 2^32).
// One rounding differs from the Pallas kernels, which multiply p and ds in
// fp32: here the second product of each pass (p . V, ds . K, pᵀ . G,
// dsᵀ . Q) takes p and scale * ds rounded to bf16, the tensor cores'
// operand type, summed in fp32. The softmax statistics stay fp32.
//
// What bounds them on an H100: at the 1b_lyrics top prior's f0 layer
// (BH = 2, L = 6528, hd = 256) the causal products are 43.6 (fwd), 65.5 (dq)
// and 87.3 (dkv) GFLOP against ~30 MB of operands, so all three are bound by
// tensor-core operations (44 / 66 / 88 us at 989 TFLOP/s), far above the
// bytes (~10 us at 3.35 TB/s).
//
// The forward runs on Hopper's warpgroup products: two warpgroups per 128
// query rows, each 64; S = Q.K^T by wgmma from shared memory (Q and K in
// the 128-byte swizzled layout of wgmma's descriptors), the S tile, the
// softmax statistics and the O [64 x hd] accumulator of a warpgroup in
// its registers, P converted to bf16 in registers and fed to P.V as the
// register A operand of wgmma (V read MN-major from shared memory); K and
// V tiles of 64 rows in a two-stage cp.async ring shared by both
// warpgroups (193 KB at hd 256, one block per SM); the mask applied on
// the diagonal tiles only; the running max raised lazily (kRescale) so
// most tiles skip the O rescale. At [2, 6528, 256] it is bound by the
// bytes the blocks copy from L2 (every K/V tile once per 128 query rows)
// and by the causal grid's longest tile: the host's schedule
// (ops/flash_attention.py fwd_schedule) runs the work longest first and
// splits the long q tiles' K/V ranges in two, merged by the block that
// finishes second. Slower on the H100 in this design's card runs: one
// warpgroup on 64 rows (twice the L2 traffic), mma.sync register tiles
// (several shapes), two blocks per SM, a 3-stage ring, row-wise bulk
// copies, three-way splits, and the softmax of tile j + 1 overlapped with
// P.V_j (255 registers). TMA copies and ping-ponging warpgroups are the
// next step.
//
// dq and dk/dv are the first, simple design: one block of 8 warps per
// (bh, tile), nvcuda::wmma 16x16x16 bf16 products with fp32 accumulators,
// operand tiles staged in shared memory by 16-byte loads, the fp32
// accumulator (dQ or dK/dV) kept in shared memory, and the softmax/dropout
// pass done by plain threads between the products.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e9f;
constexpr int kPadH = 8;  // bf16 row padding (elements), keeps 32-byte tiles
constexpr int kPadF = 4;  // fp32 row padding
constexpr int kMaxHead = 256;

// tile rows: dq (q, kv), dkv (q, kv)
constexpr int kDqBQ = 64, kDqBK = 32;
constexpr int kDkvBQ = 64, kDkvBK = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// _keep_mask's hash (jukebox_tpu/ops/pallas/flash_attention.py:38).
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t bh,
                                              uint32_t q_pos,
                                              uint32_t kv_pos) {
  const uint32_t s = seed + bh * 0xC2B2AE3Du;
  uint32_t h = (q_pos * 0x9E3779B1u) ^ (kv_pos * 0x85EBCA77u) ^ s;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct Dropout {
  int on;
  uint32_t seed, thresh;
  float inv_keep;  // 1 / (1 - rate)
};

__device__ __forceinline__ bool kept(const Dropout& d, uint32_t bh, int q_pos,
                                     int kv_pos) {
  return keep_hash(d.seed, bh, (uint32_t)q_pos, (uint32_t)kv_pos) >= d.thresh;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// rows [r0, r0 + rows) of a row-major [L, hd] bf16 matrix into shared
// memory [rows][ld], zero-filling rows >= L and columns [hd, hdp).
__device__ void load_tile(bf16* dst, int ld, const bf16* src, int r0,
                          int rows, int L, int hd, int hdp) {
  const int chunks = hdp / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < hd)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * hd + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// fp32 rows [r0, r0 + rows) of a [L] vector; 0 past L.
__device__ void load_rows(float* dst, const float* src, int r0, int rows,
                          int L) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    dst[r] = r0 + r < L ? src[r0 + r] : 0.0f;
}

// C[M, N] (fp32, shared, ldc) (+)= A[M, K] . B[K, N], bf16 operands in
// shared memory. kATrans: A is Xᵀ for a row-major X [K][lda]; kBTrans: B is
// Yᵀ for a row-major Y [N][ldb]. The warps split the 16x16 output tiles.
template <bool kATrans, bool kBTrans>
__device__ void mma_tiles(float* C, int ldc, const bf16* A, int lda,
                          const bf16* B, int ldb, int M, int N, int K,
                          bool accumulate) {
  using ALay = typename std::conditional<kATrans, wmma::col_major,
                                         wmma::row_major>::type;
  using BLay = typename std::conditional<kBTrans, wmma::col_major,
                                         wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / tn, j = t % tn;
    float* c = C + i * 16 * ldc + j * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALay> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> b;
      wmma::load_matrix_sync(a, kATrans ? A + kk * lda + i * 16
                                        : A + i * 16 * lda + kk, lda);
      wmma::load_matrix_sync(b, kBTrans ? B + j * 16 * ldb + kk
                                        : B + kk * ldb + j * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// rows [r0, r0 + rows) of an fp32 [rows][ld] accumulator, each divided by
// row_div[r] when given, to a bf16 [L, hd] output (rows < L, columns < hd).
__device__ void store_rows(bf16* dst, const float* acc, int ld, int r0,
                           int rows, int L, int hd, const float* row_div) {
  for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
    const int r = i / hd, c = i % hd;
    if (r0 + r < L) {
      float x = acc[r * ld + c];
      if (row_div) x /= row_div[r];
      dst[(size_t)(r0 + r) * hd + c] = __float2bfloat16(x);
    }
  }
}

// ---------------------------------------------------------------------------
// forward helpers
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the running max is raised only when a tile's max exceeds it by more than
// this (natural log units): p = exp(s - m) then stays below e^8, and the
// O and l rescales are skipped on most tiles (lse = m + log l and out =
// acc / l use the same m, so the result is unchanged up to rounding)
constexpr float kRescale = 8.0f;


// d[64 x 64] (+)= A . B on the tensor cores of a warpgroup, bf16 in, fp32
// accumulators in the mma.sync layout (each warp 16 rows). wgmma_ss: A and
// B from shared memory (descriptors), both K-major; scale_d 0 overwrites d.
// wgmma_rs: A from registers (the mma.sync A fragment of each warp's 16
// rows), B from shared memory MN-major (transposed); accumulates.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// forward on warpgroup products (wgmma): one block of two warpgroups (8
// warps) per work item, a q tile of 128 rows (64 a warpgroup) of one head
// row and a range of its K/V tiles. Q, K and V tiles sit in shared memory
// in the 128-byte swizzled layout that wgmma's descriptors read: per 64
// columns of the head dim an atom of [rows][64] bf16, the 16-byte chunk c
// of row r at chunk c ^ (r % 8). S = Q.K^T reads both from shared memory
// (K-major); P stays in registers as the A operand of P.V, V read
// MN-major. Both warpgroups read every K and V tile of 64 rows, which
// stream through a two-stage cp.async ring: tile j + 1's copies in flight
// while tile j's products and softmax run. Scores scaled after the
// product, -1e9 above the diagonal (applied on the diagonal tiles only);
// online softmax in registers with a lazy running max (kRescale); dropout
// by the keep mask; out = acc / l, lse = m + log l. The host's work items
// run longest first; a long q tile's K/V range is split between two
// blocks, and the second to finish merges the first's partial (O, m, l).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte strides
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// rows [r0, r0 + 64) of a row-major [L, hd] matrix into a swizzled tile of
// HDP / 64 atoms [64][64], zero-filling rows >= L and columns >= hd
template <int HDP>
__device__ __forceinline__ void load_sw_tile(bf16* dst, const bf16* src,
                                             int r0, int L, int hd) {
  constexpr int CH = HDP / 8, RS = 256 / CH;  // 16-byte chunks a row
  const int c = threadIdx.x % CH, r = threadIdx.x / CH;
  const bf16* s = src + (size_t)(r0 + r) * hd + c * 8;
  bf16* atom = dst + (c >> 3) * 64 * 64;
  const bool col = c * 8 < hd;
#pragma unroll
  for (int i = 0; i < 64 / RS; ++i) {
    const int rr = r + i * RS;
    const bool ok = col && r0 + rr < L;
    cp_async16(atom + rr * 64 + (((c & 7) ^ (rr & 7)) << 3),
               ok ? s + (size_t)i * RS * hd : src, ok);
  }
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Q (two warpgroups' rows) and the two-stage K and V ring (193 KB at hd
// 256), plus the slack that aligns Q to the 1024-byte period of the swizzle
__host__ __device__ constexpr int fwd_smem_bytes(int hdp) {
  return 6 * 64 * hdp * 2 + 1024;
}

// the head dim padded to a whole number of 64-column atoms
int fwd_hdp(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

template <int HDP>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ items,
                     float* __restrict__ ws, int* __restrict__ counters,
                     int L, int hd, float scale, Dropout drop) {
  constexpr int BQ = 128, BK = 64, NA = HDP / 64, TILE = 64 * HDP;
  constexpr int PART = (NA * 32 + 4) * 256;  // one half's (O, m, l) floats
  __shared__ int is_last;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Ks = Qs + 2 * TILE;  // [2][TILE]
  bf16* Vs = Ks + 2 * TILE;  // [2][TILE]

  // this block's work item: the q tile of a head row, its K/V tiles
  // [kv_lo, kv_hi), and the pair it shares the tile with (-1: none)
  const int* it = items + 5 * blockIdx.x;
  const int bh = it[0], q0 = it[1] * BQ, kv_lo = it[2], kv_hi = it[3];
  const int pair = it[4];
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = tid >> 7;  // warpgroup: rows q0 + 64 wg .. + 63
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; out += base;
  const int wrow = q0 + wg * 64 + warp * 16;
  const int row0 = wrow + g;
  const int wg_last = (q0 + wg * 64 + 63) / BK;  // its last K/V tile

  load_sw_tile<HDP>(Qs, q, q0, L, hd);
  load_sw_tile<HDP>(Qs + TILE, q, q0 + 64, L, hd);
  load_sw_tile<HDP>(Ks, k, kv_lo * BK, L, hd);
  load_sw_tile<HDP>(Vs, v, kv_lo * BK, L, hd);
  cp_async_commit();

  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[a][e] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};
  const uint64_t dq = sw128_desc(Qs + wg * TILE, 16, 1024);

  for (int j = kv_lo; j < kv_hi; ++j) {
    const int kv0 = j * BK, st = (j - kv_lo) & 1;  // the ring's stage
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;
    if (j + 1 < kv_hi) {  // the next tile's copies overlap this tile's work
      const int st = (j + 1 - kv_lo) & 1;
      load_sw_tile<HDP>(Ks + st * TILE, k, kv0 + BK, L, hd);
      load_sw_tile<HDP>(Vs + st * TILE, v, kv0 + BK, L, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();    // K_j, V_j and Q
    fence_async_shared();  // the copies are visible to the tensor cores
    __syncthreads();
    if (j <= wg_last) {  // warpgroup-uniform: the first one ends a tile early

      float s[32];
      const uint64_t dk = sw128_desc(Kt, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        // k step kk: atom kk / 4, 32 bytes per step inside it
        const uint64_t off = ((kk >> 2) * 64 * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss(s, dq + off, dk + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();

      const bool diag = kv0 + BK - 1 > wrow;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rh = e >> 1;
          float x = s[4 * i + e] * scale;
          if (diag && row0 + 8 * rh < kv0 + i * 8 + 2 * t4 + (e & 1)) x = kNeg;
          s[4 * i + e] = x;
          mx[rh] = fmaxf(mx[rh], x);
        }
      bool raise = false;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
        mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
        raise |= mx[rh] > m_r[rh] + kRescale;
      }
      if (__any_sync(0xffffffffu, raise)) {
        float alpha[2];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float m_new = fmaxf(m_r[rh], mx[rh]);
          alpha[rh] = ex2((m_r[rh] - m_new) * kLog2e);
          m_r[rh] = m_new;
          l_r[rh] *= alpha[rh];
        }
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[a][e] *= alpha[(e >> 1) & 1];
      }
      const float mb[2] = {m_r[0] * kLog2e, m_r[1] * kLog2e};
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rh = e >> 1;
          p[e] = ex2(fmaf(s[4 * i + e], kLog2e, -mb[rh]));
          l_r[rh] += p[e];
          if (drop.on)
            p[e] = kept(drop, bh, row0 + 8 * rh, kv0 + i * 8 + 2 * t4 + (e & 1))
                       ? p[e] * drop.inv_keep
                       : 0.0f;
        }
        pa[i >> 1][(i & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // O += P.V: kv step kb (16 rows, 2048 bytes), head-dim atom a
      const uint64_t dv = sw128_desc(Vt, 64 * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          wgmma_rs(o[a], pa[kb], dv + ((a * 64 * 128 + kb * 2048) >> 4));
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {  // l over the quad's columns
    l_r[rh] += __shfl_xor_sync(0xffffffffu, l_r[rh], 1);
    l_r[rh] += __shfl_xor_sync(0xffffffffu, l_r[rh], 2);
  }

  if (pair >= 0) {
    // the q tile's K/V range is split between two blocks: publish this
    // half's (O, m, l) in its fragment layout; the block that arrives
    // second merges the other half into its registers
    const int half = kv_lo == 0 ? 0 : 1;
    float* mine = ws + ((size_t)pair * 2 + half) * PART;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[(a * 32 + e) * 256 + tid] = o[a][e];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mine[(NA * 32 + rh) * 256 + tid] = m_r[rh];
      mine[(NA * 32 + 2 + rh) * 256 + tid] = l_r[rh];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[pair], 1) == 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the halves are summed in half order, whichever block merges, so the
    // result does not depend on which finished first
    const float* other = ws + ((size_t)pair * 2 + 1 - half) * PART;
    auto merge = [&](float mine_v, float other_v, float f_mine,
                     float f_other) {
      return half == 0 ? fmaf(other_v, f_other, mine_v * f_mine)
                       : fmaf(mine_v, f_mine, other_v * f_other);
    };
    float fs[2], fo[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float m1 = __ldcg(other + (NA * 32 + rh) * 256 + tid);
      const float mm = fmaxf(m_r[rh], m1);
      fs[rh] = ex2((m_r[rh] - mm) * kLog2e);
      fo[rh] = ex2((m1 - mm) * kLog2e);
      l_r[rh] = merge(l_r[rh], __ldcg(other + (NA * 32 + 2 + rh) * 256 + tid),
                      fs[rh], fo[rh]);
      m_r[rh] = mm;
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int rh = (e >> 1) & 1;
        o[a][e] = merge(o[a][e], __ldcg(other + (a * 32 + e) * 256 + tid),
                        fs[rh], fo[rh]);
      }
    if (tid == 0) counters[pair] = 0;
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float l = l_r[rh];
    const int row = row0 + 8 * rh;
    if (row < L) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = a * 64 + i * 8 + 2 * t4;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * hd + col) =
                __floats2bfloat162_rn(o[a][4 * i + 2 * rh] / l,
                                      o[a][4 * i + 2 * rh + 1] / l);
        }
      if (t4 == 0) lse[(size_t)bh * L + row] = m_r[rh] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (q tile, bh); loops over the kv tiles on or below the
// diagonal, recomputing p from lse.
// ---------------------------------------------------------------------------

constexpr int dq_smem(int hdp) {
  return (2 * kDqBQ + 2 * kDqBK) * (hdp + kPadH) * 2  // Q, G, K, V
         + kDqBQ * (hdp + kPadF) * 4                  // dQ accumulator
         + 2 * kDqBQ * (kDqBK + kPadF) * 4            // S, dP
         + kDqBQ * (kDqBK + kPadH) * 2                // dS (bf16)
         + 2 * kDqBQ * 4;                             // lse, dd
}

__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    int L, int hd, float scale, Dropout drop) {
  constexpr int BQ = kDqBQ, BK = kDqBK;
  const int hdp = round16(hd), ldh = hdp + kPadH, ldo = hdp + kPadF;
  constexpr int lds = BK + kPadF, ldp = BK + kPadH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BQ * ldh;
  bf16* Ks = Gs + BQ * ldh;
  bf16* Vs = Ks + BK * ldh;
  float* dQs = reinterpret_cast<float*>(Vs + BK * ldh);
  float* Ss = dQs + BQ * ldo;
  float* dPs = Ss + BQ * lds;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BQ * lds);
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * ldp);
  float* dd_s = lse_s + BQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; g += base; dq += base;

  load_tile(Qs, ldh, q, q0, BQ, L, hd, hdp);
  load_tile(Gs, ldh, g, q0, BQ, L, hd, hdp);
  load_rows(lse_s, lse + (size_t)bh * L, q0, BQ, L);
  load_rows(dd_s, dd + (size_t)bh * L, q0, BQ, L);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) dQs[i] = 0.0f;
  const int n_kv = min(q0 + BQ - 1, L - 1) / BK + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BK;
    __syncthreads();
    load_tile(Ks, ldh, k, kv0, BK, L, hd, hdp);
    load_tile(Vs, ldh, v, kv0, BK, L, hd, hdp);
    __syncthreads();
    mma_tiles<false, true>(Ss, lds, Qs, ldh, Ks, ldh, BQ, BK, hdp, false);
    mma_tiles<false, true>(dPs, lds, Gs, ldh, Vs, ldh, BQ, BK, hdp, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, qp = q0 + r, kp = kv0 + c;
      float x = Ss[r * lds + c] * scale;
      if (qp < kp) x = kNeg;
      const float p = expf(x - lse_s[r]);
      float dp = dPs[r * lds + c];
      if (drop.on) dp = kept(drop, bh, qp, kp) ? dp * drop.inv_keep : 0.0f;
      dSs[r * ldp + c] = __float2bfloat16(scale * (p * (dp - dd_s[r])));
    }
    __syncthreads();
    mma_tiles<false, false>(dQs, ldo, dSs, ldp, Ks, ldh, BQ, hdp, BK, true);
  }
  __syncthreads();
  store_rows(dq, dQs, ldo, q0, BQ, L, hd, nullptr);
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (kv tile, bh); loops over the q tiles on or below
// the diagonal. No atomics: each block owns its rows of dk and dv.
// ---------------------------------------------------------------------------

constexpr int dkv_smem(int hdp) {
  return (2 * kDkvBK + 2 * kDkvBQ) * (hdp + kPadH) * 2  // K, V, Q, G
         + 2 * kDkvBK * (hdp + kPadF) * 4               // dK, dV accumulators
         + 2 * kDkvBQ * (kDkvBK + kPadF) * 4            // S, dP
         + 2 * kDkvBQ * (kDkvBK + kPadH) * 2            // P, dS (bf16)
         + 2 * kDkvBQ * 4;                              // lse, dd
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, int hd, float scale,
                     Dropout drop) {
  constexpr int BQ = kDkvBQ, BK = kDkvBK;
  const int hdp = round16(hd), ldh = hdp + kPadH, ldo = hdp + kPadF;
  constexpr int lds = BK + kPadF, ldp = BK + kPadH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * ldh;
  bf16* Qs = Vs + BK * ldh;
  bf16* Gs = Qs + BQ * ldh;
  float* dKs = reinterpret_cast<float*>(Gs + BQ * ldh);
  float* dVs = dKs + BK * ldo;
  float* Ss = dVs + BK * ldo;
  float* dPs = Ss + BQ * lds;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + BQ * lds);
  bf16* dSs = Ps + BQ * ldp;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * ldp);
  float* dd_s = lse_s + BQ;

  const int bh = blockIdx.y, kv0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; g += base; dk += base; dv += base;

  load_tile(Ks, ldh, k, kv0, BK, L, hd, hdp);
  load_tile(Vs, ldh, v, kv0, BK, L, hd, hdp);
  for (int i = threadIdx.x; i < BK * ldo; i += kThreads) {
    dKs[i] = 0.0f;
    dVs[i] = 0.0f;
  }
  const int n_q = (L - 1) / BQ + 1;
  for (int qi = kv0 / BQ; qi < n_q; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();
    load_tile(Qs, ldh, q, q0, BQ, L, hd, hdp);
    load_tile(Gs, ldh, g, q0, BQ, L, hd, hdp);
    load_rows(lse_s, lse + (size_t)bh * L, q0, BQ, L);
    load_rows(dd_s, dd + (size_t)bh * L, q0, BQ, L);
    __syncthreads();
    mma_tiles<false, true>(Ss, lds, Qs, ldh, Ks, ldh, BQ, BK, hdp, false);
    mma_tiles<false, true>(dPs, lds, Gs, ldh, Vs, ldh, BQ, BK, hdp, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, qp = q0 + r, kp = kv0 + c;
      float x = Ss[r * lds + c] * scale;
      if (qp < kp) x = kNeg;
      const float p = expf(x - lse_s[r]);
      float pv = p, dp = dPs[r * lds + c];
      if (drop.on) {
        const bool keep = kept(drop, bh, qp, kp);
        pv = keep ? p * drop.inv_keep : 0.0f;
        dp = keep ? dp * drop.inv_keep : 0.0f;
      }
      Ps[r * ldp + c] = __float2bfloat16(pv);
      dSs[r * ldp + c] = __float2bfloat16(scale * (p * (dp - dd_s[r])));
    }
    __syncthreads();
    mma_tiles<true, false>(dVs, ldo, Ps, ldp, Gs, ldh, BK, hdp, BQ, true);
    mma_tiles<true, false>(dKs, ldo, dSs, ldp, Qs, ldh, BK, hdp, BQ, true);
  }
  __syncthreads();
  store_rows(dk, dKs, ldo, kv0, BK, L, hd, nullptr);
  store_rows(dv, dVs, ldo, kv0, BK, L, hd, nullptr);
}

bool bad_shape(int BH, int L, int hd) {
  return BH < 1 || BH > 65535 || L < 1 || hd < 8 || hd > kMaxHead ||
         hd % 8;
}

Dropout make_dropout(int on, unsigned seed, unsigned thresh, float inv_keep) {
  Dropout d;
  d.on = on;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  return d;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HDP>
int fwd_launch(const void* q, const void* k, const void* v, void* out,
               void* lse, const void* items, int n_items, void* ws,
               void* counters, int L, int hd, float scale,
               const Dropout& drop, void* stream) {
  constexpr int smem = fwd_smem_bytes(HDP);
  const cudaError_t e = set_smem(flash_fwd_kernel<HDP>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<HDP><<<n_items, 256, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, (const int*)items, (float*)ws, (int*)counters, L, hd,
      scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block at head width hd: kernel 0 forward,
// 1 dq, 2 dk/dv.
int jk_flash_smem(int kernel, int hd) {
  const int hdp = round16(hd);
  return kernel == 0 ? fwd_smem_bytes(fwd_hdp(hd))
                     : kernel == 1 ? dq_smem(hdp) : dkv_smem(hdp);
}

// The forward's work items (5 ints each: head row, q tile, first and end
// K/V tile, pair or -1; ops/flash_attention.py fwd_schedule); ws holds two
// partials of (hd-padded O, m, l) per pair, counters one zero int per pair
// (every launch leaves them zero).
int jk_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* items, int n_items, void* ws,
                 void* counters, int BH, int L, int hd, float scale,
                 int dropout, unsigned seed, unsigned thresh, float inv_keep,
                 void* stream) {
  if (bad_shape(BH, L, hd) || n_items < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
#define JK_FWD(HDP)                                                          \
  fwd_launch<HDP>(q, k, v, out, lse, items, n_items, ws, counters, L, hd,   \
                  scale, drop, stream)
  switch (fwd_hdp(hd)) {
    case 64: return JK_FWD(64);
    case 128: return JK_FWD(128);
    default: return JK_FWD(256);
  }
#undef JK_FWD
}

// floats of one pair's two partials at head width hd
int jk_flash_fwd_pair_floats(int hd) {
  return 2 * (fwd_hdp(hd) / 64 * 32 + 4) * 256;
}

int jk_flash_dq(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* dd, void* dq, int BH, int L,
                int hd, float scale, int dropout, unsigned seed,
                unsigned thresh, float inv_keep, void* stream) {
  if (bad_shape(BH, L, hd)) return (int)cudaErrorInvalidValue;
  const int smem = dq_smem(round16(hd));
  cudaError_t e = set_smem(flash_dq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kDqBQ - 1) / kDqBQ, BH);
  flash_dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)dd, (bf16*)dq, L, hd, scale,
      make_dropout(dropout, seed, thresh, inv_keep));
  return (int)cudaGetLastError();
}

int jk_flash_dkv(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* dd, void* dk, void* dv, int BH,
                 int L, int hd, float scale, int dropout, unsigned seed,
                 unsigned thresh, float inv_keep, void* stream) {
  if (bad_shape(BH, L, hd)) return (int)cudaErrorInvalidValue;
  const int smem = dkv_smem(round16(hd));
  cudaError_t e = set_smem(flash_dkv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kDkvBK - 1) / kDkvBK, BH);
  flash_dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
      (const float*)lse, (const float*)dd, (bf16*)dk, (bf16*)dv, L, hd,
      scale, make_dropout(dropout, seed, thresh, inv_keep));
  return (int)cudaGetLastError();
}

}  // extern "C"
