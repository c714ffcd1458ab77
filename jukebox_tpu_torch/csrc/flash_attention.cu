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
// dq and dk/dv run on the same machinery (warpgroup products, swizzled
// tiles, cp.async copies, host schedule):
//   dq: one warpgroup (128 threads) per 64 q rows, Q and G resident in
//     shared memory, K and V tiles of 64 rows in a two-stage cp.async ring
//     (193 KB at hd 256). S = Q.K^T and dP = G.V^T by wgmma from shared
//     memory; p = exp(s - lse) needs no running max; dS = p (dp - dd),
//     scaled and rounded to bf16 in registers, is the register A operand
//     of dQ += dS.K, K read MN-major as V is in P.V. The dQ accumulator
//     [64 x hd] (128 fp32 a thread at hd 256) stays in registers. On the
//     H100 (scripts/chip_flash_bwd_probe.py) this beat two warpgroups per
//     128 rows sharing each K/V tile, whose Q and G leave room for one
//     64-row stage only (~10% slower) or for a ring of 32-row tiles (m64n32
//     products, ~20% slower).
//   dk/dv: one block per 64 kv rows, K and V resident, Q, G (and their lse,
//     dd) in tiles of 64 q rows through a two-stage ring (210 KB at hd
//     256). The two fp32 accumulators of 64 rows would take 256 registers a
//     thread in one warpgroup, so they are split: warpgroup 0 computes
//     S^T = K.Q^T and owns dV += P^T.G, warpgroup 1 computes dP^T = V.G^T
//     and owns dK += dS^T.Q (G and Q read MN-major); warpgroup 0 hands p to
//     warpgroup 1 through shared memory behind a named barrier, its sign
//     carrying the keep mask. On the H100 the probe's other layout, hd as
//     the M side (each warpgroup 128 hd rows of both accumulators, P and dS
//     through shared memory as bf16 B operands), was ~14% slower.
//   Both take work items from the host (ops/flash_attention.py
//     dq_schedule, dkv_schedule), longest first; a range longer than the
//     cut is split in two halves, and the block that finishes second adds
//     the other's fp32 accumulators to its own. a + b == b + a in fp32, so
//     the result is the same bits whichever half finishes first, and no
//     output is summed with atomics.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e9f;
constexpr int kMaxHead = 256;

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

// ---------------------------------------------------------------------------
// helpers: copies, warpgroup products, descriptors
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

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
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

// rows [r0, r0 + ROWS) of a row-major [L, hd] matrix into a swizzled tile
// of HDP / 64 atoms [ROWS][64], zero-filling rows >= L and columns >= hd
// (all NT threads of the block issue the copies)
template <int HDP, int ROWS, int NT = 256>
__device__ __forceinline__ void load_sw_tile(bf16* dst, const bf16* src,
                                             int r0, int L, int hd) {
  constexpr int CH = HDP / 8, RS = NT / CH;  // 16-byte chunks a row
  static_assert(ROWS % RS == 0, "whole passes of the block's threads");
  const int c = threadIdx.x % CH, r = threadIdx.x / CH;
  const bf16* s = src + (size_t)(r0 + r) * hd + c * 8;
  bf16* atom = dst + (c >> 3) * ROWS * 64;
  const bool col = c * 8 < hd;
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i) {
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

  load_sw_tile<HDP, 64>(Qs, q, q0, L, hd);
  load_sw_tile<HDP, 64>(Qs + TILE, q, q0 + 64, L, hd);
  load_sw_tile<HDP, 64>(Ks, k, kv_lo * BK, L, hd);
  load_sw_tile<HDP, 64>(Vs, v, kv_lo * BK, L, hd);
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
      load_sw_tile<HDP, 64>(Ks + st * TILE, k, kv0 + BK, L, hd);
      load_sw_tile<HDP, 64>(Vs + st * TILE, v, kv0 + BK, L, hd);
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

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A work item split in two halves (pair >= 0): publish this half's fp32
// accumulators (NA x 32 a thread of the block's NT, in their fragment
// layout) to ws; the block that arrives second adds the other half's to
// its own and returns true, the first returns false. Every launch leaves
// the counters zero.
template <int NA, int NT = 256>
__device__ __forceinline__ bool merge_halves(float (&acc)[NA][32], float* ws,
                                             int* counters, int pair,
                                             int half, int* is_last) {
  constexpr int PART = NA * 32 * NT;
  const int tid = threadIdx.x;
  float* mine = ws + ((size_t)pair * 2 + half) * PART;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) mine[(a * 32 + e) * NT + tid] = acc[a][e];
  __threadfence();
  __syncthreads();
  if (tid == 0) *is_last = atomicAdd(&counters[pair], 1) == 1;
  __syncthreads();
  if (!*is_last) return false;
  __threadfence();
  const float* other = ws + ((size_t)pair * 2 + 1 - half) * PART;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e)
      acc[a][e] += __ldcg(other + (a * 32 + e) * NT + tid);
  if (tid == 0) counters[pair] = 0;
  return true;
}

// a warpgroup's fp32 [64 x HDP] accumulator (each thread rows row0 and
// row0 + 8 of its warp) to a bf16 [L, hd] matrix, rows < L, columns < hd
template <int NA>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[NA][32],
                                          int row0, int L, int hd, int t4) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + 8 * rh;
    if (row >= L) continue;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = a * 64 + i * 8 + 2 * t4;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * hd + col) =
              __floats2bfloat162_rn(acc[a][4 * i + 2 * rh],
                                    acc[a][4 * i + 2 * rh + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// dq: one block of one warpgroup per work item, a q tile of 64 rows of one
// head row and a range of its K/V tiles (64 rows), which stream through a
// two-stage cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kDqQ = 64, kDqKV = 64, kDqThreads = 128;

// Q and G and the two-stage K and V ring, plus the slack that aligns them
// to the 1024-byte period of the swizzle
__host__ __device__ constexpr int dq_smem_bytes(int hdp) {
  return (2 * kDqQ + 4 * kDqKV) * hdp * 2 + 1024;
}

template <int HDP>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ go,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    const int* __restrict__ items, float* __restrict__ ws,
                    int* __restrict__ counters, int L, int hd, float scale,
                    Dropout drop) {
  constexpr int BQ = kDqQ, BK = kDqKV, NT = kDqThreads, NA = HDP / 64;
  constexpr int T = 64 * HDP;  // elements of a tile
  __shared__ int is_last;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Gs = Qs + T;
  bf16* Ks = Gs + T;      // [2][T]
  bf16* Vs = Ks + 2 * T;  // [2][T]

  // the work item: the q tile of a head row, its K/V tiles [kv_lo, kv_hi),
  // and the pair it shares the tile with (-1: none)
  const int* it = items + 5 * blockIdx.x;
  const int bh = it[0], q0 = it[1] * BQ, kv_lo = it[2], kv_hi = it[3];
  const int pair = it[4];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; go += base; dq += base;
  const int wrow = q0 + warp * 16, row0 = wrow + g;

  load_sw_tile<HDP, 64, NT>(Qs, q, q0, L, hd);
  load_sw_tile<HDP, 64, NT>(Gs, go, q0, L, hd);
  load_sw_tile<HDP, BK, NT>(Ks, k, kv_lo * BK, L, hd);
  load_sw_tile<HDP, BK, NT>(Vs, v, kv_lo * BK, L, hd);
  cp_async_commit();
  float lse2[2], dd_r[2];  // lse in log2 units
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + 8 * rh;
    lse2[rh] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.0f;
    dd_r[rh] = row < L ? dd[(size_t)bh * L + row] : 0.0f;
  }
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.0f;
  const float sl2 = scale * kLog2e;
  const uint64_t qd = sw128_desc(Qs, 16, 1024);
  const uint64_t gd = sw128_desc(Gs, 16, 1024);

  for (int j = kv_lo; j < kv_hi; ++j) {
    const int kv0 = j * BK, st = (j - kv_lo) & 1;  // the ring's stage
    const bf16* Kt = Ks + st * T;
    const bf16* Vt = Vs + st * T;
    if (j + 1 < kv_hi) {  // the next tile's copies overlap this tile's work
      // the next stage as (j + 1 - kv_lo) % 2: written as st ^ 1, nvcc
      // 12.8 schedules this loop so that the kernel runs ~5% slower
      const int sn = (j + 1 - kv_lo) % 2;
      load_sw_tile<HDP, BK, NT>(Ks + sn * T, k, kv0 + BK, L, hd);
      load_sw_tile<HDP, BK, NT>(Vs + sn * T, v, kv0 + BK, L, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K_j, V_j (and Q and G)
    fence_async_shared();
    __syncthreads();
    float s[32], dp[32];
    const uint64_t kd = sw128_desc(Kt, 16, 1024);
    const uint64_t vd = sw128_desc(Vt, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      // k step kk: atom kk / 4, 32 bytes per step inside it
      const uint64_t off = ((kk >> 2) * 64 * 128 + (kk & 3) * 32) >> 4;
      wgmma_ss(s, qd + off, kd + off, kk > 0);
      wgmma_ss(dp, gd + off, vd + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    const bool diag = kv0 + BK - 1 > wrow;
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1, row = row0 + 8 * rh;
        const int col = kv0 + i * 8 + 2 * t4 + (e & 1);
        float p = ex2(fmaf(s[4 * i + e], sl2, -lse2[rh]));
        if (diag && row < col) p = 0.0f;
        float dpv = dp[4 * i + e];
        if (drop.on)
          dpv = kept(drop, bh, row, col) ? dpv * drop.inv_keep : 0.0f;
        d[e] = scale * (p * (dpv - dd_r[rh]));
      }
      pa[i >> 1][(i & 1) * 2] = pack_bf16(d[0], d[1]);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
    // dQ += dS.K: kv step kb (16 rows, 2048 bytes), head-dim atom a
    const uint64_t kmn = sw128_desc(Kt, BK * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_rs(acc[a], pa[kb], kmn + ((a * BK * 128 + kb * 2048) >> 4));
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // every warp is done with this stage before its refill
  }
  if (pair >= 0 && !merge_halves<NA, NT>(acc, ws, counters, pair,
                                         kv_lo == 0 ? 0 : 1, &is_last))
    return;
  store_acc<NA>(dq, acc, row0, L, hd, t4);
}

// ---------------------------------------------------------------------------
// dk/dv: one block of two warpgroups per work item, a kv tile of 64 rows of
// one head row and a range of its q tiles of 64 rows; warpgroup 0 owns dV,
// warpgroup 1 dK.
// ---------------------------------------------------------------------------

constexpr int kDkvKV = 64, kDkvQ = 64, kDkvStages = 2;

__host__ __device__ constexpr int dkv_smem_bytes(int hdp) {
  return (2 + 2 * kDkvStages) * 64 * hdp * 2  // K, V; the Q and G ring
         + 64 * 64 * 4                        // p, warpgroup 0 -> 1
         + 2 * kDkvStages * kDkvQ * 4         // lse, dd of the ring's rows
         + 1024;
}

template <int HDP>
__global__ void __launch_bounds__(256, 1)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ go,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ items,
                     float* __restrict__ ws, int* __restrict__ counters,
                     int L, int hd, float scale, Dropout drop) {
  constexpr int BK = kDkvKV, BQ = kDkvQ, NS = kDkvStages, NA = HDP / 64;
  constexpr int T = 64 * HDP;  // elements of a tile
  __shared__ int is_last;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Vs = Ks + T;
  bf16* Qs = Vs + T;       // [NS][T]
  bf16* Gs = Qs + NS * T;  // [NS][T]
  float* Ps = reinterpret_cast<float*>(Gs + NS * T);  // [32][128]
  float* lse_s = Ps + 64 * 64;    // [NS][BQ]
  float* dd_s = lse_s + NS * BQ;  // [NS][BQ]

  // the work item: the kv tile of a head row, its q tiles [q_lo, q_hi),
  // and the pair it shares the tile with (-1: none)
  const int* it = items + 5 * blockIdx.x;
  const int bh = it[0], kv_t = it[1], q_lo = it[2], q_hi = it[3];
  const int pair = it[4], kv0 = kv_t * BK;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = tid >> 7, g = lane >> 2, t4 = lane & 3, tw = tid & 127;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; go += base; dk += base; dv += base;
  lse += (size_t)bh * L;
  dd += (size_t)bh * L;
  const int krow0 = kv0 + warp * 16 + g;  // rows krow0, krow0 + 8

  // q tile j's Q, G, lse and dd into ring stage s (zeros past L)
  auto load_q = [&](int j, int s) {
    load_sw_tile<HDP, 64>(Qs + s * T, q, j * BQ, L, hd);
    load_sw_tile<HDP, 64>(Gs + s * T, go, j * BQ, L, hd);
    if (tid < 2 * BQ) {
      const int row = j * BQ + tid % BQ;
      const float* src = tid < BQ ? lse : dd;
      float* dst = (tid < BQ ? lse_s : dd_s) + s * BQ + tid % BQ;
      cp_async4(dst, row < L ? src + row : src, row < L);
    }
  };
  load_sw_tile<HDP, 64>(Ks, k, kv0, L, hd);
  load_sw_tile<HDP, 64>(Vs, v, kv0, L, hd);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (q_lo + s < q_hi) load_q(q_lo + s, s);
    cp_async_commit();
  }
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.0f;
  const float sl2 = scale * kLog2e;
  // S^T = K.Q^T (warpgroup 0), dP^T = V.G^T (warpgroup 1)
  const uint64_t ad = sw128_desc(wg == 0 ? Ks : Vs, 16, 1024);

  for (int j = q_lo; j < q_hi; ++j) {
    const int q0 = j * BQ, st = (j - q_lo) % NS;
    if (j + NS - 1 < q_hi) load_q(j + NS - 1, (j + NS - 1 - q_lo) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // tile j, K and V
    fence_async_shared();
    __syncthreads();
    const bf16* Qt = Qs + st * T;
    const bf16* Gt = Gs + st * T;
    const float* lse_t = lse_s + st * BQ;
    const float* dd_t = dd_s + st * BQ;

    float x[32];
    const uint64_t bd = sw128_desc(wg == 0 ? Qt : Gt, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint64_t off = ((kk >> 2) * 64 * 128 + (kk & 3) * 32) >> 4;
      wgmma_ss(x, ad + off, bd + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    const bool diag = q0 < kv0 + BK;  // the first q tile holds the diagonal
    uint32_t pa[BQ / 16][4];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int krow = krow0 + 8 * (e >> 1);
          const int c = i * 8 + 2 * t4 + (e & 1), qrow = q0 + c;
          float p = ex2(fmaf(x[4 * i + e], sl2, -lse_t[c] * kLog2e));
          if (diag && qrow < krow) p = 0.0f;
          const bool keep = !drop.on || kept(drop, bh, qrow, krow);
          Ps[(4 * i + e) * 128 + tw] = keep ? p : -p;
          d[e] = keep ? p * drop.inv_keep : 0.0f;
        }
        pa[i >> 1][(i & 1) * 2] = pack_bf16(d[0], d[1]);
        pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      named_arrive(1, 256);
    } else {
      named_sync(1, 256);  // warpgroup 0's p of this tile
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + 2 * t4 + (e & 1);
          const float pv = Ps[(4 * i + e) * 128 + tw];
          const float dpv = signbit(pv) ? 0.0f : x[4 * i + e] * drop.inv_keep;
          d[e] = scale * (fabsf(pv) * (dpv - dd_t[c]));
        }
        pa[i >> 1][(i & 1) * 2] = pack_bf16(d[0], d[1]);
        pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
    }
    // dV += P^T.G (warpgroup 0), dK += dS^T.Q (warpgroup 1): q step kb
    // (16 rows, 2048 bytes), head-dim atom a, G and Q read MN-major
    const uint64_t bmn = sw128_desc(wg == 0 ? Gt : Qt, 64 * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb)
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_rs(acc[a], pa[kb], bmn + ((a * 64 * 128 + kb * 2048) >> 4));
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // the stage and Ps are free for the next tile
  }
  if (pair >= 0 && !merge_halves<NA>(acc, ws, counters, pair,
                                     q_lo == kv_t * BK / BQ ? 0 : 1,
                                     &is_last))
    return;
  store_acc<NA>(wg == 0 ? dv : dk, acc, krow0, L, hd, t4);
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

// one block of `threads` per work item
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int n_items, int smem, void* stream,
           Args... args) {
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_items, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block at head width hd: kernel 0 forward,
// 1 dq, 2 dk/dv.
int jk_flash_smem(int kernel, int hd) {
  const int hdp = fwd_hdp(hd);
  return kernel == 0 ? fwd_smem_bytes(hdp)
                     : kernel == 1 ? dq_smem_bytes(hdp) : dkv_smem_bytes(hdp);
}

// The three entry points take work items of 5 ints each (head row, tile,
// first and end tile of the other side, pair or -1; ops/flash_attention.py
// fwd_schedule, dq_schedule, dkv_schedule); ws holds the two halves'
// partials of each pair (jk_flash_fwd_pair_floats,
// jk_flash_bwd_pair_floats), counters one zero int per pair (every launch
// leaves them zero).
#define JK_HDP(CALL)                         \
  switch (fwd_hdp(hd)) {                     \
    case 64: return CALL(64);                \
    case 128: return CALL(128);              \
    default: return CALL(256);               \
  }

int jk_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* items, int n_items, void* ws,
                 void* counters, int BH, int L, int hd, float scale,
                 int dropout, unsigned seed, unsigned thresh, float inv_keep,
                 void* stream) {
  if (bad_shape(BH, L, hd) || n_items < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
#define JK_FWD(HDP)                                                          \
  launch(flash_fwd_kernel<HDP>, 256, n_items, fwd_smem_bytes(HDP), stream,  \
         (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,        \
         (float*)lse, (const int*)items, (float*)ws, (int*)counters, L, hd, \
         scale, drop)
  JK_HDP(JK_FWD)
#undef JK_FWD
}

// floats of one pair's two partials at head width hd
int jk_flash_fwd_pair_floats(int hd) {
  return 2 * (fwd_hdp(hd) / 64 * 32 + 4) * 256;
}

// the same for dq and dk/dv: dk/dv's, the larger (a dq block has 128
// threads, a dk/dv block 256, with as many floats a thread)
int jk_flash_bwd_pair_floats(int hd) {
  return 2 * (fwd_hdp(hd) / 64 * 32) * 256;
}

int jk_flash_dq(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* dd, void* dq, const void* items,
                int n_items, void* ws, void* counters, int BH, int L, int hd,
                float scale, int dropout, unsigned seed, unsigned thresh,
                float inv_keep, void* stream) {
  if (bad_shape(BH, L, hd) || n_items < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
#define JK_DQ(HDP)                                                           \
  launch(flash_dq_kernel<HDP>, kDqThreads, n_items, dq_smem_bytes(HDP),    \
         stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,            \
         (const bf16*)g, (const float*)lse, (const float*)dd, (bf16*)dq,    \
         (const int*)items, (float*)ws, (int*)counters, L, hd, scale, drop)
  JK_HDP(JK_DQ)
#undef JK_DQ
}

int jk_flash_dkv(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* dd, void* dk, void* dv,
                 const void* items, int n_items, void* ws, void* counters,
                 int BH, int L, int hd, float scale, int dropout,
                 unsigned seed, unsigned thresh, float inv_keep,
                 void* stream) {
  if (bad_shape(BH, L, hd) || n_items < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
#define JK_DKV(HDP)                                                          \
  launch(flash_dkv_kernel<HDP>, 256, n_items, dkv_smem_bytes(HDP), stream,  \
         (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,    \
         (const float*)lse, (const float*)dd, (bf16*)dk, (bf16*)dv,         \
         (const int*)items, (float*)ws, (int*)counters, L, hd, scale, drop)
  JK_HDP(JK_DKV)
#undef JK_DKV
}

#undef JK_HDP

}  // extern "C"
