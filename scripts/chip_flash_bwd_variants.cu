// Alternatives to the flash backward designs of
// jukebox_tpu_torch/csrc/flash_attention.cu, built and timed beside them by
// scripts/chip_flash_bwd_probe.py. Not part of the package: nothing in
// jukebox_tpu_torch builds or loads this file.
//
// This source includes the package's kernel file, so one library holds the
// shipped kernels (jk_flash_dq, jk_flash_dkv) and the alternatives, which
// reuse its helpers (swizzled tiles, cp.async, wgmma, the halves' merge):
//
//   jk_probe_dq(variant, ...)  dq with K/V tiles of BK rows in an NS-stage
//     cp.async ring and NWG warpgroups of 64 q rows a block (Q and G of
//     all of them resident); variant 0: BK 32, NS 2, NWG 2 (wgmma n32);
//     1: BK 32, NS 3, NWG 2; 2: BK 64, NS 1, NWG 2 (two 64-row stages do
//     not fit beside two warpgroups' Q and G). The shipped dq is BK 64,
//     NS 2, NWG 1.
//   jk_probe_dkv(...)  dk/dv design (ii): the accumulators transposed, hd
//     as the M side. Both warpgroups compute a 64 x 64 product per q tile
//     (S^T = K.Q^T, dP^T = V.G^T, as the shipped design (i)); P^T and dS^T
//     go to shared memory as bf16 tiles, and each warpgroup then owns 128
//     of the 256 hd rows of both dV^T += G^T.P and dK^T += Q^T.dS (64 + 64
//     fp32 registers a thread), A read MN-major from the Q and G tiles, B
//     K-major from the P and dS tiles. The shipped design (i) gives dV to
//     warpgroup 0 and dK to warpgroup 1, each [64 x 256] with P^T and dS^T
//     as register A operands.
//
// hd 256 only (HDP 256); the same arguments as the package's entry points.

#include "../jukebox_tpu_torch/csrc/flash_attention.cu"

namespace {

// d[64 x 32] (+)= A . B, as wgmma_ss with an N of 32
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A . B with A read MN-major (transposed) from shared memory,
// B K-major
__device__ __forceinline__ void wgmma_ss_ta(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int HDP, int BK, int NS, int NWG>
__host__ __device__ constexpr int probe_dq_smem() {
  return (2 * NWG * 64 + 2 * NS * BK) * HDP * 2 + 1024;
}

template <int HDP, int BK, int NS, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    probe_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ go,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, bf16* __restrict__ dq,
                    const int* __restrict__ items, float* __restrict__ ws,
                    int* __restrict__ counters, int L, int hd, float scale,
                    Dropout drop) {
  constexpr int NT = 128 * NWG, BQ = 64 * NWG, NA = HDP / 64;
  constexpr int QT = 64 * HDP, KT = BK * HDP;  // elements of a tile
  static_assert(BK == 32 || BK == 64, "wgmma n32 or n64");
  __shared__ int is_last;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Gs = Qs + NWG * QT;
  bf16* Ks = Gs + NWG * QT;  // [NS][KT]
  bf16* Vs = Ks + NS * KT;   // [NS][KT]

  const int* it = items + 5 * blockIdx.x;
  const int bh = it[0], q0 = it[1] * BQ, kv_lo = it[2], kv_hi = it[3];
  const int pair = it[4];
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = tid >> 7, g = lane >> 2, t4 = lane & 3;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; go += base; dq += base;
  const int wrow = q0 + wg * 64 + warp * 16, row0 = wrow + g;
  const int wg_last = (q0 + wg * 64 + 63) / BK;

#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    load_sw_tile<HDP, 64, NT>(Qs + w * QT, q, q0 + 64 * w, L, hd);
    load_sw_tile<HDP, 64, NT>(Gs + w * QT, go, q0 + 64 * w, L, hd);
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (kv_lo + s < kv_hi) {
      load_sw_tile<HDP, BK, NT>(Ks + s * KT, k, (kv_lo + s) * BK, L, hd);
      load_sw_tile<HDP, BK, NT>(Vs + s * KT, v, (kv_lo + s) * BK, L, hd);
    }
    cp_async_commit();
  }
  float lse2[2], dd_r[2];
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
  const uint64_t qd = sw128_desc(Qs + wg * QT, 16, 1024);
  const uint64_t gd = sw128_desc(Gs + wg * QT, 16, 1024);

  for (int j = kv_lo; j < kv_hi; ++j) {
    const int kv0 = j * BK, st = (j - kv_lo) % NS;
    if (j + NS - 1 < kv_hi) {  // a later tile's copies overlap this one
      const int sn = (j + NS - 1 - kv_lo) % NS;
      load_sw_tile<HDP, BK, NT>(Ks + sn * KT, k, (j + NS - 1) * BK, L, hd);
      load_sw_tile<HDP, BK, NT>(Vs + sn * KT, v, (j + NS - 1) * BK, L, hd);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();
    fence_async_shared();
    __syncthreads();
    if (j <= wg_last) {
      const bf16* Kt = Ks + st * KT;
      const bf16* Vt = Vs + st * KT;
      float s[BK / 2], dp[BK / 2];
      const uint64_t kd = sw128_desc(Kt, 16, 1024);
      const uint64_t vd = sw128_desc(Vt, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint64_t oa = ((kk >> 2) * 64 * 128 + (kk & 3) * 32) >> 4;
        const uint64_t ob = ((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4;
        if constexpr (BK == 32) {
          wgmma_ss32(s, qd + oa, kd + ob, kk > 0);
          wgmma_ss32(dp, gd + oa, vd + ob, kk > 0);
        } else {
          wgmma_ss(s, qd + oa, kd + ob, kk > 0);
          wgmma_ss(dp, gd + oa, vd + ob, kk > 0);
        }
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
      const uint64_t kmn = sw128_desc(Kt, BK * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          wgmma_rs(acc[a], pa[kb], kmn + ((a * BK * 128 + kb * 2048) >> 4));
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();
  }
  if (pair >= 0 && !merge_halves<NA, NT>(acc, ws, counters, pair,
                                         kv_lo == 0 ? 0 : 1, &is_last))
    return;
  store_acc<NA>(dq, acc, row0, L, hd, t4);
}

// dk/dv design (ii): K, V (64 kv rows) resident, Q, G, lse and dd of 64 q
// rows in a two-stage ring, p (fp32, sign = keep) from warpgroup 0 to 1,
// and the bf16 P^T and dS^T tiles [64 kv][64 q] (one swizzled atom each)
constexpr int kProbeDkvSmem =
    6 * 64 * 256 * 2 + 2 * 64 * 64 * 2 + 64 * 64 * 4 + 2 * 2 * 64 * 4 + 1024;

__global__ void __launch_bounds__(256, 1)
    probe_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ go,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ items,
                     float* __restrict__ ws, int* __restrict__ counters,
                     int L, int hd, float scale, Dropout drop) {
  constexpr int HDP = 256, BK = 64, BQ = 64, NS = 2, T = 64 * HDP;
  constexpr int MT = HDP / 128;  // m tiles of 64 hd rows a warpgroup
  __shared__ int is_last;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Vs = Ks + T;
  bf16* Qs = Vs + T;       // [NS][T]
  bf16* Gs = Qs + NS * T;  // [NS][T]
  bf16* Pb = Gs + NS * T;  // [64 kv][64 q], swizzled
  bf16* Db = Pb + 64 * 64;
  float* Ps = reinterpret_cast<float*>(Db + 64 * 64);  // [32][128]
  float* lse_s = Ps + 64 * 64;
  float* dd_s = lse_s + NS * BQ;

  const int* it = items + 5 * blockIdx.x;
  const int bh = it[0], kv_t = it[1], q_lo = it[2], q_hi = it[3];
  const int pair = it[4], kv0 = kv_t * BK;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg = tid >> 7, g = lane >> 2, t4 = lane & 3, tw = tid & 127;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; go += base; dk += base; dv += base;
  lse += (size_t)bh * L;
  dd += (size_t)bh * L;
  const int kr = warp * 16 + g;  // tile rows kr, kr + 8 of S^T
  const int krow0 = kv0 + kr;

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
  // a [64 x 64] fragment pair (row r, columns c, c + 1) into a swizzled atom
  auto put = [&](bf16* tile, int r, int c, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(tile + r * 64 + (((c >> 3) ^ (r & 7)) << 3) +
                                 (c & 7)) = pack_bf16(lo, hi);
  };
  load_sw_tile<HDP, 64>(Ks, k, kv0, L, hd);
  load_sw_tile<HDP, 64>(Vs, v, kv0, L, hd);
  load_q(q_lo, 0);
  cp_async_commit();
  float acc[2 * MT][32];  // dV^T m tiles, then dK^T m tiles
#pragma unroll
  for (int a = 0; a < 2 * MT; ++a)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[a][e] = 0.0f;
  const float sl2 = scale * kLog2e;
  const uint64_t ad = sw128_desc(wg == 0 ? Ks : Vs, 16, 1024);
  const uint64_t pd = sw128_desc(Pb, 16, 1024);
  const uint64_t dsd = sw128_desc(Db, 16, 1024);

  for (int j = q_lo; j < q_hi; ++j) {
    const int q0 = j * BQ, st = (j - q_lo) % NS;
    if (j + 1 < q_hi) load_q(j + 1, (j + 1 - q_lo) % NS);
    cp_async_commit();
    cp_async_wait<1>();
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

    const bool diag = q0 < kv0 + BK;
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
        put(Pb, kr, i * 8 + 2 * t4, d[0], d[1]);
        put(Pb, kr + 8, i * 8 + 2 * t4, d[2], d[3]);
      }
      named_arrive(1, 256);
    } else {
      named_sync(1, 256);
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
        put(Db, kr, i * 8 + 2 * t4, d[0], d[1]);
        put(Db, kr + 8, i * 8 + 2 * t4, d[2], d[3]);
      }
    }
    fence_async_shared();  // P^T and dS^T visible to the tensor cores
    __syncthreads();
    // dV^T += G^T.P, dK^T += Q^T.dS over this warpgroup's hd rows: hd atom
    // a, q step kb (16 rows: 2048 bytes of the G / Q atom, 32 of P / dS)
    const uint64_t gmn = sw128_desc(Gt, 64 * 128, 1024);
    const uint64_t qmn = sw128_desc(Qt, 64 * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int a = wg * MT + mt;
#pragma unroll
      for (int kb = 0; kb < BQ / 16; ++kb) {
        const uint64_t oa = (a * 64 * 128 + kb * 2048) >> 4;
        const uint64_t ob = (kb * 32) >> 4;
        wgmma_ss_ta(acc[mt], gmn + oa, pd + ob);
        wgmma_ss_ta(acc[MT + mt], qmn + oa, dsd + ob);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // the stage, Ps, Pb and Db are free for the next tile
  }
  if (pair >= 0 && !merge_halves<2 * MT>(acc, ws, counters, pair,
                                         q_lo == kv_t * BK / BQ ? 0 : 1,
                                         &is_last))
    return;
  // thread (warp, g, t4) holds hd rows wg * 64 MT + 64 mt + 16 warp + g
  // (+ 8) and kv columns 8 i + 2 t4 (+ 1) of each transposed accumulator
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = (wg * MT + mt) * 64 + warp * 16 + g + 8 * (e >> 1);
        const int row = kv0 + i * 8 + 2 * t4 + (e & 1);
        if (row < L && h < hd) {
          dv[(size_t)row * hd + h] = __float2bfloat16_rn(acc[mt][4 * i + e]);
          dk[(size_t)row * hd + h] =
              __float2bfloat16_rn(acc[MT + mt][4 * i + e]);
        }
      }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a variant at hd 256: 0-2 dq, 3 dk/dv (ii).
int jk_probe_smem(int variant) {
  switch (variant) {
    case 0: return probe_dq_smem<256, 32, 2, 2>();
    case 1: return probe_dq_smem<256, 32, 3, 2>();
    case 2: return probe_dq_smem<256, 64, 1, 2>();
    default: return kProbeDkvSmem;
  }
}

int jk_probe_dq(int variant, const void* q, const void* k, const void* v,
                const void* g, const void* lse, const void* dd, void* dq,
                const void* items, int n_items, void* ws, void* counters,
                int BH, int L, int hd, float scale, int dropout,
                unsigned seed, unsigned thresh, float inv_keep,
                void* stream) {
  if (bad_shape(BH, L, hd) || fwd_hdp(hd) != 256 || n_items < 1)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
#define JK_PROBE_DQ(BK, NS, NWG)                                          \
  launch(probe_dq_kernel<256, BK, NS, NWG>, 128 * NWG, n_items,          \
         probe_dq_smem<256, BK, NS, NWG>(), stream, (const bf16*)q,      \
         (const bf16*)k, (const bf16*)v, (const bf16*)g,                 \
         (const float*)lse, (const float*)dd, (bf16*)dq,                 \
         (const int*)items, (float*)ws, (int*)counters, L, hd, scale,    \
         drop)
  switch (variant) {
    case 0: return JK_PROBE_DQ(32, 2, 2);
    case 1: return JK_PROBE_DQ(32, 3, 2);
    case 2: return JK_PROBE_DQ(64, 1, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef JK_PROBE_DQ
}

int jk_probe_dkv(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* dd, void* dk, void* dv,
                 const void* items, int n_items, void* ws, void* counters,
                 int BH, int L, int hd, float scale, int dropout,
                 unsigned seed, unsigned thresh, float inv_keep,
                 void* stream) {
  if (bad_shape(BH, L, hd) || fwd_hdp(hd) != 256 || n_items < 1)
    return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  return launch(probe_dkv_kernel, 256, n_items, kProbeDkvSmem, stream,
                (const bf16*)q, (const bf16*)k, (const bf16*)v,
                   (const bf16*)g, (const float*)lse, (const float*)dd,
                   (bf16*)dk, (bf16*)dv, (const int*)items, (float*)ws,
                   (int*)counters, L, hd, scale, drop);
}

}  // extern "C"
