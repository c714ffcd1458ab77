// Design alternatives of the GEMVs (gemv_bf16 and gemv_int8, one kernel
// template in the package), for scripts/chip_gemv_ln_probe.py only:
// nothing in the package builds this file. It includes the package's
// decode-step kernels (so one nvcc run builds the shipped template beside
// these) and adds:
//   gemv_bf16_old_kernel   gemv_bf16 as it shipped before the template: one
//                          block of 256 threads per 16 columns, all of x
//                          staged in shared memory first, K split inside
//                          the block only, CUDA-core FMAs;
//   gemv_global_kernel     the template's products with the combine it
//                          had before the cluster: 4 warps a block, on
//                          the earlier plan (about four blocks per SM), the
//                          splits' partials through a global workspace and
//                          summed by the tile's last block to arrive
//                          (atomic counter after a fence): gemv_int8 as it
//                          shipped before (two steps in flight, 4 blocks
//                          an SM), and its best alternative then (three
//                          steps, 3 blocks an SM);
//   gemv_cluster_kernel    the shipped products and cluster with the other
//                          exchange: each block keeps its partial and,
//                          after the barrier, the owners read the others'
//                          (a second barrier keeps them resident); cut to
//                          its products alone or its products and the
//                          barrier, it says where the shipped tail goes;
//   gemv_loads_t_kernel    the shipped loop's loads alone;
//   gemv_empty_kernel      a grid with no work: the launch and dispatch;
//   ln_rows_kernel         the decode step's LayerNorm kernel that the
//                          prologue replaced: one block per row, before
//                          the GEMV (the unfused pair);
//   gemv_x_kernel          the shipped products without the LayerNorm
//                          prologue (x read from L2), every epilogue, in
//                          either loop order: each iteration's weights
//                          and x loaded before its products (the order
//                          gemv_bf16 had before the prologue, and the
//                          shipped kernel's), or the LN-GEMV's first loop
//                          (the first steps' weights before the loop, the
//                          next steps' after the products);
//   gemv_ln_variant_kernel the shipped LN-GEMV with another prologue:
//                          every block reads its B whole rows from L2 and
//                          takes their statistics itself (no cluster
//                          exchange); the shipped prologue with the first
//                          steps' weight loads issued after it; or the
//                          mean and the centred squares met in two
//                          exchanges (two cluster barriers, g and b read
//                          when normalising).
// Entry: jk_probe_gemv(variant, int8, ...) with variant 0 the old bf16
// design (bf16 only; splits, chunk, ws and counters unused), 1 loads
// alone, 2 empty, 3 and 9 the shipped products (without the prologue:
// gemv_x_kernel) with two and one steps in flight a lane whatever the
// split, 4 the global combine (int8: as
// shipped before), 5 the global combine with three steps at 3 blocks an
// SM, 6 the cluster read after the barrier, 7 its products alone, 8 its
// products and barrier. B <= 8, no epilogue, N % 16 == 0, K % 4 == 0 for
// the cluster variants.
// Entry: jk_probe_gemv_x(variant, int8, ...): gemv_x_kernel on the given
// plan with epilogue epi (0-2; res for 2), variant 0 each iteration's
// loads before its products, 1 the LN-GEMV's first loop. B <= 16.
// Entry: jk_probe_ln_gemv(variant, int8, ...) with variant 0 the unfused
// pair (ln_rows into u_ws [B, K] bf16, then gemv_x_kernel in the order
// gemv_bf16 had before the prologue: the pair as it shipped), 1 the
// statistics from the L2 rows, 2 the shipped prologue without the weight
// prefetch, 3 the two exchanges, 4 the weights issued before x, 5 the
// weights by __ldg, 6 the prologue alone, 7 its loads alone, 8 it without
// the cluster exchange (6-8: y not written), 9 every thread in the
// statistics' passes, 10 the next weights issued after each iteration's
// products (the LN-GEMV's first loop); epilogue 0 or 1, B <= 8, N % 16
// == 0, K % 4 == 0 (1-10).

#include "../jukebox_tpu_torch/csrc/decode_stack.cu"

namespace {

constexpr int kGlobalWarps = 4;
constexpr int kGlobalThreads = 32 * kGlobalWarps;

// ---------------------------------------------------------------------------
// The GEMV epilogue as the variants below were written, one output at a
// time (the package's gemv_store4 stores four): output element at = b * N
// + n, from s, the fp32
// product (scaled) plus bias. y32, when given, receives s itself: the
// attention reads q from it, and the int8 cache mode quantises the new k, v
// rows from it. EPI: 0 none, 1 quick_gelu, 2 residual (out = res + bf16(y);
// aux, when given, also receives bf16(y)), 3 res_scale (out = res +
// bf16(bf16(res2 + bf16(y)) * bf16(rs)), the bf16 roundings of x + (a + m)
// * res_scale).
// ---------------------------------------------------------------------------
template <int EPI>
__device__ __forceinline__ void gemv_store(
    float s, size_t at, const __nv_bfloat16* __restrict__ res,
    const __nv_bfloat16* __restrict__ res2, __nv_bfloat16* __restrict__ aux,
    float* __restrict__ y32, __nv_bfloat16* __restrict__ y, float rs) {
  if (y32 != nullptr) y32[at] = s;
  float out;
  if (EPI == 1) {
    out = s / (1.0f + expf(-1.702f * s));
  } else if (EPI == 2) {
    if (aux != nullptr) aux[at] = __float2bfloat16(s);
    out = __bfloat162float(res[at]) + bf16_round(s);
  } else if (EPI == 3) {
    const float am = bf16_round(__bfloat162float(res2[at]) + bf16_round(s));
    out = __bfloat162float(res[at]) + bf16_round(am * bf16_round(rs));
  } else {
    out = s;
  }
  y[at] = __float2bfloat16(out);
}

// ---------------------------------------------------------------------------
// gemv_bf16 as it shipped before the kernel template, verbatim but for
// its name. Block = 256 threads over a slice of kBf16Cols = 16 columns of
// N. Thread (tx = tid % 2, ky = tid / 2) accumulates columns n0 + tx*8 ..
// +7 over the rows k = ky, ky + 128, ... of W, 8 weights (16 bytes) per
// load. BT is the batch bucket (>= B).
// ---------------------------------------------------------------------------
constexpr int kBf16TPR = 2;
constexpr int kBf16Cols = 8 * kBf16TPR;

template <int BT, int EPI>
__global__ void __launch_bounds__(kThreads)
gemv_bf16_old_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ W,
                 const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ res,
                 const __nv_bfloat16* __restrict__ res2,
                 __nv_bfloat16* __restrict__ aux, float* __restrict__ y32,
                 __nv_bfloat16* __restrict__ y, int B, int K, int N,
                 float rs) {
  constexpr int TPR = kBf16TPR;
  constexpr int COLS = kBf16Cols;
  constexpr int ROWS = kThreads / TPR;
  extern __shared__ __nv_bfloat16 xs[];  // [B][K]
  __shared__ float red[kWarps][BT][COLS];
  for (int i = threadIdx.x; i < B * K; i += kThreads) xs[i] = x[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % TPR, ky = threadIdx.x / TPR;
  const int n0 = blockIdx.x * COLS + tx * 8;

  float acc[BT][8];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[bb][j] = 0.0f;

  if (n0 < N) {
#pragma unroll 4
    for (int k = ky; k < K; k += ROWS) {
      float wf[8];
      const uint4 raw = *reinterpret_cast<const uint4*>(W + (size_t)k * N + n0);
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(w2[j]);
        wf[2 * j] = f.x;
        wf[2 * j + 1] = f.y;
      }
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        if (bb < B) {
          const float xv = __bfloat162float(xs[bb * K + k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[bb][j] = fmaf(xv, wf[j], acc[bb][j]);
        }
      }
    }
  }

  // sum the row groups of each warp that share tx (lane bits above TPR)
#pragma unroll
  for (int bb = 0; bb < BT; ++bb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[bb][j];
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[bb][j] = v;
    }
  if (lane < TPR) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][bb][lane * 8 + j] = acc[bb][j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < B * COLS; i += kThreads) {
    const int bb = i / COLS, c = i % COLS;
    const int n = blockIdx.x * COLS + c;
    if (n >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][bb][c];
    s += __bfloat162float(bias[n]);
    gemv_store<EPI>(s, (size_t)bb * N + n, res, res2, aux, y32, y, rs);
  }
}

template <class WL, int BT, int EPI, bool V16, int UU, int MINB>
__global__ void __launch_bounds__(kGlobalThreads, MINB)
gemv_global_kernel(const __nv_bfloat16* __restrict__ x,
            const typename WL::T* __restrict__ W,
            const float* __restrict__ scale,
            const __nv_bfloat16* __restrict__ bias,
            const __nv_bfloat16* __restrict__ res,
            const __nv_bfloat16* __restrict__ res2,
            __nv_bfloat16* __restrict__ aux, float* __restrict__ y32,
            __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
            int* __restrict__ counters, int B, int K, int N, int chunk,
            float rs) {
  constexpr int NB = BT / 8;  // mmas per column pair (8 batch rows)
  // steps in flight: UU, else 128 bytes a lane (64 when B > 8)
  constexpr int U = UU > 0 ? UU : NB == 1 ? 8 / WL::kWords : 1;
  constexpr int STRIDE = kGlobalWarps * kGemvStep;
  __shared__ __align__(16) float red[kGlobalWarps * BT * kGemvRedPitch];
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x, splits = gridDim.y;
  const int c0 = tile * kGemvCols, col = c0 + 16 * g;
  const int k_lo = blockIdx.y * chunk, k_hi = min(K, k_lo + chunk);
  const bool col_ok = col < N, hi_ok = V16 || col + 8 < N;
  const bool x_vec = (K & 3) == 0;  // x[b][k + 4q ..] 8-byte aligned

  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;

  for (int k0 = k_lo + kGemvStep * warp; k0 < k_hi; k0 += U * STRIDE) {
    uint32_t w[U][4][WL::kWords];  // [step][row k + 4q + r][word]
    uint32_t xb[U][NB][2];         // x[b][k + 4q .. + 3] as two bf16 pairs
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (col_ok && k + r < k_hi) {
          WL::template load<V16>(W + (size_t)(k + r) * N + col, hi_ok,
                                 w[u][r]);
        } else {
#pragma unroll
          for (int i = 0; i < WL::kWords; ++i) w[u][r][i] = 0u;
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int b = g + 8 * nb;
        xb[u][nb][0] = xb[u][nb][1] = 0u;
        if (b < B && k < k_hi) {
          const __nv_bfloat16* px = x + (size_t)b * K + k;
          if (x_vec) {
            const uint2 xv = __ldg(reinterpret_cast<const uint2*>(px));
            xb[u][nb][0] = xv.x;
            xb[u][nb][1] = xv.y;
          } else {
            uint16_t h[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              h[e] = k + e < k_hi ? __bfloat16_as_ushort(px[e]) : 0;
            xb[u][nb][0] = h[0] | ((uint32_t)h[1] << 16);
            xb[u][nb][1] = h[2] | ((uint32_t)h[3] << 16);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      gemv_mma<WL, 0>(acc, w[u], xb[u]);
      gemv_mma<WL, 1>(acc, w[u], xb[u]);
      gemv_mma<WL, 2>(acc, w[u], xb[u]);
      gemv_mma<WL, 3>(acc, w[u], xb[u]);
      gemv_mma<WL, 4>(acc, w[u], xb[u]);
      gemv_mma<WL, 5>(acc, w[u], xb[u]);
      gemv_mma<WL, 6>(acc, w[u], xb[u]);
      gemv_mma<WL, 7>(acc, w[u], xb[u]);
    }
  }

  // acc[nb][j][e]: column 16 g + 2j + (e >> 1), batch row 8 nb + 2q + (e & 1)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kGemvRedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();

  // 4 columns a thread from here on: cols is a multiple of 8
  const int cols = min(kGemvCols, N - c0);
  const int quads = B * (kGemvCols / 4);
  // the output columns n .. n + 3 of batch row b from their sums v
  auto finish = [&](const float (&v)[4], int b, int n) {
    float sv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if constexpr (WL::kScaled) {
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
      sv[0] = sc.x;
      sv[1] = sc.y;
      sv[2] = sc.z;
      sv[3] = sc.w;
    }
    const uint2 bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gemv_store<EPI>((WL::kScaled ? v[e] * sv[e] : v[e])
                          + __bfloat162float(bv[e]),
                      (size_t)b * N + n + e, res, res2, aux, y32, y, rs);
  };
  for (int i = threadIdx.x; i < quads; i += kGlobalThreads) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (c >= cols) continue;
    float4 s = *reinterpret_cast<const float4*>(red + b * kGemvRedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kGlobalWarps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kGemvRedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int n = c0 + c;
    if (splits == 1) {
      finish({s.x, s.y, s.z, s.w}, b, n);
    } else {
      *reinterpret_cast<float4*>(ws + ((size_t)blockIdx.y * B + b) * N + n) =
          s;
    }
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const size_t zstride = (size_t)B * N;
  for (int i = threadIdx.x; i < quads; i += kGlobalThreads) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (c >= cols) continue;
    const int n = c0 + c;
    const float4* p = reinterpret_cast<const float4*>(ws + (size_t)b * N + n);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z0 = 0; z0 < splits; z0 += 16) {
      float4 t[16];
#pragma unroll
      for (int z = 0; z < 16; ++z)
        if (z0 + z < splits) t[z] = __ldcg(p + (z0 + z) * zstride / 4);
#pragma unroll
      for (int z = 0; z < 16; ++z)
        if (z0 + z < splits) {
          v[0] += t[z].x;
          v[1] += t[z].y;
          v[2] += t[z].z;
          v[3] += t[z].w;
        }
    }
    finish(v, b, n);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// The shipped template's products with the combine moved into a thread
// block cluster: the splits of a tile (at most 16) are one cluster, each
// block's partial stays in its shared memory, and after a cluster barrier
// every block sums its share of the tile's quads (quad i: rank i % splits)
// over the cluster's partials in rank order, read from distributed shared
// memory; no workspace, fence or counter. WARPS warps a block; B <= 8.
// MODE cuts it to say where the shipped kernel's tail goes: 0 whole; 1
// each block stores its own partial (no barrier, no exchange); 2 the same
// behind the cluster barrier.
template <class WL, bool V16, int WARPS, int MODE, int U>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
gemv_cluster_kernel(const __nv_bfloat16* __restrict__ x,
                    const typename WL::T* __restrict__ W,
                    const float* __restrict__ scale,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int B, int K, int N,
                    int chunk) {
  namespace cg = cooperative_groups;
  constexpr int NB = 1, THREADS = 32 * WARPS;
  constexpr int STRIDE = WARPS * kGemvStep;
  __shared__ __align__(16) float red[WARPS * 8 * kGemvRedPitch];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kGemvCols, col = c0 + 16 * g;
  const int k_lo = blockIdx.y * chunk, k_hi = min(K, k_lo + chunk);
  const bool col_ok = col < N, hi_ok = V16 || col + 8 < N;

  float acc[NB][8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;
  for (int k0 = k_lo + kGemvStep * warp; k0 < k_hi; k0 += U * STRIDE) {
    uint32_t w[U][4][WL::kWords];
    uint32_t xb[U][NB][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (col_ok && k + r < k_hi) {
          WL::template load<V16>(W + (size_t)(k + r) * N + col, hi_ok,
                                 w[u][r]);
        } else {
#pragma unroll
          for (int i = 0; i < WL::kWords; ++i) w[u][r][i] = 0u;
        }
      }
      xb[u][0][0] = xb[u][0][1] = 0u;
      if (g < B && k < k_hi) {  // K % 4 == 0
        const uint2 xv = __ldg(reinterpret_cast<const uint2*>(
            x + (size_t)g * K + k));
        xb[u][0][0] = xv.x;
        xb[u][0][1] = xv.y;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      gemv_mma<WL, 0>(acc, w[u], xb[u]);
      gemv_mma<WL, 1>(acc, w[u], xb[u]);
      gemv_mma<WL, 2>(acc, w[u], xb[u]);
      gemv_mma<WL, 3>(acc, w[u], xb[u]);
      gemv_mma<WL, 4>(acc, w[u], xb[u]);
      gemv_mma<WL, 5>(acc, w[u], xb[u]);
      gemv_mma<WL, 6>(acc, w[u], xb[u]);
      gemv_mma<WL, 7>(acc, w[u], xb[u]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = 2 * q + h;
    if (b < B) {
      float* row = red + (warp * B + b) * kGemvRedPitch + 16 * g;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(row + 2 * j) =
            make_float2(acc[0][j][h], acc[0][j][2 + h]);
    }
  }
  __syncthreads();
  const int cols = min(kGemvCols, N - c0);
  const int quads = B * (kGemvCols / 4);
  // the block's partial into warp 0's rows, the warps in order
  for (int i = threadIdx.x; i < quads; i += THREADS) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(red + b * kGemvRedPitch + c);
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kGemvRedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *reinterpret_cast<float4*>(red + b * kGemvRedPitch + c) = s;
    if (MODE == 1 || MODE == 2) {
      if (MODE == 2) continue;
      if (c0 + c < N)
        y[(size_t)b * N + c0 + c] = __float2bfloat16(s.x + s.y + s.z + s.w);
    }
  }
  if (MODE == 1) return;
  cluster.sync();
  if (MODE == 2) {
    for (int i = threadIdx.x; i < quads; i += THREADS) {
      const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
      const float4 t = *reinterpret_cast<const float4*>(
          red + b * kGemvRedPitch + c);
      if (c0 + c < N)
        y[(size_t)b * N + c0 + c] = __float2bfloat16(t.x + t.y + t.z + t.w);
    }
    return;
  }
  for (int i = rank + csize * threadIdx.x; i < quads; i += csize * THREADS) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (c >= cols) continue;
    float4* mine = reinterpret_cast<float4*>(red + b * kGemvRedPitch + c);
    float4 t[16];
#pragma unroll
    for (int z = 0; z < 16; ++z)
      if (z < csize) t[z] = *cluster.map_shared_rank(mine, z);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int z = 0; z < 16; ++z)
      if (z < csize) {
        v[0] += t[z].x;
        v[1] += t[z].y;
        v[2] += t[z].z;
        v[3] += t[z].w;
      }
    const int n = c0 + c;
    const uint2 bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = WL::kScaled ? scale[n + e] : 1.0f;
      y[(size_t)b * N + n + e] =
          __float2bfloat16(v[e] * sv + __bfloat162float(bv[e]));
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// The shipped loop's loads alone, for either loader: its loop with the
// products replaced by an xor of the loaded words (what streaming W and x
// costs), B <= 8
template <class WL, int U>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_loads_t_kernel(const __nv_bfloat16* __restrict__ x,
                    const typename WL::T* __restrict__ W,
                    __nv_bfloat16* __restrict__ y, int B, int K, int N,
                    int chunk) {
  constexpr int STRIDE = kGemvWarps * kGemvStep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int col = blockIdx.x * kGemvCols + 16 * g;
  const int k_lo = blockIdx.y * chunk, k_hi = min(K, k_lo + chunk);
  uint32_t fold = 0;
  for (int k0 = k_lo + kGemvStep * warp; k0 < k_hi; k0 += U * STRIDE) {
    uint32_t w[U][4][WL::kWords];
    uint2 xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (col < N && k + r < k_hi) {
          WL::template load<true>(W + (size_t)(k + r) * N + col, true,
                                  w[u][r]);
        } else {
#pragma unroll
          for (int i = 0; i < WL::kWords; ++i) w[u][r][i] = 0u;
        }
      }
      xv[u] = g < B && k < k_hi ? __ldg(reinterpret_cast<const uint2*>(
                                      x + (size_t)g * K + k))
                                : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < WL::kWords; ++i) fold ^= w[u][r][i];
      fold ^= xv[u].x ^ xv[u].y;
    }
  }
  if (fold == 0x9e3779b9u && blockIdx.x == 0xffff)  // keeps the loads
    y[threadIdx.x] = __float2bfloat16(1.0f);
}

// The shipped GEMV's products without the LayerNorm prologue: gemv_kernel
// of the package as it is for EPI 2 and 3, for every epilogue, x read from
// L2. NEXT_W false: each iteration loads its steps' weights, then its x,
// then multiplies (the order of gemv_bf16 before the prologue, and of the
// shipped kernel); true: the LN-GEMV's first loop, the first steps'
// weights before the loop and each iteration's next weights issued after
// its products.
template <class WL, int BT, int EPI, bool V16, int U, bool NEXT_W>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_x_kernel(const __nv_bfloat16* __restrict__ x,
              const typename WL::T* __restrict__ W,
              const float* __restrict__ scale,
              const __nv_bfloat16* __restrict__ bias,
              const __nv_bfloat16* __restrict__ res,
              __nv_bfloat16* __restrict__ y, int B, int K, int N, int chunk) {
  namespace cg = cooperative_groups;
  constexpr int NB = BT / 8;
  constexpr int STRIDE = kGemvWarps * kGemvStep;
  extern __shared__ __align__(16) float red[];
  __shared__ float4 recv[kGemvRecv];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kGemvCols, col = c0 + 16 * g;
  const int k_lo = rank * chunk, k_hi = min(K, k_lo + chunk);
  const bool col_ok = col < N, hi_ok = V16 || col + 8 < N;
  const int cols = min(kGemvCols, N - c0);
  const int quads = B * (kGemvCols / 4);
  const int m = (quads + splits - 1) / splits;
  const int own = rank + splits * threadIdx.x;
  uint2 own_b, own_r;
  float4 own_s;
  auto quad_in = [&](int i, uint2& bi, float4& sc, uint2& r) {
    const int n = c0 + (i % (kGemvCols / 4)) * 4;
    const size_t at = (size_t)(i / (kGemvCols / 4)) * N + n;
    bi = r = make_uint2(0u, 0u);
    sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (i >= quads || n >= N) return;
    bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
    if constexpr (WL::kScaled)
      sc = __ldg(reinterpret_cast<const float4*>(scale + n));
    if constexpr (EPI == 2)
      r = __ldg(reinterpret_cast<const uint2*>(res + at));
  };
  quad_in(own, own_b, own_s, own_r);
  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;
  int k0 = k_lo + kGemvStep * warp;
  uint32_t w[U][4][WL::kWords];
  if constexpr (NEXT_W)
    gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
  for (; k0 < k_hi; k0 += U * STRIDE) {
    if constexpr (!NEXT_W)
      gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    uint32_t xb[U][NB][2];
    gemv_load_x<false, NB, U>(x, nullptr, 0, k0, k_lo, k_hi, B, K, g, q, xb);
#pragma unroll
    for (int s = 0; s < U; ++s) {
      gemv_mma<WL, 0>(acc, w[s], xb[s]);
      gemv_mma<WL, 1>(acc, w[s], xb[s]);
      gemv_mma<WL, 2>(acc, w[s], xb[s]);
      gemv_mma<WL, 3>(acc, w[s], xb[s]);
      gemv_mma<WL, 4>(acc, w[s], xb[s]);
      gemv_mma<WL, 5>(acc, w[s], xb[s]);
      gemv_mma<WL, 6>(acc, w[s], xb[s]);
      gemv_mma<WL, 7>(acc, w[s], xb[s]);
    }
    if (NEXT_W && k0 + U * STRIDE < k_hi)
      gemv_load_w<WL, V16, U>(W, k0 + U * STRIDE, k_hi, N, col, col_ok,
                              hi_ok, q, w);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kGemvRedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < quads; i += kGemvThreads) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(red + b * kGemvRedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kGemvWarps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kGemvRedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *cluster.map_shared_rank(&recv[rank * m + i / splits], i % splits) = s;
  }
  cluster.sync();
  for (int j = threadIdx.x; j < m; j += kGemvThreads) {
    const int i = rank + splits * j;
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (i >= quads || c >= cols) continue;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z = 0; z < splits; ++z) {
      const float4 t = recv[z * m + j];
      v[0] += t.x;
      v[1] += t.y;
      v[2] += t.z;
      v[3] += t.w;
    }
    uint2 bi = own_b, r = own_r;
    float4 sc = own_s;
    if (j != threadIdx.x) quad_in(i, bi, sc, r);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
    const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (WL::kScaled ? v[e] * sv[e] : v[e]) + __bfloat162float(bv[e]);
    gemv_store4<EPI>(v, (size_t)b * N + c0 + c, r, make_uint2(0u, 0u),
                     nullptr, nullptr, y, 1.0f);
  }
}

// One gemv_x_kernel launch on grid (column tiles, splits), a tile's splits
// one cluster (a.res, a.y; s for int8)
template <class WL, int BT, int EPI, bool V16, int U, bool NEXT_W>
cudaError_t launch_gemv_x(const GemvArgs& a, cudaStream_t st) {
  auto kernel = gemv_x_kernel<WL, BT, EPI, V16, U, NEXT_W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gemv_smem(BT, 0));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.N + kGemvCols - 1) / kGemvCols, a.splits);
  config.blockDim = dim3(kGemvThreads);
  config.dynamicSmemBytes = gemv_smem(a.B, 0);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, a.x, (const typename WL::T*)a.W,
                            a.s, a.bias, a.res, a.y, a.B, a.K, a.N, a.chunk);
}

// gemv_x_kernel with the shipped launcher's tile and steps in flight
// (launch_gemv_b), N % 16 == 0
template <class WL, int EPI, bool NEXT_W>
cudaError_t launch_gemv_x_b(const GemvArgs& a, cudaStream_t st) {
  const int steps = (a.chunk + kGemvStep - 1) / kGemvStep;
  if (a.B > 8) return launch_gemv_x<WL, 16, EPI, true, 1, NEXT_W>(a, st);
  if (steps >= 2 * kGemvWarps - 1 && steps <= 2 * kGemvWarps)
    return launch_gemv_x<WL, 8, EPI, true, 2, NEXT_W>(a, st);
  return launch_gemv_x<WL, 8, EPI, true, 1, NEXT_W>(a, st);
}

template <class WL>
cudaError_t gemv_x_entry(int variant, const GemvArgs& a, int epi,
                         cudaStream_t st) {
  if (a.B < 1 || a.B > 16 || a.N % 16 || variant < 0 || variant > 1 ||
      epi < 0 || epi > 2 || (epi == 2) != (a.res != nullptr))
    return cudaErrorInvalidValue;
#define JK_X(E)                                                               \
  (variant == 0 ? launch_gemv_x_b<WL, E, false>(a, st)                        \
                : launch_gemv_x_b<WL, E, true>(a, st))
  return epi == 0 ? JK_X(0) : epi == 1 ? JK_X(1) : JK_X(2);
#undef JK_X
}

__global__ void gemv_empty_kernel() {}

// A launch of `kernel` on grid (tiles, splits) with the splits of a tile
// one cluster
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, int threads,
                            cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <class WL>
int probe(int variant, const void* x, const void* W, const void* s,
          const void* bias, void* y, void* ws, void* counters, int B, int K,
          int N, int splits, int chunk, cudaStream_t st) {
  using T = typename WL::T;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* wt = (const T*)W;
  const auto* bb = (const __nv_bfloat16*)bias;
  auto* yb = (__nv_bfloat16*)y;
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  // the steps in flight the shipped launcher takes for this split
  const int steps = (chunk + kGemvStep - 1) / kGemvStep;
  const bool two = steps >= 2 * kGemvWarps - 1 && steps <= 2 * kGemvWarps;
  switch (variant) {
    case 1:
      (two ? gemv_loads_t_kernel<WL, 2> : gemv_loads_t_kernel<WL, 1>)
          <<<grid, kGemvThreads, 0, st>>>(xb, wt, yb, B, K, N, chunk);
      break;
    case 2:
      gemv_empty_kernel<<<grid, kGemvThreads, 0, st>>>();
      break;
    case 3:
    case 9: {
      const GemvArgs a{xb, W, (const float*)s, bb, nullptr, nullptr,
                       nullptr, nullptr, yb, nullptr, nullptr, B, K, N,
                       splits, chunk, 0, 1.0f, 1e-5f};
      return (int)(variant == 3
                       ? launch_gemv_x<WL, 8, 0, true, 2, false>(a, st)
                       : launch_gemv_x<WL, 8, 0, true, 1, false>(a, st));
    }
    case 4:
    case 5: {
      auto kern = variant == 4 ? gemv_global_kernel<WL, 8, 0, true, 0, 4>
                               : gemv_global_kernel<WL, 8, 0, true, 3, 3>;
      kern<<<grid, kGlobalThreads, 0, st>>>(
          xb, wt, (const float*)s, bb, nullptr, nullptr, nullptr, nullptr,
          yb, (float*)ws, (int*)counters, B, K, N, chunk, 1.0f);
      break;
    }
    case 6:
    case 7:
    case 8: {
      if (K % 4 || splits > 16) return (int)cudaErrorInvalidValue;
      auto kern = variant == 6
                      ? (two ? gemv_cluster_kernel<WL, true, 8, 0, 2>
                             : gemv_cluster_kernel<WL, true, 8, 0, 1>)
                  : variant == 7
                      ? (two ? gemv_cluster_kernel<WL, true, 8, 1, 2>
                             : gemv_cluster_kernel<WL, true, 8, 1, 1>)
                      : (two ? gemv_cluster_kernel<WL, true, 8, 2, 2>
                             : gemv_cluster_kernel<WL, true, 8, 2, 1>);
      return (int)launch_clusters(kern, grid, 256, st, xb, wt,
                                  (const float*)s, bb, yb, B, K, N, chunk);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The replaced ln_rows kernel (it ran before every c_attn and mlp c_fc
// GEMV), verbatim but for this comment: one block per row of x [rows, S].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
               int S, float eps) {
  __shared__ float scratch[kWarps];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * S;
  __nv_bfloat16* yr = y + (size_t)blockIdx.x * S;
  float s = 0.0f;
  for (int i = threadIdx.x; i < S; i += kThreads) s += __bfloat162float(xr[i]);
  const float mean = block_sum(s, scratch) / S;
  float v = 0.0f;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float d = __bfloat162float(xr[i]) - mean;
    v += d * d;
  }
  const float var = block_sum(v, scratch) / S;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float d = __bfloat162float(xr[i]) - mean;
    yr[i] = __float2bfloat16(d * rstd * g[i] + b[i]);
  }
}

// The other prologue: every block reads its B whole rows from L2 (warp w
// rows w, w + 8, 8 bytes a lane-step), takes the two-pass statistics
// itself, then normalises its columns into u as the shipped prologue does.
// No cluster barrier.
__device__ __forceinline__ void gemv_ln_prologue_rows(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ lnb, __nv_bfloat16* u, int pitch, int B, int K,
    int k_lo, int k_hi, float eps) {
  __shared__ float mean[16], rstd[16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = k_hi - k_lo, padded = (len + kGemvStep - 1) & ~(kGemvStep - 1);
  for (int b = warp; b < B; b += kGemvWarps) {
    const __nv_bfloat16* xr = x + (size_t)b * K;
    float s = 0.0f;
    for (int c = 4 * lane; c < K; c += 128) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr + c));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 a = __bfloat1622float2(h[0]), c2 = __bfloat1622float2(h[1]);
      s += a.x + a.y + c2.x + c2.y;
    }
    const float m = warp_sum(s) / (float)K;
    float q = 0.0f;
    for (int c = 4 * lane; c < K; c += 128) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr + c));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 a = __bfloat1622float2(h[0]), c2 = __bfloat1622float2(h[1]);
      const float d0 = a.x - m, d1 = a.y - m, d2 = c2.x - m, d3 = c2.y - m;
      q += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    }
    q = warp_sum(q);
    if (lane == 0) {
      mean[b] = m;
      rstd[b] = rsqrtf(q / (float)K + eps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * padded; i += kGemvThreads) {
    const int b = i / padded, c = i - b * padded;
    float v = 0.0f;
    if (c < len) {
      const float d = __fsub_rn(__bfloat162float(x[(size_t)b * K + k_lo + c]),
                                mean[b]);
      v = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd[b]), __ldg(lng + k_lo + c)),
                    __ldg(lnb + k_lo + c));
    }
    u[b * pitch + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

// The prologue with the statistics met in two exchanges: the splits'
// sums, a cluster barrier, the mean; the centred squares about it, a
// second barrier, the variance; g and b read from L2 when normalising.
__device__ __forceinline__ void gemv_ln_prologue_two(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ lnb, __nv_bfloat16* u, int pitch, int B, int K,
    int k_lo, int k_hi, float eps) {
  namespace cg = cooperative_groups;
  __shared__ float part[2][kGemvMaxSplits][16];  // [pass][sender][row]
  __shared__ float mean[16], rstd[16];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = k_hi - k_lo, padded = (len + kGemvStep - 1) & ~(kGemvStep - 1);
  // the block's columns of x into u, 8 bytes a thread-step where rows are
  // 8-byte aligned
  if ((K & 3) == 0) {
    const int n4 = len >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < B * n4; i += kGemvThreads) {
      const int b = i / n4, c = (i - b * n4) * 4;
      *reinterpret_cast<uint2*>(u + b * pitch + c) = __ldg(
          reinterpret_cast<const uint2*>(x + (size_t)b * K + k_lo + c));
    }
  } else {
    for (int i = threadIdx.x; i < B * len; i += kGemvThreads) {
      const int b = i / len, c = i - b * len;
      u[b * pitch + c] = x[(size_t)b * K + k_lo + c];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // pass 1: the rows' sums; pass 2: their centred squares
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int b = warp; b < B; b += kGemvWarps) {
      const __nv_bfloat16* ub = u + b * pitch;
      float s = 0.0f;
      if (pass == 0) {
        for (int c = lane; c < len; c += 32) s += __bfloat162float(ub[c]);
      } else {
        const float m = mean[b];
        for (int c = lane; c < len; c += 32) {
          const float d = __bfloat162float(ub[c]) - m;
          s += d * d;
        }
      }
      s = warp_sum(s);
      if (lane < splits) *cluster.map_shared_rank(&part[pass][rank][b], lane) = s;
    }
    cluster.sync();  // every split's sums have landed
    for (int b = warp; b < B; b += kGemvWarps) {
      float t = 0.0f;
      for (int z = 0; z < splits; ++z) t += part[pass][z][b];
      if (lane == 0) {
        if (pass == 0)
          mean[b] = t / (float)K;
        else
          rstd[b] = rsqrtf(t / (float)K + eps);
      }
    }
    __syncthreads();
  }
  // normalise in place, rounding as the plain version's separate ops; zero
  // the columns past k_hi up to the last piece the loop reads
  for (int i = threadIdx.x; i < B * padded; i += kGemvThreads) {
    const int b = i / padded, c = i - b * padded;
    float v = 0.0f;
    if (c < len) {
      const float d = __fsub_rn(__bfloat162float(u[b * pitch + c]), mean[b]);
      v = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd[b]), __ldg(lng + k_lo + c)),
                    __ldg(lnb + k_lo + c));
    }
    u[b * pitch + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

// gemv_ln_stats cut to the block's own columns: the same passes and
// normalising without the cluster exchange (wrong statistics: a cut that
// times the prologue without its cluster barrier, never checked).
__device__ __forceinline__ void gemv_ln_stats_local(__nv_bfloat16* u,
                                                    const float* gb,
                                                    int pitch, int B,
                                                    int k_lo, int k_hi,
                                                    float eps) {
  __shared__ float mean[16], rstd[16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = k_hi - k_lo, padded = (len + kGemvStep - 1) & ~(kGemvStep - 1);
  for (int b = warp; b < B; b += kGemvWarps) {
    const __nv_bfloat16* ub = u + b * pitch;
    float s = 0.0f;
    for (int c = lane; c < len; c += 32) s += __bfloat162float(ub[c]);
    s = warp_sum(s);
    const float m = s / (float)len;
    float q = 0.0f;
    for (int c = lane; c < len; c += 32) {
      const float d = __bfloat162float(ub[c]) - m;
      q += d * d;
    }
    q = warp_sum(q);
    if (lane == 0) {
      mean[b] = m;
      rstd[b] = rsqrtf(q / (float)len + eps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * padded; i += kGemvThreads) {
    const int b = i / padded, c = i - b * padded;
    float v = 0.0f;
    if (c < len) {
      const float d = __fsub_rn(__bfloat162float(u[b * pitch + c]), mean[b]);
      v = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd[b]), gb[c]), gb[pitch + c]);
    }
    u[b * pitch + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

// gemv_ln_stats with every thread in its passes (BT >= B): thread t over
// the columns t, t + 256, ... of every row, then the warp's xor butterfly,
// then the warps in order (no warp a row, no division in the loops), the
// cluster's first barrier phase awaited only before the first remote
// write; the exchange, combine and normalising as shipped.
template <int BT>
__device__ __forceinline__ void gemv_ln_stats_all(__nv_bfloat16* u,
                                              const float* gb, int pitch,
                                              int B, int K, int k_lo,
                                              int k_hi, int chunk,
                                              float eps) {
  namespace cg = cooperative_groups;
  // [sender][row]: the sender's sum and its centred sum of squares about
  // its own mean
  __shared__ float2 part[kGemvMaxSplits][16];
  __shared__ float wsum[kGemvWarps][16];
  __shared__ float mean[16], rstd[16];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = k_hi - k_lo, padded = (len + kGemvStep - 1) & ~(kGemvStep - 1);
  // the block's sum of each row's columns (CENTRED: of their squares about
  // mean[b]), into the thread b's value (b < B)
  auto row_sums = [&](bool centred) {
    float v[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) v[b] = 0.0f;
    for (int c = threadIdx.x; c < len; c += kGemvThreads) {
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b < B) {
          const float x = __bfloat162float(u[b * pitch + c]);
          if (centred) {
            const float d = __fsub_rn(x, mean[b]);
            v[b] = __fadd_rn(v[b], __fmul_rn(d, d));
          } else {
            v[b] += x;
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      v[b] = warp_sum(v[b]);
      if (lane == 0 && b < B) wsum[warp][b] = v[b];
    }
    __syncthreads();
    float t = 0.0f;
    if (threadIdx.x < B) {
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) t += wsum[w][threadIdx.x];
    }
    return t;
  };
  const float s = row_sums(false);
  if (threadIdx.x < B) mean[threadIdx.x] = s / (float)len;  // the split's
  __syncthreads();
  const float q = row_sums(true);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < B)
    for (int z = 0; z < splits; ++z)
      *cluster.map_shared_rank(&part[rank][threadIdx.x], z) =
          make_float2(s, q);
  cluster.sync();  // every split's sums have landed
  // the mean from the splits' sums in rank order; the centred sum of
  // squares about it by the exact identity sum_z [q_z + n_z (m_z - m)^2],
  // in rank order (never E[x^2] - E[x]^2)
  if (threadIdx.x < B) {
    const int b = threadIdx.x;
    float t = 0.0f;
    for (int z = 0; z < splits; ++z) t = __fadd_rn(t, part[z][b].x);
    const float m = __fdiv_rn(t, (float)K);
    float m2 = 0.0f;
    for (int z = 0; z < splits; ++z) {
      const float n = (float)(z < splits - 1 ? chunk : K - z * chunk);
      const float d = __fsub_rn(__fdiv_rn(part[z][b].x, n), m);
      m2 = __fadd_rn(m2, __fadd_rn(part[z][b].y,
                                   __fmul_rn(n, __fmul_rn(d, d))));
    }
    mean[b] = m;
    rstd[b] = rsqrtf(__fadd_rn(__fdiv_rn(m2, (float)K), eps));
  }
  __syncthreads();
  // normalise in place, rounding as the plain version's separate ops; zero
  // the columns past k_hi up to the last piece the loop reads
  for (int c = threadIdx.x; c < padded; c += kGemvThreads) {
    const bool in = c < len;
    const float g = in ? gb[c] : 0.0f, bi = in ? gb[pitch + c] : 0.0f;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < B) {
        float v = 0.0f;
        if (in) {
          const float d =
              __fsub_rn(__bfloat162float(u[b * pitch + c]), mean[b]);
          v = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd[b]), g), bi);
        }
        u[b * pitch + c] = __float2bfloat16(v);
      }
    }
  }
  __syncthreads();
}

// The shipped LN-GEMV (gemv_kernel with LN), its prologue swapped: PRE 0
// the statistics from the L2 rows, 1 the shipped prologue with the first
// steps' weights loaded after it, 2 the two exchanges, 3 the first steps'
// weights issued before x, g and b, 4 the shipped order with the weights
// loaded by __ldg (which the compiler may move past the statistics), 5
// the prologue alone (the kernel ends after it), 6 its loads alone, 7 the
// prologue without its cluster exchange (the block's own statistics), 8
// every thread in the statistics' passes, 9 the shipped prologue with the
// loop the LN-GEMV first shipped with (each iteration's next weights
// issued after its products, where the shipped kernel multiplies the
// first iteration on the prefetched weights and loads every later
// iteration's weights before its products). Bias, scales and epilogue as
// shipped (EPI 0, 1; the first owned quad's loaded before the products).
template <class WL, int BT, int EPI, bool V16, int U, int PRE>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_ln_variant_kernel(const __nv_bfloat16* __restrict__ x,
                       const typename WL::T* __restrict__ W,
                       const float* __restrict__ scale,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y,
                       const float* __restrict__ lng,
                       const float* __restrict__ lnb, int B, int K, int N,
                       int chunk, int pitch, float eps) {
  namespace cg = cooperative_groups;
  constexpr int NB = BT / 8;
  constexpr int STRIDE = kGemvWarps * kGemvStep;
  extern __shared__ __align__(16) float red[];
  __shared__ float4 recv[kGemvRecv];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kGemvCols, col = c0 + 16 * g;
  const int k_lo = rank * chunk, k_hi = min(K, k_lo + chunk);
  const bool col_ok = col < N, hi_ok = V16 || col + 8 < N;
  const int cols = min(kGemvCols, N - c0);
  const int quads = B * (kGemvCols / 4);
  const int m = (quads + splits - 1) / splits;
  // the bias and int8 scales of the first owned quad before the products,
  // as the shipped kernel
  const int own = rank + splits * threadIdx.x;
  uint2 own_b;
  float4 own_s;
  auto quad_in = [&](int i, uint2& bi, float4& sc) {
    const int n = c0 + (i % (kGemvCols / 4)) * 4;
    bi = make_uint2(0u, 0u);
    sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (i >= quads || n >= N) return;
    bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
    if constexpr (WL::kScaled)
      sc = __ldg(reinterpret_cast<const float4*>(scale + n));
  };
  quad_in(own, own_b, own_s);
  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;
  int k0 = k_lo + kGemvStep * warp;
  uint32_t w[U][4][WL::kWords];
  __nv_bfloat16* u =
      reinterpret_cast<__nv_bfloat16*>(red + kGemvWarps * B * kGemvRedPitch);
  float* gb = reinterpret_cast<float*>(u + B * pitch);
  if constexpr (PRE == 0) {
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_prologue_rows(x, lng, lnb, u, pitch, B, K, k_lo, k_hi, eps);
  } else if constexpr (PRE == 1) {
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
    gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
  } else if constexpr (PRE == 2) {
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_prologue_two(x, lng, lnb, u, pitch, B, K, k_lo, k_hi, eps);
  } else if constexpr (PRE == 3) {
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
  } else if constexpr (PRE == 4) {
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
  } else if constexpr (PRE == 5) {  // the prologue alone
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
    return;
  } else if constexpr (PRE == 8) {  // every thread in the passes
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_stats_all<BT>(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
  } else if constexpr (PRE == 9) {  // the shipped prologue
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
  } else if constexpr (PRE == 6) {  // its loads alone
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    return;
  } else {  // without the cluster exchange
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    gemv_ln_stats_local(u, gb, pitch, B, k_lo, k_hi, eps);
    return;
  }
  uint32_t xb[U][NB][2];
  if constexpr (PRE == 9) {  // the next weights after the products
    for (; k0 < k_hi; k0 += U * STRIDE) {
      gemv_load_x<true, NB, U>(x, u, pitch, k0, k_lo, k_hi, B, K, g, q, xb);
      gemv_products<WL, NB, U>(acc, w, xb);
      if (k0 + U * STRIDE < k_hi)
        gemv_load_w<WL, V16, U>(W, k0 + U * STRIDE, k_hi, N, col, col_ok,
                                hi_ok, q, w);
    }
  } else {  // the shipped loop: the first iteration on the weights loaded
    if (k0 < k_hi) {
      gemv_load_x<true, NB, U>(x, u, pitch, k0, k_lo, k_hi, B, K, g, q, xb);
      gemv_products<WL, NB, U>(acc, w, xb);
    }
    for (k0 += U * STRIDE; k0 < k_hi; k0 += U * STRIDE) {
      gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
      gemv_load_x<true, NB, U>(x, u, pitch, k0, k_lo, k_hi, B, K, g, q, xb);
      gemv_products<WL, NB, U>(acc, w, xb);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kGemvRedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();
  if constexpr (PRE == 0)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < quads; i += kGemvThreads) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(red + b * kGemvRedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kGemvWarps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kGemvRedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *cluster.map_shared_rank(&recv[rank * m + i / splits], i % splits) = s;
  }
  cluster.sync();
  for (int j = threadIdx.x; j < m; j += kGemvThreads) {
    const int i = rank + splits * j;
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (i >= quads || c >= cols) continue;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z = 0; z < splits; ++z) {
      const float4 t = recv[z * m + j];
      v[0] += t.x;
      v[1] += t.y;
      v[2] += t.z;
      v[3] += t.w;
    }
    const int n = c0 + c;
    uint2 bi = own_b;
    float4 sc = own_s;
    if (j != threadIdx.x) quad_in(i, bi, sc);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
    const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (WL::kScaled ? v[e] * sv[e] : v[e]) + __bfloat162float(bv[e]);
    gemv_store4<EPI>(v, (size_t)b * N + n, make_uint2(0u, 0u),
                     make_uint2(0u, 0u), nullptr, nullptr, y, 1.0f);
  }
}

// A cluster launch (grid (tiles, splits), a tile's splits one cluster) with
// dynamic shared memory
template <typename Kernel, typename... Args>
cudaError_t launch_clusters_smem(Kernel kernel, dim3 grid, size_t smem,
                                 cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kGemvThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <class WL, int EPI, int PRE>
cudaError_t launch_ln_variant(const void* x, const void* W, const void* s,
                              const void* bias, void* y, const void* g,
                              const void* b, int B, int K, int N, int splits,
                              int chunk, int pitch, cudaStream_t st) {
  const int steps = (chunk + kGemvStep - 1) / kGemvStep;
  const bool two = steps >= 2 * kGemvWarps - 1 && steps <= 2 * kGemvWarps;
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  const size_t smem = gemv_smem(B, pitch);
  auto args = [&](auto kernel) {
    return launch_clusters_smem(
        kernel, grid, smem, st, (const __nv_bfloat16*)x,
        (const typename WL::T*)W, (const float*)s,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, (const float*)g,
        (const float*)b, B, K, N, chunk, pitch, 1e-5f);
  };
  return two ? args(gemv_ln_variant_kernel<WL, 8, EPI, true, 2, PRE>)
             : args(gemv_ln_variant_kernel<WL, 8, EPI, true, 1, PRE>);
}

template <class WL>
int probe_ln(int variant, const void* x, const void* W, const void* s,
             const void* bias, void* y, const void* g, const void* b,
             void* u_ws, int B, int K, int N, int splits, int chunk,
             int pitch, int epi, cudaStream_t st) {
  if (variant == 0) {  // the unfused pair
    ln_rows_kernel<<<B, kThreads, 0, st>>>((const __nv_bfloat16*)x,
                                           (const float*)g, (const float*)b,
                                           (__nv_bfloat16*)u_ws, K, 1e-5f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const GemvArgs a{(const __nv_bfloat16*)u_ws, W, (const float*)s,
                     (const __nv_bfloat16*)bias, nullptr, nullptr, nullptr,
                     nullptr, (__nv_bfloat16*)y, nullptr, nullptr, B, K, N,
                     splits, chunk, 0, 1.0f, 1e-5f};
    return (int)gemv_x_entry<WL>(0, a, epi, st);
  }
  if (B > 8 || N % 16 || K % 4 || epi < 0 || epi > 1 || variant > 10 ||
      pitch < chunk || gemv_smem(B, pitch) > (size_t)kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
  const int pre = variant - 1;
#define JK_LN(E, P)                                                         \
  launch_ln_variant<WL, E, P>(x, W, s, bias, y, g, b, B, K, N, splits,    \
                              chunk, pitch, st)
  cudaError_t e;
  if (epi == 0)
    e = pre == 0 ? JK_LN(0, 0) : pre == 1 ? JK_LN(0, 1)
      : pre == 2 ? JK_LN(0, 2) : pre == 3 ? JK_LN(0, 3)
      : pre == 4 ? JK_LN(0, 4) : pre == 5 ? JK_LN(0, 5)
      : pre == 6 ? JK_LN(0, 6) : pre == 7 ? JK_LN(0, 7)
      : pre == 8 ? JK_LN(0, 8) : JK_LN(0, 9);
  else
    e = pre == 0 ? JK_LN(1, 0) : pre == 1 ? JK_LN(1, 1)
      : pre == 2 ? JK_LN(1, 2) : pre == 3 ? JK_LN(1, 3)
      : pre == 4 ? JK_LN(1, 4) : pre == 5 ? JK_LN(1, 5)
      : pre == 6 ? JK_LN(1, 6) : pre == 7 ? JK_LN(1, 7)
      : pre == 8 ? JK_LN(1, 8) : JK_LN(1, 9);
#undef JK_LN
  return (int)e;
}

}  // namespace

extern "C" int jk_probe_gemv(int variant, int int8, const void* x,
                             const void* W, const void* s, const void* bias,
                             void* y, void* ws, void* counters, int B, int K,
                             int N, int splits, int chunk, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (B > 8 || N % 16 || int8 != (s != nullptr))
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    const size_t smem = (size_t)B * K * sizeof(__nv_bfloat16);
    if (int8 || smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
    static bool cfg4 = false, cfg8 = false;
    auto kern = B <= 4 ? gemv_bf16_old_kernel<4, 0>
                       : gemv_bf16_old_kernel<8, 0>;
    const cudaError_t e = allow_dyn_smem(kern, B <= 4 ? &cfg4 : &cfg8);
    if (e != cudaSuccess) return (int)e;
    kern<<<(N + kBf16Cols - 1) / kBf16Cols, kThreads, smem, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)W,
        (const __nv_bfloat16*)bias, nullptr, nullptr, nullptr, nullptr,
        (__nv_bfloat16*)y, B, K, N, 1.0f);
    return (int)cudaGetLastError();
  }
  return int8 ? probe<I8Weights>(variant, x, W, s, bias, y, ws, counters, B,
                                 K, N, splits, chunk, st)
              : probe<Bf16Weights>(variant, x, W, s, bias, y, ws, counters,
                                   B, K, N, splits, chunk, st);
}

extern "C" int jk_probe_ln_gemv(int variant, int int8, const void* x,
                                const void* W, const void* s,
                                const void* bias, void* y, const void* g,
                                const void* b, void* u_ws, int B, int K,
                                int N, int splits, int chunk, int pitch,
                                int epi, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (int8 != (s != nullptr)) return (int)cudaErrorInvalidValue;
  return int8 ? probe_ln<I8Weights>(variant, x, W, s, bias, y, g, b, u_ws, B,
                                    K, N, splits, chunk, pitch, epi, st)
              : probe_ln<Bf16Weights>(variant, x, W, s, bias, y, g, b, u_ws,
                                      B, K, N, splits, chunk, pitch, epi, st);
}

extern "C" int jk_probe_gemv_x(int variant, int int8, const void* x,
                               const void* W, const void* s,
                               const void* bias, const void* res, void* y,
                               int B, int K, int N, int splits, int chunk,
                               int epi, void* stream) {
  if (int8 != (s != nullptr) || splits < 1 || splits > kGemvMaxSplits ||
      chunk < kGemvStep || chunk % kGemvStep ||
      (long)(splits - 1) * chunk >= K || (long)splits * chunk < K)
    return (int)cudaErrorInvalidValue;
  const GemvArgs a{(const __nv_bfloat16*)x, W, (const float*)s,
                   (const __nv_bfloat16*)bias, (const __nv_bfloat16*)res,
                   nullptr, nullptr, nullptr, (__nv_bfloat16*)y, nullptr,
                   nullptr, B, K, N, splits, chunk, 0, 1.0f, 1e-5f};
  const auto st = (cudaStream_t)stream;
  return (int)(int8 ? gemv_x_entry<I8Weights>(variant, a, epi, st)
                    : gemv_x_entry<Bf16Weights>(variant, a, epi, st));
}
