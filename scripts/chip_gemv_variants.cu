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
//   gemv_empty_kernel      a grid with no work: the launch and dispatch.
// Entry: jk_probe_gemv(variant, int8, ...) with variant 0 the old bf16
// design (bf16 only; splits, chunk, ws and counters unused), 1 loads
// alone, 2 empty, 3 and 9 the shipped kernel with two and one steps in
// flight a lane whatever the split, 4 the global combine (int8: as
// shipped before), 5 the global combine with three steps at 3 blocks an
// SM, 6 the cluster read after the barrier, 7 its products alone, 8 its
// products and barrier. B <= 8, no epilogue, N % 16 == 0, K % 4 == 0 for
// the cluster variants.

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
                       nullptr, nullptr, yb, B, K, N, splits, chunk, 1.0f};
      return (int)(variant == 3 ? launch_gemv<WL, 8, 0, true, 2>(a, st)
                                : launch_gemv<WL, 8, 0, true, 1>(a, st));
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
