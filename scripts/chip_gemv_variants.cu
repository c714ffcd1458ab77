// Design alternatives of gemv_int8, for scripts/chip_gemv_ln_probe.py only:
// nothing in the package builds this file. It includes the package's
// decode-step kernels (so one nvcc run builds the shipped kernel beside
// these) and adds:
//   gemv_int8_ring_kernel  the same products, conversion, combine and plan
//                          (chunk <= kI8MaxChunk), but each block's slice
//                          streamed through a ring of 64-row stages in
//                          shared memory by cp.async (16-byte copies, x's
//                          rows whole beside it, three stages in flight,
//                          two barriers a stage) instead of into
//                          registers;
//   gemv_int8_u_kernel     the shipped kernel with 3 or 4 steps (12 or 16
//                          loads of 16 bytes a lane) in flight a warp, at
//                          3 blocks an SM;
//   gemv_loads_kernel      the shipped kernel's loads alone (its loop with
//                          the products replaced by an xor of the loaded
//                          words): what streaming the weights costs;
//   gemv_empty_kernel      the shipped grid, no work: what the launch and
//                          the block dispatch cost.
// Entry: jk_probe_gemv(variant, <jk_gemv_int8's arguments>) with variant
// 0 ring, 1 loads, 2 empty, 3 four steps in flight, 4 three; B <= 8, no
// epilogue, N % 16 == 0.

#include "../jukebox_tpu_torch/csrc/decode_stack.cu"

namespace {

constexpr int kI8Stage = kI8Warps * kI8Step;  // rows of one stage
constexpr int kI8Ring = 3;                     // stages in flight
constexpr int kI8MaxChunk = 768;  // x's rows in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `BYTES` (16 or 8) global -> shared, zero-filled when !pred
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(pred ? 8 : 0));
}

// The 16-byte segment of ring row r where its columns 16 seg .. + 15 live:
// a step's lanes (g, q) read segment g of rows 4q + 0..3, and a quarter
// warp (g = 2p, 2p + 1; q = 0..3) then meets 8 distinct segments (g ^ 2q),
// so each 16-byte read takes the fewest shared-memory wavefronts
__device__ __forceinline__ int i8_swizzle(int r, int seg) {
  return seg ^ (((r >> 2) & 3) << 1);
}

// x's pitch in shared memory (bf16): 128 m + 32 bytes, so the 8-byte reads
// of one step (8 batch rows x 4 offsets) hit distinct banks
__host__ __device__ __forceinline__ int i8_xpitch(int chunk) {
  return (chunk + 63) / 64 * 64 + 16;
}

// Dynamic shared memory of one gemv_int8 block (bytes): the weight ring,
// reused for the warps' sums, then x's rows
__host__ __device__ __forceinline__ size_t i8_smem(int B, int chunk) {
  const size_t ring = (size_t)kI8Ring * kI8Stage * kI8Cols;
  const size_t red = (size_t)kI8Warps * B * kI8RedPitch * sizeof(float);
  return (ring > red ? ring : red) + (size_t)B * i8_xpitch(chunk) * 2;
}

template <int BT, int EPI, bool V16>
__global__ void __launch_bounds__(kI8Threads, 4)
gemv_int8_ring_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ W,
                 const float* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ res,
                 const __nv_bfloat16* __restrict__ res2,
                 __nv_bfloat16* __restrict__ aux, float* __restrict__ y32,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                 int* __restrict__ counters, int B, int K, int N, int chunk,
                 float rs) {
  constexpr int NB = BT / 8;  // mmas per column pair (8 batch rows each)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x, splits = gridDim.y;
  const int c0 = tile * kI8Cols;
  const int k_lo = blockIdx.y * chunk, rows = min(K - k_lo, chunk);
  const int steps = (rows + kI8Step - 1) / kI8Step;
  const int stages = (rows + kI8Stage - 1) / kI8Stage;
  const int xp = i8_xpitch(chunk);
  float* red = reinterpret_cast<float*>(smem);  // [warp][b][kI8RedPitch]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      smem + i8_smem(B, chunk) - (size_t)B * xp * 2);  // [b][xp]

  // x's rows, zero past the slice: 16 bytes a copy where K % 8 == 0
  // (each row's piece then starts 16-byte aligned), else element by element
  if (K % 8 == 0) {
    const int segs = steps * kI8Step / 8;
    for (int i = threadIdx.x; i < B * segs; i += kI8Threads) {
      const int b = i / segs, r = (i % segs) * 8;
      cp_async<16>(xs + b * xp + r,
                   r < rows ? x + (size_t)b * K + k_lo + r : x, r < rows);
    }
  } else {
    for (int i = threadIdx.x; i < B * steps * kI8Step; i += kI8Threads) {
      const int b = i / (steps * kI8Step), r = i % (steps * kI8Step);
      xs[b * xp + r] = r < rows ? x[(size_t)b * K + k_lo + r]
                                : __float2bfloat16(0.0f);
    }
  }
  // stage sg into ring buffer sg % kI8Ring: 8 copies of 16 bytes a row;
  // rows past the slice stay unwritten (their x is zero, and int8 values
  // are finite). One cp.async group per stage, empty past the last.
  auto issue = [&](int sg) {
    unsigned char* buf = smem + (sg % kI8Ring) * kI8Stage * kI8Cols;
    const int r_lo = sg * kI8Stage, r_hi = min(rows, r_lo + kI8Stage);
    for (int i = r_lo * 8 + threadIdx.x; i < r_hi * 8; i += kI8Threads) {
      const int r = i >> 3, n = c0 + (i & 7) * 16;
      unsigned char* dst =
          buf + (r - r_lo) * kI8Cols + i8_swizzle(r, i & 7) * 16;
      const int8_t* src = W + (size_t)(k_lo + r) * N + n;
      if (V16) {
        cp_async<16>(dst, n < N ? src : W, n < N);
      } else {
        cp_async<8>(dst, n < N ? src : W, n < N);
        cp_async<8>(dst + 8, n + 8 < N ? src + 8 : W, n + 8 < N);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int sg = 0; sg < kI8Ring; ++sg) issue(sg);

  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;

  for (int sg = 0; sg < stages; ++sg) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kI8Ring - 1));
    __syncthreads();  // stage sg has landed for every thread
    const int st = sg * kI8Warps + warp;  // this warp's step of the slice
    if (st < steps) {
      const unsigned char* buf = smem + (sg % kI8Ring) * kI8Stage * kI8Cols;
      uint32_t w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * kI8Step + 4 * q + r;  // within the stage
        const uint4 v = *reinterpret_cast<const uint4*>(
            buf + row * kI8Cols + i8_swizzle(row, g) * 16);
        w[r][0] = v.x;
        w[r][1] = v.y;
        w[r][2] = v.z;
        w[r][3] = v.w;
      }
      uint32_t xb[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int b = g + 8 * nb;
        const uint2 v =
            b < B ? *reinterpret_cast<const uint2*>(xs + b * xp +
                                                    st * kI8Step + 4 * q)
                  : make_uint2(0u, 0u);
        xb[nb][0] = v.x;
        xb[nb][1] = v.y;
      }
      i8_mma<0>(acc, w, xb);
      i8_mma<1>(acc, w, xb);
      i8_mma<2>(acc, w, xb);
      i8_mma<3>(acc, w, xb);
      i8_mma<4>(acc, w, xb);
      i8_mma<5>(acc, w, xb);
      i8_mma<6>(acc, w, xb);
      i8_mma<7>(acc, w, xb);
    }
    __syncthreads();  // every warp is done with buffer sg % kI8Ring
    issue(sg + kI8Ring);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();  // the ring takes the warps' sums

  // acc[nb][j][e]: column 16 g + 2j + (e >> 1), batch row 8 nb + 2q + (e & 1)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kI8RedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();

  // 4 columns a thread from here on: cols is a multiple of 8
  const int cols = min(kI8Cols, N - c0);
  const int quads = B * (kI8Cols / 4);
  for (int i = threadIdx.x; i < quads; i += kI8Threads) {
    const int b = i / (kI8Cols / 4), c = (i % (kI8Cols / 4)) * 4;
    if (c >= cols) continue;
    float4 s = *reinterpret_cast<const float4*>(red + b * kI8RedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kI8Warps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kI8RedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int n = c0 + c;
    if (splits == 1) {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gemv_store<EPI>(v[e] * scale[n + e] + __bfloat162float(bias[n + e]),
                        (size_t)b * N + n + e, res, res2, aux, y32, y, rs);
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
  for (int i = threadIdx.x; i < quads; i += kI8Threads) {
    const int b = i / (kI8Cols / 4), c = (i % (kI8Cols / 4)) * 4;
    if (c >= cols) continue;
    const int n = c0 + c;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
    const uint2 bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
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
    const float svec[4] = {sc.x, sc.y, sc.z, sc.w};
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gemv_store<EPI>(v[e] * svec[e] + __bfloat162float(bv[e]),
                      (size_t)b * N + n + e, res, res2, aux, y32, y, rs);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}


// The shipped kernel with UU steps in flight a warp and MINB blocks an SM
// (the shipped: 2 and 4)
template <int BT, int EPI, bool V16, int UU, int MINB>
__global__ void __launch_bounds__(kI8Threads, MINB)
gemv_int8_u_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ W,
                 const float* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ res,
                 const __nv_bfloat16* __restrict__ res2,
                 __nv_bfloat16* __restrict__ aux, float* __restrict__ y32,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                 int* __restrict__ counters, int B, int K, int N, int chunk,
                 float rs) {
  constexpr int NB = BT / 8;          // mmas per column pair (8 batch rows)
  constexpr int U = UU;  // steps in flight per warp
  constexpr int STRIDE = kI8Warps * kI8Step;
  __shared__ __align__(16) float red[kI8Warps * BT * kI8RedPitch];
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x, splits = gridDim.y;
  const int c0 = tile * kI8Cols, col = c0 + 16 * g;
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

  for (int k0 = k_lo + kI8Step * warp; k0 < k_hi; k0 += U * STRIDE) {
    uint32_t w[U][4][4];    // [step][row k + 4q + r][4 bytes]
    uint32_t xb[U][NB][2];  // x[b][k + 4q .. + 3] as two bf16 pairs
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col_ok && k + r < k_hi) {
          const int8_t* p = W + (size_t)(k + r) * N + col;
          if (V16) {
            v = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
            v.x = lo.x;
            v.y = lo.y;
            if (hi_ok) {
              const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 8));
              v.z = hi.x;
              v.w = hi.y;
            }
          }
        }
        w[u][r][0] = v.x;
        w[u][r][1] = v.y;
        w[u][r][2] = v.z;
        w[u][r][3] = v.w;
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
      i8_mma<0>(acc, w[u], xb[u]);
      i8_mma<1>(acc, w[u], xb[u]);
      i8_mma<2>(acc, w[u], xb[u]);
      i8_mma<3>(acc, w[u], xb[u]);
      i8_mma<4>(acc, w[u], xb[u]);
      i8_mma<5>(acc, w[u], xb[u]);
      i8_mma<6>(acc, w[u], xb[u]);
      i8_mma<7>(acc, w[u], xb[u]);
    }
  }

  // acc[nb][j][e]: column 16 g + 2j + (e >> 1), batch row 8 nb + 2q + (e & 1)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kI8RedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();

  // 4 columns a thread from here on: cols is a multiple of 8
  const int cols = min(kI8Cols, N - c0);
  const int quads = B * (kI8Cols / 4);
  for (int i = threadIdx.x; i < quads; i += kI8Threads) {
    const int b = i / (kI8Cols / 4), c = (i % (kI8Cols / 4)) * 4;
    if (c >= cols) continue;
    float4 s = *reinterpret_cast<const float4*>(red + b * kI8RedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kI8Warps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kI8RedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const int n = c0 + c;
    if (splits == 1) {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gemv_store<EPI>(v[e] * scale[n + e] + __bfloat162float(bias[n + e]),
                        (size_t)b * N + n + e, res, res2, aux, y32, y, rs);
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
  for (int i = threadIdx.x; i < quads; i += kI8Threads) {
    const int b = i / (kI8Cols / 4), c = (i % (kI8Cols / 4)) * 4;
    if (c >= cols) continue;
    const int n = c0 + c;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
    const uint2 bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
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
    const float svec[4] = {sc.x, sc.y, sc.z, sc.w};
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gemv_store<EPI>(v[e] * svec[e] + __bfloat162float(bv[e]),
                      (size_t)b * N + n + e, res, res2, aux, y32, y, rs);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}


__global__ void __launch_bounds__(kI8Threads, 4)
gemv_loads_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ W, __nv_bfloat16* __restrict__ y,
                  int B, int K, int N, int chunk) {
  constexpr int U = 2, STRIDE = kI8Warps * kI8Step;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int col = blockIdx.x * kI8Cols + 16 * g;
  const int k_lo = blockIdx.y * chunk, k_hi = min(K, k_lo + chunk);
  uint32_t fold = 0;
  for (int k0 = k_lo + kI8Step * warp; k0 < k_hi; k0 += U * STRIDE) {
    uint4 v[U][4];
    uint2 xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[u][r] = col < N && k + r < k_hi
                      ? __ldg(reinterpret_cast<const uint4*>(
                            W + (size_t)(k + r) * N + col))
                      : make_uint4(0u, 0u, 0u, 0u);
      xv[u] = g < B && k < k_hi ? __ldg(reinterpret_cast<const uint2*>(
                                      x + (size_t)g * K + k))
                                : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fold ^= v[u][r].x ^ v[u][r].y ^ v[u][r].z ^ v[u][r].w;
      fold ^= xv[u].x ^ xv[u].y;
    }
  }
  if (fold == 0x9e3779b9u && blockIdx.x == 0xffff)  // keeps the loads
    y[threadIdx.x] = __float2bfloat16(1.0f);
}

__global__ void __launch_bounds__(kI8Threads, 4) gemv_empty_kernel() {}

}  // namespace

extern "C" int jk_probe_gemv(int variant, const void* x, const void* W,
                             const void* s, const void* bias, const void* res,
                             const void* res2, void* aux, void* y32, void* y,
                             void* ws, void* counters, int B, int K, int N,
                             int splits, int chunk, int epi, int vec16,
                             float rs, void* stream) {
  if (B > 8 || epi != 0 || !vec16 || chunk > kI8MaxChunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kI8Cols - 1) / kI8Cols, splits);
  const auto st = (cudaStream_t)stream;
  static bool configured = false;
  cudaError_t e = cudaSuccess;
  if (variant == 0) {
    e = allow_dyn_smem(gemv_int8_ring_kernel<8, 0, true>, &configured);
    if (e == cudaSuccess)
      gemv_int8_ring_kernel<8, 0, true>
          <<<grid, kI8Threads, i8_smem(B, chunk), st>>>(
              (const __nv_bfloat16*)x, (const int8_t*)W, (const float*)s,
              (const __nv_bfloat16*)bias, nullptr, nullptr, nullptr,
              (float*)y32, (__nv_bfloat16*)y, (float*)ws, (int*)counters, B,
              K, N, chunk, rs);
  } else if (variant == 1) {
    gemv_loads_kernel<<<grid, kI8Threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)W, (__nv_bfloat16*)y, B, K,
        N, chunk);
  } else if (variant == 2) {
    gemv_empty_kernel<<<grid, kI8Threads, 0, st>>>();
  } else if (variant == 3 || variant == 4) {
    auto kern = variant == 3 ? gemv_int8_u_kernel<8, 0, true, 4, 3>
                             : gemv_int8_u_kernel<8, 0, true, 3, 3>;
    kern<<<grid, kI8Threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)W, (const float*)s,
        (const __nv_bfloat16*)bias, nullptr, nullptr, nullptr, (float*)y32,
        (__nv_bfloat16*)y, (float*)ws, (int*)counters, B, K, N, chunk, rs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}
