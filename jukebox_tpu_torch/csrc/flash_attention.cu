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
// bytes (~10 us at 3.35 TB/s). This first design is simple, not fast: one
// block of 8 warps per (bh, tile), nvcuda::wmma 16x16x16 bf16 products with
// fp32 accumulators, operand tiles staged in shared memory by 16-byte loads,
// the fp32 accumulator (O, dQ or dK/dV) kept in shared memory, and the
// softmax/dropout pass done by plain threads between the products. No
// cp.async/TMA pipelining, no wgmma, one block per SM at hd 256; those are
// the next steps.
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

// tile rows: forward (q, kv), dq (q, kv), dkv (q, kv)
constexpr int kFwdBQ = 64, kFwdBK = 64;
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
// forward: one block per (q tile, bh); loops over the kv tiles on or below
// the diagonal with an online softmax.
// ---------------------------------------------------------------------------

constexpr int fwd_smem(int hdp) {
  return (kFwdBQ + 2 * kFwdBK) * (hdp + kPadH) * 2   // Q, K, V
         + kFwdBQ * (hdp + kPadF) * 4                // O accumulator
         + kFwdBQ * (kFwdBK + kPadF) * 4             // S
         + kFwdBQ * (kFwdBK + kPadH) * 2             // P (bf16)
         + 3 * kFwdBQ * 4;                           // m, l, alpha
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int L, int hd, float scale,
                     Dropout drop) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, RPW = BQ / kWarps;
  const int hdp = round16(hd), ldh = hdp + kPadH, ldo = hdp + kPadF;
  constexpr int lds = BK + kPadF, ldp = BK + kPadH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ldh;
  bf16* Vs = Ks + BK * ldh;
  float* Os = reinterpret_cast<float*>(Vs + BK * ldh);
  float* Ss = Os + BQ * ldo;
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * lds);
  float* m_s = reinterpret_cast<float*>(Ps + BQ * ldp);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bh * L * hd;
  q += base; k += base; v += base; out += base;

  load_tile(Qs, ldh, q, q0, BQ, L, hd, hdp);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) Os[i] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.0f;
  }
  const int n_kv = min(q0 + BQ - 1, L - 1) / BK + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BK;
    __syncthreads();  // the previous tile's products are done with K, V, P
    load_tile(Ks, ldh, k, kv0, BK, L, hd, hdp);
    load_tile(Vs, ldh, v, kv0, BK, L, hd, hdp);
    __syncthreads();
    mma_tiles<false, true>(Ss, lds, Qs, ldh, Ks, ldh, BQ, BK, hdp, false);
    __syncthreads();
    // online softmax: each warp owns RPW rows, each lane two columns
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, qp = q0 + r;
      float s[2], mx = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float x = Ss[r * lds + c] * scale;
        if (qp < kv0 + c) x = kNeg;
        s[h] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float p = expf(s[h] - m_new);
        sum += p;
        if (drop.on) p = kept(drop, bh, qp, kv0 + c) ? p * drop.inv_keep : 0.0f;
        Ps[r * ldp + c] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * hdp; i += kThreads) {
      const int r = i / hdp, c = i % hdp;
      Os[r * ldo + c] *= a_s[r];
    }
    __syncthreads();
    mma_tiles<false, false>(Os, ldo, Ps, ldp, Vs, ldh, BQ, hdp, BK, true);
  }
  __syncthreads();
  store_rows(out, Os, ldo, q0, BQ, L, hd, l_s);
  for (int r = threadIdx.x; r < BQ; r += kThreads)
    if (q0 + r < L) lse[(size_t)bh * L + q0 + r] = m_s[r] + logf(l_s[r]);
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

}  // namespace

extern "C" {

// Dynamic shared memory of a block at head width hd: kernel 0 forward,
// 1 dq, 2 dk/dv.
int jk_flash_smem(int kernel, int hd) {
  const int hdp = round16(hd);
  return kernel == 0 ? fwd_smem(hdp) : kernel == 1 ? dq_smem(hdp)
                                                   : dkv_smem(hdp);
}

int jk_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int L, int hd, float scale, int dropout,
                 unsigned seed, unsigned thresh, float inv_keep,
                 void* stream) {
  if (bad_shape(BH, L, hd)) return (int)cudaErrorInvalidValue;
  const int smem = fwd_smem(round16(hd));
  cudaError_t e = set_smem(flash_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kFwdBQ - 1) / kFwdBQ, BH);
  flash_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, L, hd, scale, make_dropout(dropout, seed, thresh, inv_keep));
  return (int)cudaGetLastError();
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
