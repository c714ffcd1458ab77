// Decode-step kernels for Hopper (sm_90a): bf16 activations, bf16 or
// weight-only int8 weights, bf16 or int8 ring caches.
//
// Replace: jukebox_tpu/ops/pallas/decode_stack.py::build_stack_decode
// (the whole-stack Pallas megakernel, body `_kernel`), in all its options:
// bf16 or `quantized` int8 weights, bf16 or `cache_quantized` int8 caches,
// f6 cross-attention against a read-only encoder cache, every head width
// (its sliced / masked / matmul head modes are Mosaic layouts of one piece
// of math: here one block per (batch row, head) serves them all) and
// `res_scale`. That kernel runs one token through a segment of layers in
// one launch; here the same per-layer arithmetic runs as kernels launched
// per layer:
//
//   ln_rows      LayerNorm of [B, S], fp32 statistics, eps given, fp32
//                gain/bias, bf16 out. One block per row.
//   gemv         y[B, N] = epilogue(x[B, K] @ W[K, N] (* s[N]) + b), W in
//                the JAX (in, out) layout, fp32 accumulation: gemv_bf16
//                (W bf16) and gemv_int8 (W int8 with one fp32 scale per
//                output column, applied after the accumulation, as the
//                megakernel's piece_mm does). Serves c_attn (qkv, or q
//                alone in f6 layers), c_proj (+ residual), mlp c_fc
//                (+ quick_gelu) and mlp c_proj (+ residual, or the
//                res_scale residual x + (a + m) * res_scale).
//   attn         one token of one layer against its cache, one block per
//                (batch row, head): ring_attn_decode (bf16 ring: write the
//                token's k, v into its slot, masked scores over the live
//                rows, fp32 softmax, bf16-rounded weights x V);
//                ring_attn_int8 (int8 ring with one bf16 scale per
//                (batch row, slot): the new row is quantised on write,
//                absmax over A / 127 floored at 1e-8, int8 = round(k * (1 /
//                scale)), the bf16-rounded scale stored; on read the scales
//                fold into the scores and the softmax weights, and the
//                current token's own score and value use its unquantised
//                k and v, as the megakernel's sc_new / w_ins patch does);
//                cross_attn_decode (f6: a q-only query against the read-only
//                encoder K/V, bf16 or int8, nothing written).
//
// What bounds them on an H100: a decode step at batch <= 16 does ~2 flops
// per weight byte (~4 in int8), far below the ~295 flop/byte ridge, so the
// GEMVs are bound by streaming W from HBM (one read of every weight per
// token step; int8 halves the bytes). Their design: each block owns a slice
// of N (16 columns in bf16, 32 in int8, so a row of the slice is one
// 32-byte sector), every thread streams 8 weights per load, x stays in
// shared memory as bf16, and the K split inside the block is reduced with
// warp shuffles and one shared-memory pass. The attention kernels are bound
// by the cache rows they read (the f0 dense layers read t+1 rows, f6 the
// 512 encoder rows); they read each live row once for the scores and once
// for the values, q (and the new k, v) taken from the GEMV output with its
// row stride (no copy). ln_rows is bound by launch latency at these sizes.
// Fusing LN into the GEMV, a persistent whole-stack kernel, CUDA graphs,
// wgmma/TMA and splitting the attention rows over more blocks are later
// work.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError(); the Python wrappers
// (jukebox_tpu_torch/ops/decode_stack.py) check shapes, types and layout,
// allocate outputs, and raise on a non-zero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Block-wide sum / max for kThreads threads; every thread gets the result.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < kWarps ? scratch[lane] : 0.0f;
    r = warp_sum(r);
    if (lane == 0) scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < kWarps ? scratch[lane] : -INFINITY;
    r = warp_max(r);
    if (lane == 0) scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// ln_rows: one block per row of x [rows, S].
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

// ---------------------------------------------------------------------------
// gemv: block = 256 threads over a slice of 8 * TPR columns of N. Thread
// (tx = tid % TPR, ky = tid / TPR) accumulates columns n0 + tx*8 .. +7 over
// the rows k = ky, ky + 256 / TPR, ... of W, 8 weights per load (16 bytes of
// bf16, TPR = 2; 8 bytes of int8, TPR = 4). BT is the batch bucket (>= B).
// EPI: 0 none, 1 quick_gelu, 2 residual (out = res + bf16(y); aux, when
// given, also receives bf16(y)), 3 res_scale (out = res + bf16(bf16(res2 +
// bf16(y)) * bf16(rs)), the bf16 roundings of x + (a + m) * res_scale).
// ---------------------------------------------------------------------------
template <typename WT>
struct WLoad;

template <>
struct WLoad<__nv_bfloat16> {
  static constexpr int kTPR = 2;
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float* wf) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(w2[j]);
      wf[2 * j] = f.x;
      wf[2 * j + 1] = f.y;
    }
  }
};

template <>
struct WLoad<int8_t> {
  static constexpr int kTPR = 4;
  static __device__ __forceinline__ void load8(const int8_t* p, float* wf) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* w1 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) wf[j] = static_cast<float>(w1[j]);
  }
};

template <typename WT, int BT, int EPI>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __nv_bfloat16* __restrict__ x, const WT* __restrict__ W,
            const float* __restrict__ scale,
            const __nv_bfloat16* __restrict__ bias,
            const __nv_bfloat16* __restrict__ res,
            const __nv_bfloat16* __restrict__ res2,
            __nv_bfloat16* __restrict__ aux, __nv_bfloat16* __restrict__ y,
            int B, int K, int N, float rs) {
  constexpr int TPR = WLoad<WT>::kTPR;
  constexpr int COLS = 8 * TPR;
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
      WLoad<WT>::load8(W + (size_t)k * N + n0, wf);
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
    if constexpr (std::is_same<WT, int8_t>::value) s *= scale[n];
    s += __bfloat162float(bias[n]);
    const size_t at = (size_t)bb * N + n;
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
}

// ---------------------------------------------------------------------------
// attn_kernel: grid (B, H), one token of one layer. Caches k/v [B, R, A]
// (CT = bf16, or int8 with bf16 row scales ks/vs [B, R]); q row b at
// q + b * qstride; the token's new k, v (rows of the same stride) are
// written to slot w (w < 0: no write, knew may be null); the live rows are
// r0 .. r0 + n - 1. INT8: the slot row, when live, is read from the
// unquantised knew / vnew instead of the cache. Dynamic shared memory:
// q [hd] | scores [n] | per-warp partial outputs [kWarps][hd], all fp32.
// ---------------------------------------------------------------------------
constexpr int kMaxPairsPerLane = 8;  // hd <= 2 * 32 * 8 = 512

template <bool INT8>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const __nv_bfloat16* __restrict__ q, int qstride,
            const __nv_bfloat16* __restrict__ knew,
            const __nv_bfloat16* __restrict__ vnew,
            typename std::conditional<INT8, int8_t, __nv_bfloat16>::type* kc,
            typename std::conditional<INT8, int8_t, __nv_bfloat16>::type* vc,
            __nv_bfloat16* __restrict__ ks, __nv_bfloat16* __restrict__ vs,
            __nv_bfloat16* __restrict__ o, int A, int H, int R, int r0, int n,
            int w, float scale) {
  using CT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  using CT2 = typename std::conditional<INT8, char2, __nv_bfloat162>::type;
  extern __shared__ float sm[];
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x, h = blockIdx.y, hd = A / H, hd2 = hd / 2;
  float* qs = sm;
  float* sc = sm + hd;
  float* part = sc + n;
  const int ins = (INT8 && w >= r0 && w < r0 + n) ? w - r0 : -1;

  const __nv_bfloat16* qrow = q + (size_t)b * qstride + h * hd;
  CT* kb = kc + (size_t)b * R * A + h * hd;
  CT* vb = vc + (size_t)b * R * A + h * hd;
  const __nv_bfloat16* kn = w >= 0 ? knew + (size_t)b * qstride : nullptr;
  const __nv_bfloat16* vn = w >= 0 ? vnew + (size_t)b * qstride : nullptr;

  for (int d = threadIdx.x; d < hd; d += kThreads)
    qs[d] = __bfloat162float(qrow[d]) * scale;
  if (w >= 0) {
    if constexpr (INT8) {
      // the row's scale is over all A columns (every head's block derives
      // the same one); each block writes its own head's columns
      float km = 0.0f, vm = 0.0f;
      for (int i = threadIdx.x; i < A; i += kThreads) {
        km = fmaxf(km, fabsf(__bfloat162float(kn[i])));
        vm = fmaxf(vm, fabsf(__bfloat162float(vn[i])));
      }
      km = block_max(km, scratch);
      vm = block_max(vm, scratch);
      const float ksc = fmaxf(km / 127.0f, 1e-8f);
      const float vsc = fmaxf(vm / 127.0f, 1e-8f);
      const float kinv = 1.0f / ksc, vinv = 1.0f / vsc;
      for (int d = threadIdx.x; d < hd; d += kThreads) {
        const float kq = rintf(__bfloat162float(kn[h * hd + d]) * kinv);
        const float vq = rintf(__bfloat162float(vn[h * hd + d]) * vinv);
        kb[(size_t)w * A + d] = (CT)(int)fminf(fmaxf(kq, -127.0f), 127.0f);
        vb[(size_t)w * A + d] = (CT)(int)fminf(fmaxf(vq, -127.0f), 127.0f);
      }
      if (h == 0 && threadIdx.x == 0) {
        ks[(size_t)b * R + w] = __float2bfloat16(ksc);
        vs[(size_t)b * R + w] = __float2bfloat16(vsc);
      }
    } else {
      for (int d = threadIdx.x; d < hd; d += kThreads) {
        kb[(size_t)w * A + d] = *reinterpret_cast<const CT*>(&kn[h * hd + d]);
        vb[(size_t)w * A + d] = *reinterpret_cast<const CT*>(&vn[h * hd + d]);
      }
    }
  }
  __syncthreads();  // the slot write is visible to the reads below

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < n; l += kWarps) {
    float s = 0.0f;
    if (l == ins) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(kn + h * hd);
      for (int d2 = lane; d2 < hd2; d2 += 32) {
        const float2 kf = __bfloat1622float2(kr[d2]);
        s = fmaf(qs[2 * d2], kf.x * scale, s);
        s = fmaf(qs[2 * d2 + 1], kf.y * scale, s);
      }
      s = warp_sum(s);
    } else {
      const CT2* kr = reinterpret_cast<const CT2*>(kb + (size_t)(r0 + l) * A);
      for (int d2 = lane; d2 < hd2; d2 += 32) {
        if constexpr (INT8) {
          const CT2 kv = kr[d2];
          s = fmaf(qs[2 * d2], (float)kv.x, s);
          s = fmaf(qs[2 * d2 + 1], (float)kv.y, s);
        } else {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&kr[d2]));
          s = fmaf(qs[2 * d2], kf.x * scale, s);
          s = fmaf(qs[2 * d2 + 1], kf.y * scale, s);
        }
      }
      s = warp_sum(s);
      if constexpr (INT8)
        s *= __bfloat162float(ks[(size_t)b * R + r0 + l]) * scale;
    }
    if (lane == 0) sc[l] = s;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int l = threadIdx.x; l < n; l += kThreads) m = fmaxf(m, sc[l]);
  m = block_max(m, scratch);
  float sum = 0.0f;
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const float e = expf(sc[l] - m);
    sc[l] = e;
    sum += e;
  }
  sum = block_sum(sum, scratch);  // ends in __syncthreads: sc[] is complete
  for (int l = threadIdx.x; l < n; l += kThreads) {
    const float p = sc[l] / sum;
    if constexpr (INT8)  // fp32 weights; the V row scales fold into them
      sc[l] = l == ins ? p : p * __bfloat162float(vs[(size_t)b * R + r0 + l]);
    else
      sc[l] = bf16_round(p);  // weights cast to bf16 before PV
  }
  __syncthreads();

  float2 acc[kMaxPairsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) acc[i] = make_float2(0.0f, 0.0f);
  for (int l = warp; l < n; l += kWarps) {
    const float p = sc[l];
    const bool fresh = l == ins;
    const __nv_bfloat162* vnr =
        reinterpret_cast<const __nv_bfloat162*>(vn + h * hd);
    const CT2* vr = reinterpret_cast<const CT2*>(vb + (size_t)(r0 + l) * A);
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int d2 = lane + 32 * i;
      if (d2 < hd2) {
        float2 vf;
        if (fresh) {
          vf = __bfloat1622float2(vnr[d2]);
        } else if constexpr (INT8) {
          const CT2 vv = vr[d2];
          vf = make_float2((float)vv.x, (float)vv.y);
        } else {
          vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&vr[d2]));
        }
        acc[i].x = fmaf(p, vf.x, acc[i].x);
        acc[i].y = fmaf(p, vf.y, acc[i].y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) {
    const int d2 = lane + 32 * i;
    if (d2 < hd2) {
      part[warp * hd + 2 * d2] = acc[i].x;
      part[warp * hd + 2 * d2 + 1] = acc[i].y;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s += part[ww * hd + d];
    o[(size_t)b * A + h * hd + d] = __float2bfloat16(s);
  }
}

constexpr int kMaxDynSmem = 200 * 1024;

template <typename K>
cudaError_t allow_dyn_smem(K kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (e == cudaSuccess) *configured = true;
  return e;
}

// The pointers and sizes of one GEMV launch.
template <typename WT>
struct GemvArgs {
  const __nv_bfloat16* x;
  const WT* W;
  const float* s;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  const __nv_bfloat16* res2;
  __nv_bfloat16* aux;
  __nv_bfloat16* y;
  int B, K, N;
  float rs;
};

template <typename WT, int BT, int EPI>
cudaError_t launch_gemv(const GemvArgs<WT>& a, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t e = allow_dyn_smem(gemv_kernel<WT, BT, EPI>, &configured);
  if (e != cudaSuccess) return e;
  constexpr int COLS = 8 * WLoad<WT>::kTPR;
  const size_t smem = (size_t)a.B * a.K * sizeof(__nv_bfloat16);
  const int grid = (a.N + COLS - 1) / COLS;
  gemv_kernel<WT, BT, EPI><<<grid, kThreads, smem, stream>>>(
      a.x, a.W, a.s, a.bias, a.res, a.res2, a.aux, a.y, a.B, a.K, a.N, a.rs);
  return cudaGetLastError();
}

template <typename WT, int BT>
cudaError_t launch_gemv_epi(int epi, const GemvArgs<WT>& a,
                            cudaStream_t st) {
  switch (epi) {
    case 0: return launch_gemv<WT, BT, 0>(a, st);
    case 1: return launch_gemv<WT, BT, 1>(a, st);
    case 2: return launch_gemv<WT, BT, 2>(a, st);
    case 3: return launch_gemv<WT, BT, 3>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename WT>
int gemv_entry(const void* x, const void* W, const void* s, const void* bias,
               const void* res, const void* res2, void* aux, void* y, int B,
               int K, int N, int epi, float rs, void* stream) {
  const GemvArgs<WT> a{(const __nv_bfloat16*)x, (const WT*)W,
                       (const float*)s, (const __nv_bfloat16*)bias,
                       (const __nv_bfloat16*)res, (const __nv_bfloat16*)res2,
                       (__nv_bfloat16*)aux, (__nv_bfloat16*)y, B, K, N, rs};
  const auto st = (cudaStream_t)stream;
  cudaError_t e;
  if (B <= 1) e = launch_gemv_epi<WT, 1>(epi, a, st);
  else if (B <= 2) e = launch_gemv_epi<WT, 2>(epi, a, st);
  else if (B <= 4) e = launch_gemv_epi<WT, 4>(epi, a, st);
  else if (B <= 8) e = launch_gemv_epi<WT, 8>(epi, a, st);
  else if (B <= 16) e = launch_gemv_epi<WT, 16>(epi, a, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

template <bool INT8>
int attn_entry(const void* q, int qstride, const void* knew, const void* vnew,
               void* kc, void* vc, void* ks, void* vs, void* o, int B, int A,
               int H, int R, int r0, int n, int w, float scale,
               void* stream) {
  using CT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  static bool configured = false;
  const cudaError_t e = allow_dyn_smem(attn_kernel<INT8>, &configured);
  if (e != cudaSuccess) return (int)e;
  const int hd = A / H;
  const size_t smem = (size_t)(hd + n + kWarps * hd) * sizeof(float);
  attn_kernel<INT8><<<dim3(B, H), kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, qstride, (const __nv_bfloat16*)knew,
      (const __nv_bfloat16*)vnew, (CT*)kc, (CT*)vc, (__nv_bfloat16*)ks,
      (__nv_bfloat16*)vs, (__nv_bfloat16*)o, A, H, R, r0, n, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a launch may ask for (bytes).
int jk_max_dyn_smem() { return kMaxDynSmem; }

int jk_ln_rows(const void* x, const void* g, const void* b, void* y, int rows,
               int S, float eps, void* stream) {
  ln_rows_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)g, (const float*)b,
      (__nv_bfloat16*)y, S, eps);
  return (int)cudaGetLastError();
}

int jk_gemv_bf16(const void* x, const void* W, const void* bias,
                 const void* res, const void* res2, void* aux, void* y, int B,
                 int K, int N, int epi, float rs, void* stream) {
  return gemv_entry<__nv_bfloat16>(x, W, nullptr, bias, res, res2, aux, y, B,
                                   K, N, epi, rs, stream);
}

int jk_gemv_int8(const void* x, const void* W, const void* s,
                 const void* bias, const void* res, const void* res2,
                 void* aux, void* y, int B, int K, int N, int epi, float rs,
                 void* stream) {
  return gemv_entry<int8_t>(x, W, s, bias, res, res2, aux, y, B, K, N, epi,
                            rs, stream);
}

// The attention kernels: int8 == 0 bf16 caches (ks, vs unused), 1 int8
// caches with bf16 row scales. knew / vnew may be null when w < 0.
int jk_attn_decode(const void* q, int qstride, const void* knew,
                   const void* vnew, void* kc, void* vc, void* ks, void* vs,
                   void* o, int B, int A, int H, int R, int r0, int n, int w,
                   float scale, int int8, void* stream) {
  if (int8)
    return attn_entry<true>(q, qstride, knew, vnew, kc, vc, ks, vs, o, B, A,
                            H, R, r0, n, w, scale, stream);
  return attn_entry<false>(q, qstride, knew, vnew, kc, vc, ks, vs, o, B, A, H,
                           R, r0, n, w, scale, stream);
}

}  // extern "C"
