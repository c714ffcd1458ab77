// LayerNorm forward and backward of the PyTorch port, for sm_90a.
//
// Replaces the Pallas kernels of jukebox_tpu/ops/pallas/layer_norm.py:
//   jk_layer_norm_fwd  <- _fwd (_fwd_kernel): y = (x - mu) * rstd * g + b
//                         with fp32 statistics, saving mu and rstd [N] fp32;
//   jk_layer_norm_bwd  <- _bwd_rule (_bwd_kernel): dx, and per block of
//                         rows partial dg = sum(dy * xhat), db = sum(dy)
//                         [blocks, 2, D] fp32, summed by the caller as the
//                         JAX wrapper sums them outside its kernel.
// x, y, dy and dx are [N, D] in one of fp32, bf16, fp16 (dtype code 0, 1,
// 2); g, b are fp32 [D]; 1 <= D <= kMaxWidth.
//
// What bounds it: both passes are element-wise with two row reductions, so
// they are bound by HBM bytes (forward: read x, write y; backward: read x
// and dy, write dx), a few flops per byte. Each input byte is read from HBM
// once. The forward holds the row as fp32 in shared memory for its two
// statistics passes (mean, then the centred variance) and the output pass,
// one block per row. The backward fills the SMs with a grid of two blocks
// per SM, each walking over its share of the rows with the row in
// registers, read 16 bytes a lane, several rows in flight, and c1 =
// mean(xhat g dy), c2 = mean(g dy) reduced with warp shuffles and one
// barrier per group of rows; each thread keeps the same columns in every
// row, so dg / db for the block's rows add up in its registers. The TPU
// kernel's row tiles (256 rows resident in VMEM per grid step) carried
// nothing between grid steps either: here blocks run in parallel.
//
// Entry points return the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kStaticSmem = 32 * sizeof(float);  // block_sum's buffer
constexpr int kMaxWidth = 12288;  // 768 threads x 16 elements (backward)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Sum of v over the block; every thread gets the total. red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per row. Shared memory: the row as fp32, D floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int D, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int64_t base = (int64_t)blockIdx.x * D;
  const float inv_d = 1.f / (float)D;
  float s = 0.f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float v = to_f<T>(x[base + j]);
    row[j] = v;
    s += v;
  }
  const float mean = block_sum(s, red) * inv_d;
  float q = 0.f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float c = row[j] - mean;
    q += c * c;
  }
  const float rstd = rsqrtf(block_sum(q, red) * inv_d + eps);
  for (int j = threadIdx.x; j < D; j += blockDim.x)
    y[base + j] = from_f<T>((row[j] - mean) * rstd * g[j] + b[j]);
  if (threadIdx.x == 0) {
    mu_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

// The backward holds rows in registers. Block b takes rows N b / blocks ..
// N (b + 1) / blocks - 1; its threads span a row: thread t owns the
// vectors t, t + blockDim.x, ... (CV of them) of VEC elements each (16
// bytes, 8 bf16 / fp16 or 4 fp32, on the vector path; one element on the
// scalar path, which runs where the width or a pointer forbids 16-byte
// loads), the same columns in every row, so its dg / db sums stay in
// registers (CV * VEC <= 16 of each). At the training widths (one vector a
// thread, two blocks an SM) R = 4 rows are loaded before any is reduced
// (wider rows go one at a time, CV vectors a thread in flight; the probe
// scripts/chip_gemv_ln_probe.py times these choices against 2 rows with
// the next group's loads issued early, and 8 rows). Each thread sums
// xhat g dy and g dy over its columns, each warp with shuffles, and the
// warps' sums meet in shared memory behind one barrier per R rows
// (double-buffered). Then dx, and at the end the block's dg / db row of
// part [blocks, 2, D], in row order: the partials do not depend on timing.
constexpr int kBwdMaxThreads = 768;

// VEC elements of T as one load: 16 bytes, or one element
template <typename T, int VEC>
using RawOf = typename std::conditional<
    sizeof(T) * VEC == 16, uint4,
    typename std::conditional<sizeof(T) == 4, float, uint16_t>::type>::type;

template <typename T, int VEC>
__device__ __forceinline__ float elem(const RawOf<T, VEC>& r, int j) {
  return to_f<T>(reinterpret_cast<const T*>(&r)[j]);
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
      o[4 * k] = v.x;
      o[4 * k + 1] = v.y;
      o[4 * k + 2] = v.z;
      o[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = __ldg(p + j);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

template <typename T, int VEC, int CV>
__global__ void __launch_bounds__(CV == 1 && VEC > 1 ? 256 : kBwdMaxThreads,
                                  CV == 1 && VEC > 1 ? 2 : 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ mu,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ part, int N, int D) {
  constexpr int R = CV == 1 && VEC > 1 ? 4 : 1;
  using Raw = RawOf<T, VEC>;
  __shared__ float red[2][kBwdMaxThreads / 32][2 * R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t r_begin = (int64_t)N * blockIdx.x / gridDim.x;
  const int64_t r_end = (int64_t)N * (blockIdx.x + 1) / gridDim.x;
  const float inv_d = 1.f / (float)D;
  int cols[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) cols[i] = (threadIdx.x + i * blockDim.x) * VEC;

  float dga[CV][VEC], dba[CV][VEC];
#pragma unroll
  for (int i = 0; i < CV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dga[i][j] = dba[i][j] = 0.f;

  int buf = 0;  // red[buf]: one barrier per group of R rows
  for (int64_t r0 = r_begin; r0 < r_end; r0 += R, buf ^= 1) {
    Raw xv[R][CV], dv[R][CV];
    float m[R], rs[R], s[2 * R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      const bool ok = row < r_end;
      m[rr] = ok ? mu[row] : 0.f;
      rs[rr] = ok ? rstd[row] : 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (ok && cols[i] < D) {
          xv[rr][i] = *reinterpret_cast<const Raw*>(x + row * D + cols[i]);
          dv[rr][i] = *reinterpret_cast<const Raw*>(dy + row * D + cols[i]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const bool ok = r0 + rr < r_end;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (!ok || cols[i] >= D) continue;
        float gv[VEC];
        load_f32<VEC>(g + cols[i], gv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = elem<T, VEC>(dv[rr][i], j);
          const float xhat = (elem<T, VEC>(xv[rr][i], j) - m[rr]) * rs[rr];
          const float w = d * gv[j];
          s1 += xhat * w;
          s2 += w;
          dga[i][j] += d * xhat;
          dba[i][j] += d;
        }
      }
      s[rr] = s1;
      s[R + rr] = s2;
    }
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      if (lane == 0) red[buf][warp][k] = s[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
      float v = 0.f;
      for (int ww = 0; ww < nw; ++ww) v += red[buf][ww][k];
      s[k] = v * inv_d;  // row rr's c1 at k = rr, its c2 at k = R + rr
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      if (row >= r_end) continue;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (cols[i] >= D) continue;
        float gv[VEC];
        load_f32<VEC>(g + cols[i], gv);
        Raw out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xhat = (elem<T, VEC>(xv[rr][i], j) - m[rr]) * rs[rr];
          const float w = elem<T, VEC>(dv[rr][i], j) * gv[j];
          oe[j] = from_f<T>((w - xhat * s[rr] - s[R + rr]) * rs[rr]);
        }
        *reinterpret_cast<Raw*>(dx + row * D + cols[i]) = out;
      }
    }
  }

  float* pg = part + (int64_t)blockIdx.x * 2 * D;
#pragma unroll
  for (int i = 0; i < CV; ++i) {
    if (cols[i] >= D) continue;
    store_f32<VEC>(pg + cols[i], dga[i]);
    store_f32<VEC>(pg + D + cols[i], dba[i]);
  }
}

// Opt in to more than the default 48 KB of shared memory when the dynamic
// part and the kernel's static reduction buffer need it.
template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes + kStaticSmem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* g, const float* b, void* y,
                       float* mu, float* rstd, int N, int D, float eps,
                       cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err = allow_smem(layer_norm_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  layer_norm_fwd_kernel<T><<<N, kThreads, smem, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), mu, rstd, D, eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int CV>
cudaError_t launch_bwd(const void* x, const float* g, const float* mu,
                       const float* rstd, const void* dy, void* dx,
                       float* part, int N, int D, int blocks,
                       cudaStream_t stream) {
  const int per_row = (D / VEC + CV - 1) / CV;  // threads a row needs
  layer_norm_bwd_kernel<T, VEC, CV><<<blocks, (per_row + 31) / 32 * 32, 0,
                                      stream>>>(
      static_cast<const T*>(x), g, mu, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), part, N, D);
  return cudaGetLastError();
}

// The fewest vectors a thread (CV) for which a row takes at most 256
// threads, within 16 elements a thread; else the most (up to 768 threads).
template <typename T>
cudaError_t launch_bwd_path(const void* x, const float* g, const float* mu,
                            const float* rstd, const void* dy, void* dx,
                            float* part, int N, int D, int blocks, int vec,
                            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!vec)
    return launch_bwd<T, 1, 16>(x, g, mu, rstd, dy, dx, part, N, D, blocks,
                                stream);
  const int nvec = D / V;
  if (nvec <= 256)
    return launch_bwd<T, V, 1>(x, g, mu, rstd, dy, dx, part, N, D, blocks,
                               stream);
  if constexpr (V == 4) {
    if (nvec > 512)
      return launch_bwd<T, V, 4>(x, g, mu, rstd, dy, dx, part, N, D, blocks,
                                 stream);
  }
  return launch_bwd<T, V, 2>(x, g, mu, rstd, dy, dx, part, N, D, blocks,
                             stream);
}

}  // namespace

extern "C" {

int jk_layer_norm_fwd(const void* x, const float* g, const float* b, void* y,
                      float* mu, float* rstd, int N, int D, float eps,
                      int dtype, cudaStream_t stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(x, g, b, y, mu, rstd, N, D, eps, stream);
    case 1: return (int)launch_fwd<__nv_bfloat16>(x, g, b, y, mu, rstd, N, D, eps, stream);
    case 2: return (int)launch_fwd<__half>(x, g, b, y, mu, rstd, N, D, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// part: [blocks, 2, D] fp32, block b's dg and db sums over its rows
// N b / blocks .. N (b + 1) / blocks - 1. vec: x, dy, dx are read and
// written 16 bytes a lane (D * itemsize % 16 == 0 and 16-byte aligned
// pointers), else one element at a time.
int jk_layer_norm_bwd(const void* x, const float* g, const float* mu,
                      const float* rstd, const void* dy, void* dx,
                      float* part, int N, int D, int blocks, int vec,
                      int dtype, cudaStream_t stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (N <= 0 || D <= 0 || D > kMaxWidth || blocks <= 0 || blocks > N ||
      (vec && D * size % 16))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_bwd_path<float>(x, g, mu, rstd, dy, dx, part, N, D, blocks, vec, stream);
    case 1: return (int)launch_bwd_path<__nv_bfloat16>(x, g, mu, rstd, dy, dx, part, N, D, blocks, vec, stream);
    case 2: return (int)launch_bwd_path<__half>(x, g, mu, rstd, dy, dx, part, N, D, blocks, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
