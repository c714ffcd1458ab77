// LayerNorm forward and backward of the PyTorch port, for sm_90a.
//
// Replaces the Pallas kernels of jukebox_tpu/ops/pallas/layer_norm.py:
//   jk_layer_norm_fwd  <- _fwd (_fwd_kernel): y = (x - mu) * rstd * g + b
//                         with fp32 statistics, saving mu and rstd [N] fp32;
//   jk_layer_norm_bwd  <- _bwd_rule (_bwd_kernel): dx, and per row block
//                         partial dg = sum(dy * xhat), db = sum(dy) [blocks, D]
//                         fp32, summed by the caller as the JAX wrapper sums
//                         them outside its kernel.
// x, y, dy and dx are [N, D] in one of fp32, bf16, fp16 (dtype code 0, 1,
// 2); g, b are fp32 [D]; any D whose row fits in shared memory.
//
// What bounds it: both passes are element-wise with two row reductions, so
// they are bound by HBM bytes (forward: read x, write y; backward: read x
// and dy, write dx), a few flops per byte. The design keeps the row on chip
// so each input byte is read from HBM once: the forward holds the row as
// fp32 in shared memory for its two statistics passes (mean, then the
// centred variance) and the output pass; the backward holds xhat and g.dy
// of the row while it reduces c1 = mean(xhat g dy) and c2 = mean(g dy), and
// accumulates dg / db for its block of rows in shared memory. The TPU
// kernel's row tiles (256 rows resident in VMEM per grid step) become one
// block per row (forward) or per `rows_per_block` rows (backward): blocks
// run in parallel on the SMs, so nothing carries between them.
//
// Entry points return the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kStaticSmem = 32 * sizeof(float);  // block_sum's buffer

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

// One block per `rpb` consecutive rows. Shared memory, 4 D floats: xhat and
// g dy of the current row, and this block's dg / db sums. Each thread reads
// and writes only its own columns j = threadIdx.x + k blockDim.x, so the
// row buffers need no barrier beyond the reductions'.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ mu, const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ dg_part, float* __restrict__ db_part,
                      int N, int D, int rpb) {
  extern __shared__ float sm[];
  float* xh = sm;
  float* wd = sm + D;
  float* dga = sm + 2 * D;
  float* dba = sm + 3 * D;
  __shared__ float red[32];
  const float inv_d = 1.f / (float)D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    dga[j] = 0.f;
    dba[j] = 0.f;
  }
  const int r0 = blockIdx.x * rpb;
  const int r1 = min(N, r0 + rpb);
  for (int r = r0; r < r1; ++r) {
    const int64_t base = (int64_t)r * D;
    const float m = mu[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float d = to_f<T>(dy[base + j]);
      const float xhat = (to_f<T>(x[base + j]) - m) * rs;
      const float w = d * g[j];
      xh[j] = xhat;
      wd[j] = w;
      s1 += xhat * w;
      s2 += w;
      dga[j] += d * xhat;
      dba[j] += d;
    }
    const float c1 = block_sum(s1, red) * inv_d;
    const float c2 = block_sum(s2, red) * inv_d;
    for (int j = threadIdx.x; j < D; j += blockDim.x)
      dx[base + j] = from_f<T>((wd[j] - xh[j] * c1 - c2) * rs);
  }
  const int64_t out = (int64_t)blockIdx.x * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    dg_part[out + j] = dga[j];
    db_part[out + j] = dba[j];
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

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const float* mu,
                       const float* rstd, const void* dy, void* dx,
                       float* dg_part, float* db_part, int N, int D, int rpb,
                       cudaStream_t stream) {
  const size_t smem = (size_t)4 * D * sizeof(float);
  cudaError_t err = allow_smem(layer_norm_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + rpb - 1) / rpb;
  layer_norm_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), g, mu, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dg_part, db_part, N, D, rpb);
  return cudaGetLastError();
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

int jk_layer_norm_bwd(const void* x, const float* g, const float* mu,
                      const float* rstd, const void* dy, void* dx,
                      float* dg_part, float* db_part, int N, int D, int rpb,
                      int dtype, cudaStream_t stream) {
  if (N <= 0 || D <= 0 || rpb <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(x, g, mu, rstd, dy, dx, dg_part, db_part, N, D, rpb, stream);
    case 1: return (int)launch_bwd<__nv_bfloat16>(x, g, mu, rstd, dy, dx, dg_part, db_part, N, D, rpb, stream);
    case 2: return (int)launch_bwd<__half>(x, g, mu, rstd, dy, dx, dg_part, db_part, N, D, rpb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
