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
// once. The forward runs a block per group of rows (1632 blocks at the
// training rows: the SMs take them as they free up), the backward a grid
// of two blocks per SM, each walking over its share of the rows; both hold
// the rows in registers, read and written 16 bytes a lane (an element path
// where the width or a pointer forbids it), several rows in flight, and
// reduce the row sums with warp shuffles and one barrier per group of rows: the forward's mean, then the mean of
// the centred square (the two-pass statistics of the TPU kernel, not
// E[x^2] - E[x]^2); the backward's c1 = mean(xhat g dy), c2 = mean(g dy).
// Each thread keeps the same columns in every row, so g and b stay in its
// registers (forward) and dg / db for the block's rows add up there
// (backward). The TPU kernel's row tiles (256 rows resident in VMEM per
// grid step) carried nothing between grid steps either: here blocks run in
// parallel. The row layout (vectors a thread, CV) is the host's
// (ops/layer_norm.py row_layout).
//
// Entry points return the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWidth = 12288;  // 768 threads x 16 elements

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

// Both kernels hold rows in registers. Block b takes rows N b / blocks ..
// N (b + 1) / blocks - 1 (the forward: one group of them); its threads
// span a row: thread t owns the
// vectors t, t + blockDim.x, ... (CV of them) of VEC elements each (16
// bytes, 8 bf16 / fp16 or 4 fp32, on the vector path; one element on the
// scalar path, which runs where the width or a pointer forbids 16-byte
// loads), the same columns in every row. At the training widths (one
// vector a thread) R = 4 rows are loaded before any is reduced (wider rows
// go one at a time, CV vectors a thread in flight; the probe
// scripts/chip_gemv_ln_probe.py times these choices against other rows a
// group, blocks per SM and a warp per row). Each thread sums its columns,
// each warp with shuffles, and the warps' sums meet in shared memory,
// where every thread adds them in warp order: the backward's two sums a
// row behind one barrier per R rows, the forward's mean and then its
// centred square behind one each (double-buffered).
constexpr int kMaxThreads = 768;
constexpr int kRows = 4;  // R at one vector a thread

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

// The forward: each row's sum, then its centred square sum (one
// reduction each, red[0] and red[1]: a thread writes red[0] of the next
// group only after every thread has passed the barrier behind red[1], so
// two buffers make the two barriers a group safe); g and b stay in
// registers across the rows; y written 16 bytes a lane, mu and rstd by
// thread 0.
template <typename T, int VEC, int CV>
__global__ void __launch_bounds__(CV == 1 && VEC > 1 ? 256 : kMaxThreads,
                                  CV == 1 && VEC > 1 ? 4 : 1)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, int N, int D,
                      float eps) {
  constexpr int R = CV == 1 && VEC > 1 ? kRows : 1;
  using Raw = RawOf<T, VEC>;
  __shared__ float red[2][kMaxThreads / 32][R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t r_begin = (int64_t)N * blockIdx.x / gridDim.x;
  const int64_t r_end = (int64_t)N * (blockIdx.x + 1) / gridDim.x;
  const float inv_d = 1.f / (float)D;
  int cols[CV];
  float gv[CV][VEC], bv[CV][VEC];
#pragma unroll
  for (int i = 0; i < CV; ++i) {
    cols[i] = (threadIdx.x + i * blockDim.x) * VEC;
    if (cols[i] < D) {
      load_f32<VEC>(g + cols[i], gv[i]);
      load_f32<VEC>(b + cols[i], bv[i]);
    }
  }

  // the block's sums of s[rr] over the rows' columns, into s (every thread)
  auto row_sums = [&](float (&s)[R], float (&buf)[kMaxThreads / 32][R]) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], o);
      if (lane == 0) buf[warp][rr] = s[rr];
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      float v = 0.f;
      for (int ww = 0; ww < nw; ++ww) v += buf[ww][rr];
      s[rr] = v;
    }
  };

  for (int64_t r0 = r_begin; r0 < r_end; r0 += R) {
    Raw xv[R][CV];
    float mean[R], rstd[R], s[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
#pragma unroll
      for (int i = 0; i < CV; ++i)
        if (row < r_end && cols[i] < D)
          xv[rr][i] = *reinterpret_cast<const Raw*>(x + row * D + cols[i]);
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      s[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (r0 + rr >= r_end || cols[i] >= D) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[rr] += elem<T, VEC>(xv[rr][i], j);
      }
    }
    row_sums(s, red[0]);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      mean[rr] = s[rr] * inv_d;
      s[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (r0 + rr >= r_end || cols[i] >= D) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = elem<T, VEC>(xv[rr][i], j) - mean[rr];
          s[rr] += c * c;
        }
      }
    }
    row_sums(s, red[1]);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      if (row >= r_end) continue;
      rstd[rr] = rsqrtf(s[rr] * inv_d + eps);
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (cols[i] >= D) continue;
        Raw out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          oe[j] = from_f<T>((elem<T, VEC>(xv[rr][i], j) - mean[rr]) *
                                rstd[rr] * gv[i][j] +
                            bv[i][j]);
        *reinterpret_cast<Raw*>(y + row * D + cols[i]) = out;
      }
      if (threadIdx.x == 0) {
        mu_out[row] = mean[rr];
        rstd_out[row] = rstd[rr];
      }
    }
  }
}

// The backward: each thread sums xhat g dy and g dy over its columns, its
// dg / db sums stay in registers (CV * VEC <= 16 of each); then dx, and at
// the end the block's dg / db row of part [blocks, 2, D], in row order: the
// partials do not depend on timing.
template <typename T, int VEC, int CV>
__global__ void __launch_bounds__(CV == 1 && VEC > 1 ? 256 : kMaxThreads,
                                  CV == 1 && VEC > 1 ? 2 : 1)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ mu,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ part, int N, int D) {
  constexpr int R = CV == 1 && VEC > 1 ? kRows : 1;
  using Raw = RawOf<T, VEC>;
  __shared__ float red[2][kMaxThreads / 32][2 * R];
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

// One launch of a row kernel (the forward's or the backward's) for the
// host's row layout: VEC elements a vector (16 bytes, or 1 where vec is
// 0), cv vectors a thread, a block of ceil(D / VEC / cv) threads rounded
// up to whole warps.
template <typename T, template <typename, int, int> class Launch,
          typename... Args>
cudaError_t launch_rows(int D, int blocks, int vec, int cv,
                        cudaStream_t stream, Args... args) {
  constexpr int V = 16 / sizeof(T);
  const int VEC = vec ? V : 1;
  const int per_row = (D / VEC + cv - 1) / cv;
  const int threads = (per_row + 31) / 32 * 32;
  if (threads > kMaxThreads || (vec && D % V)) return cudaErrorInvalidValue;
  if (!vec && cv == 16)
    return Launch<T, 1, 16>::run(blocks, threads, stream, args...);
  if (vec && cv == 1) return Launch<T, V, 1>::run(blocks, threads, stream, args...);
  if (vec && cv == 2) return Launch<T, V, 2>::run(blocks, threads, stream, args...);
  if constexpr (V == 4) {
    if (vec && cv == 4) return Launch<T, V, 4>::run(blocks, threads, stream, args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VEC, int CV>
struct FwdLaunch {
  static cudaError_t run(int blocks, int threads, cudaStream_t stream,
                         const void* x, const float* g, const float* b,
                         void* y, float* mu, float* rstd, int N, int D,
                         float eps) {
    layer_norm_fwd_kernel<T, VEC, CV><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(y), mu, rstd, N, D,
        eps);
    return cudaGetLastError();
  }
};

template <typename T, int VEC, int CV>
struct BwdLaunch {
  static cudaError_t run(int blocks, int threads, cudaStream_t stream,
                         const void* x, const float* g, const float* mu,
                         const float* rstd, const void* dy, void* dx,
                         float* part, int N, int D) {
    layer_norm_bwd_kernel<T, VEC, CV><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), g, mu, rstd, static_cast<const T*>(dy),
        static_cast<T*>(dx), part, N, D);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Rows x [N, D] over `blocks` blocks (block b: rows N b / blocks .. N (b +
// 1) / blocks - 1) in the host's row layout: vec 1 reads and writes 16
// bytes a lane (D * itemsize % 16 == 0 and 16-byte aligned pointers), else
// one element at a time; cv vectors a thread (vec: 1, 2, or 4 in fp32;
// else 16).
int jk_layer_norm_fwd(const void* x, const float* g, const float* b, void* y,
                      float* mu, float* rstd, int N, int D, float eps,
                      int blocks, int vec, int cv, int dtype,
                      cudaStream_t stream) {
  if (N <= 0 || D <= 0 || D > kMaxWidth || blocks <= 0 || blocks > N)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_rows<float, FwdLaunch>(D, blocks, vec, cv, stream, x, g, b, y, mu, rstd, N, D, eps);
    case 1: return (int)launch_rows<__nv_bfloat16, FwdLaunch>(D, blocks, vec, cv, stream, x, g, b, y, mu, rstd, N, D, eps);
    case 2: return (int)launch_rows<__half, FwdLaunch>(D, blocks, vec, cv, stream, x, g, b, y, mu, rstd, N, D, eps);
    default: return (int)cudaErrorInvalidValue;
  }
}

// part: [blocks, 2, D] fp32, block b's dg and db sums over its rows.
int jk_layer_norm_bwd(const void* x, const float* g, const float* mu,
                      const float* rstd, const void* dy, void* dx,
                      float* part, int N, int D, int blocks, int vec, int cv,
                      int dtype, cudaStream_t stream) {
  if (N <= 0 || D <= 0 || D > kMaxWidth || blocks <= 0 || blocks > N)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_rows<float, BwdLaunch>(D, blocks, vec, cv, stream, x, g, mu, rstd, dy, dx, part, N, D);
    case 1: return (int)launch_rows<__nv_bfloat16, BwdLaunch>(D, blocks, vec, cv, stream, x, g, mu, rstd, dy, dx, part, N, D);
    case 2: return (int)launch_rows<__half, BwdLaunch>(D, blocks, vec, cv, stream, x, g, mu, rstd, dy, dx, part, N, D);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
