// The transformer MLP's c_fc bias and quick_gelu, forward and backward, of
// the PyTorch port, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package writes quick_gelu(dense(x))
// and leaves the bias add and the activation to XLA's fusion. Eagerly they
// were a broadcast add and three element-wise kernels forward (9 bytes of
// the tensor's size moved) and six backward (15), so both are one kernel:
//   jk_bias_gelu_fwd  o = s / (1 + exp(-1.702 s)),  s = float(y) + b;
//   jk_bias_gelu_bwd  dpre = do (sg + 1.702 s sg (1 - sg)),
//                     sg = 1 / (1 + exp(-1.702 s)), and per block of rows
//                     a partial row of db = sum over rows of dpre (fp32,
//                     before dpre is rounded), [row_blocks, D], summed by
//                     the caller as the LayerNorm backward's partials are.
// y, o, do and dpre are [N, D] in one of fp32, bf16, fp16 (dtype code 0, 1,
// 2); b is fp32 [D]. Everything is computed in fp32 and rounded once to the
// output dtype: the expression of the decode GEMV's quick_gelu epilogue
// (csrc/decode_stack.cu gemv_store4, EPI 1), so the teacher-forced forward
// and the decode step compute the same activation.
//
// What bounds it: a few flops per element and no reuse, so HBM bytes. The
// forward reads y and writes o (2 bytes of the tensor's size, A: at the
// 1b top's training rows [104448, 2048] bf16, A = 427.8 MB, 0.255 ms at
// 3.35 TB/s); the backward reads y and do and writes dpre (3A, 0.383 ms),
// plus the partial rows of db (row_blocks x D fp32, ~0.5% of 3A there).
// The design meets that bound by reading every byte once, 16 bytes a lane
// where the width and the pointers allow (an element path otherwise), with
// kRows rows of loads in flight a thread: grid (row blocks, column tiles),
// a block of up to 256 threads spanning one tile of its rows, thread t
// owning the same VEC columns in every row, so b stays in its registers
// (forward) and its db sums add up there (backward). The forward runs a
// block per kRows rows (26112 at the training rows, many waves); the
// backward kBwdBlocksPerSm blocks per SM, one wave, each walking its share
// of the rows and writing one partial row of db. At [104448, 2048] bf16
// on an H100 80GB HBM3 at 700 W (scripts/chip_bias_gelu_probe.py, which
// times other row groups, grids and register bounds) the forward reads
// 287 us, 89% of its bound, the backward 475 us, 81%. No shared memory,
// no barrier, nothing allocated: the launch is legal inside a CUDA graph
// capture. The host's layout is ops/bias_gelu.py layout().
//
// Entry points return the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kAlpha = 1.702f;
constexpr int kRows = 4;  // rows a thread loads before computing any
constexpr int kMaxThreads = 256;
// the backward's grid is this many blocks an SM (ops/bias_gelu.py
// BWD_BLOCKS_PER_SM), all resident at once: one wave
constexpr int kBwdBlocksPerSm = 2;

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

// Block (x, y) takes the rows N x / gridDim.x .. N (x + 1) / gridDim.x - 1
// and the columns of tile y: thread t the VEC columns starting at (y
// blockDim.x + t) VEC, if they lie inside the row.
__device__ __forceinline__ void block_rows(int64_t N, int64_t& begin,
                                           int64_t& end) {
  begin = N * blockIdx.x / gridDim.x;
  end = N * (blockIdx.x + 1) / gridDim.x;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bias_gelu_fwd_kernel(const T* __restrict__ y, const float* __restrict__ b,
                     T* __restrict__ o, int64_t N, int D) {
  using Raw = RawOf<T, VEC>;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c >= D) return;
  float bv[VEC];
  load_f32<VEC>(b + c, bv);
  int64_t r_begin, r_end;
  block_rows(N, r_begin, r_end);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kRows) {
    Raw v[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      if (r0 + rr < r_end)
        v[rr] = *reinterpret_cast<const Raw*>(y + (r0 + rr) * D + c);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr >= r_end) continue;
      Raw out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float s = elem<T, VEC>(v[rr], j) + bv[j];
        oe[j] = from_f<T>(s / (1.0f + expf(-kAlpha * s)));
      }
      *reinterpret_cast<Raw*>(o + (r0 + rr) * D + c) = out;
    }
  }
}

// dpre in the output dtype, and the block's db partial over its rows in
// row order (the partials do not depend on timing) at part[x, D].
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kBwdBlocksPerSm)
bias_gelu_bwd_kernel(const T* __restrict__ y, const float* __restrict__ b,
                     const T* __restrict__ dout, T* __restrict__ dpre,
                     float* __restrict__ part, int64_t N, int D) {
  using Raw = RawOf<T, VEC>;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c >= D) return;
  float bv[VEC], acc[VEC];
  load_f32<VEC>(b + c, bv);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  int64_t r_begin, r_end;
  block_rows(N, r_begin, r_end);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kRows) {
    Raw yv[kRows], dv[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr < r_end) {
        yv[rr] = *reinterpret_cast<const Raw*>(y + (r0 + rr) * D + c);
        dv[rr] = *reinterpret_cast<const Raw*>(dout + (r0 + rr) * D + c);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr >= r_end) continue;
      Raw out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = kAlpha * (elem<T, VEC>(yv[rr], j) + bv[j]);
        const float sg = 1.0f / (1.0f + expf(-t));
        const float d = elem<T, VEC>(dv[rr], j) * (sg + t * sg * (1.0f - sg));
        acc[j] += d;
        oe[j] = from_f<T>(d);
      }
      *reinterpret_cast<Raw*>(dpre + (r0 + rr) * D + c) = out;
    }
  }
  store_f32<VEC>(part + (int64_t)blockIdx.x * D + c, acc);
}

// The host's layout (ops/bias_gelu.py layout): VEC elements a lane (16
// bytes where vec, else 1), threads = the row's lanes rounded up to whole
// warps, at most kMaxThreads, and as many column tiles as the row needs.
template <typename T>
bool grid_of(int D, int vec, int threads, int rows_x, dim3& grid) {
  constexpr int V = 16 / sizeof(T);
  const int VEC = vec ? V : 1;
  const int lanes = (D + VEC - 1) / VEC;
  if ((vec && D % V) || threads <= 0 || threads > kMaxThreads ||
      threads % 32 || (threads < kMaxThreads && threads < lanes) ||
      rows_x <= 0)
    return false;
  grid = dim3(rows_x, (lanes + threads - 1) / threads);
  return grid.y <= 65535;
}

template <typename T>
cudaError_t fwd(const void* y, const float* b, void* o, int64_t N, int D,
                int rows_x, int vec, int threads, cudaStream_t stream) {
  dim3 grid;
  if (!grid_of<T>(D, vec, threads, rows_x, grid)) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (vec)
    bias_gelu_fwd_kernel<T, V><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(y), b, static_cast<T*>(o), N, D);
  else
    bias_gelu_fwd_kernel<T, 1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(y), b, static_cast<T*>(o), N, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* y, const float* b, const void* dout, void* dpre,
                float* part, int64_t N, int D, int rows_x, int vec,
                int threads, cudaStream_t stream) {
  dim3 grid;
  if (!grid_of<T>(D, vec, threads, rows_x, grid)) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (vec)
    bias_gelu_bwd_kernel<T, V><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(y), b, static_cast<const T*>(dout),
        static_cast<T*>(dpre), part, N, D);
  else
    bias_gelu_bwd_kernel<T, 1><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(y), b, static_cast<const T*>(dout),
        static_cast<T*>(dpre), part, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows y [N, D] over rows_x row blocks (block x: rows N x / rows_x .. N (x
// + 1) / rows_x - 1) and the column tiles of `threads` lanes; vec 1 reads
// and writes 16 bytes a lane (D * itemsize % 16 == 0 and 16-byte aligned
// pointers), else one element at a time.
int jk_bias_gelu_fwd(const void* y, const float* b, void* o, int64_t N, int D,
                     int rows_x, int vec, int threads, int dtype,
                     cudaStream_t stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)fwd<float>(y, b, o, N, D, rows_x, vec, threads, stream);
    case 1: return (int)fwd<__nv_bfloat16>(y, b, o, N, D, rows_x, vec, threads, stream);
    case 2: return (int)fwd<__half>(y, b, o, N, D, rows_x, vec, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// part: [rows_x, D] fp32, row block x's sums of dpre over its rows.
int jk_bias_gelu_bwd(const void* y, const float* b, const void* dout,
                     void* dpre, float* part, int64_t N, int D, int rows_x,
                     int vec, int threads, int dtype, cudaStream_t stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)bwd<float>(y, b, dout, dpre, part, N, D, rows_x, vec, threads, stream);
    case 1: return (int)bwd<__nv_bfloat16>(y, b, dout, dpre, part, N, D, rows_x, vec, threads, stream);
    case 2: return (int)bwd<__half>(y, b, dout, dpre, part, N, D, rows_x, vec, threads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
