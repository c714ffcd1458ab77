// Multi-tensor Adam update of the PyTorch port, for sm_90a.
//
// Replaces the Pallas kernel of jukebox_tpu/ops/pallas/adam.py
// (_leaf_update / _adam_kernel, one launch per parameter leaf) and adds the
// fp16-moment form of jukebox_tpu/utils/train_utils.py adam_update:
//
//   g  = grad / scale                       (None grad: g = 0)
//   m  = b1 m + c1 g,   v = b2 v + c2 g g   (c1 = 1 - b1, c2 = 1 - b2)
//   p -= step_size (m / (sqrt(v) + eps) + wd p)
//
// fp32 form (jk_adam_fp32): m, v fp32, updated in place with p, one launch.
// fp16 form (jk_adam_fp16): m16, v16 fp16 with per-tensor fp32 scales,
// m = m16 * m_scale; after the update each moment is stored as x / s in
// fp16 with s = 1e-8 + max|x| / 65504 over its tensor. Three launches on
// the stream: (a) the per-tensor max|m| and max|v| of the new moments,
// atomicMax on the bit patterns of non-negative floats into a zeroed
// buffer; (b) the update, which recomputes the new moments from the old
// fp16 state and OLD scales and writes p, m16, v16; (c) one thread per
// tensor writes the new scales. (b) never writes a scale, so no block can
// read a scale that another block has already replaced.
//
// Every tensor is cut into chunks of `chunk` elements; one block per chunk.
// The device table (pointers, sizes, chunk -> tensor and start) is built
// once by the wrapper (ops/adam.py AdamTable); per step only the gradient
// pointers (gradients are new tensors each backward), the step size (a host
// float from the CPU LR schedule) and the scale (read here from its device
// 0-d tensor, so the launch adds no host sync) change.
//
// Arithmetic: every operation rounds as the plain PyTorch version's
// separate element-wise ops do (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn:
// no FMA contraction; x / s and g / scale divide, as PyTorch divides by a
// tensor, while amax / 65504 multiplies by the fp32 reciprocal, as PyTorch
// divides by a host scalar), so the kernel reproduces the plain version's
// fp16 rounding.
//
// What bounds it: bytes. Per parameter the fp32 form reads p, g, m, v and
// writes p, m, v (28 B); the fp16 form reads g, m16, v16 in (a), then
// p, g, m16, v16 and writes p, m16, v16 in (b) (28 B; 20 B if every input
// were read once). A few dozen flops per parameter are far below the
// card's rate.
//
// Entry points return the cudaError_t of the launches (0 on success).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvFloat16Max = 1.f / 65504.f;

struct Table {
  const int64_t* p;        // float*
  const int64_t* g;        // const float*, 0 for a None gradient
  const int64_t* m;        // float* or __half*
  const int64_t* v;
  const int64_t* m_scale;  // float* (fp16 form)
  const int64_t* v_scale;
  const int64_t* size;
  const int* chunk_tensor;
  const int64_t* chunk_start;
  int chunk;
};

struct Hyper {
  const float* scale;  // device 0-d
  float step_size, b1, b2, c1, c2, eps, wd;
};

__device__ __forceinline__ void moments(float gi, float& m, float& v,
                                        const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, gi));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, gi), gi));
}

__device__ __forceinline__ float new_param(float p, float m, float v,
                                           const Hyper& h) {
  const float denom = __fadd_rn(__fsqrt_rn(v), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(m, denom), __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(h.step_size, upd));
}

__device__ __forceinline__ float grad(const float* g, int64_t i, float scale) {
  return g ? __fdiv_rn(g[i], scale) : __fdiv_rn(0.f, scale);
}

// s = 1e-8 + amax / 65504 as the plain version rounds it: PyTorch divides
// a tensor by a host scalar as a product with the scalar's fp32 reciprocal.
__device__ __forceinline__ float new_scale(float amax) {
  return __fadd_rn(1e-8f, __fmul_rn(amax, kInvFloat16Max));
}

__global__ void __launch_bounds__(kThreads)
adam_fp32_kernel(Table t, Hyper h) {
  const int c = blockIdx.x;
  const int k = t.chunk_tensor[c];
  const int64_t start = t.chunk_start[c];
  const int64_t end = min(start + (int64_t)t.chunk, t.size[k]);
  float* p = reinterpret_cast<float*>(t.p[k]);
  const float* g = reinterpret_cast<const float*>(t.g[k]);
  float* m = reinterpret_cast<float*>(t.m[k]);
  float* v = reinterpret_cast<float*>(t.v[k]);
  const float scale = *h.scale;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    float mi = m[i], vi = v[i];
    moments(grad(g, i, scale), mi, vi, h);
    p[i] = new_param(p[i], mi, vi, h);
    m[i] = mi;
    v[i] = vi;
  }
}

// Max of a non-negative v over the block, by thread 0. red: 32 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ void fp16_moments(const Table& t, const Hyper& h,
                                             int k, int64_t i, const float* g,
                                             float scale, float ms, float vs,
                                             float& mi, float& vi) {
  const __half* m16 = reinterpret_cast<const __half*>(t.m[k]);
  const __half* v16 = reinterpret_cast<const __half*>(t.v[k]);
  mi = __fmul_rn(__half2float(m16[i]), ms);
  vi = __fmul_rn(__half2float(v16[i]), vs);
  moments(grad(g, i, scale), mi, vi, h);
}

// (a) amax [2 T] (zeroed): max|new m| at 2k, max|new v| at 2k + 1.
__global__ void __launch_bounds__(kThreads)
adam_fp16_amax_kernel(Table t, Hyper h, float* amax) {
  __shared__ float red[2][32];
  const int c = blockIdx.x;
  const int k = t.chunk_tensor[c];
  const int64_t start = t.chunk_start[c];
  const int64_t end = min(start + (int64_t)t.chunk, t.size[k]);
  const float* g = reinterpret_cast<const float*>(t.g[k]);
  const float scale = *h.scale;
  const float ms = *reinterpret_cast<const float*>(t.m_scale[k]);
  const float vs = *reinterpret_cast<const float*>(t.v_scale[k]);
  float am = 0.f, av = 0.f;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    float mi, vi;
    fp16_moments(t, h, k, i, g, scale, ms, vs, mi, vi);
    am = fmaxf(am, fabsf(mi));
    av = fmaxf(av, fabsf(vi));
  }
  am = block_max(am, red[0]);
  av = block_max(av, red[1]);
  if (threadIdx.x == 0) {
    atomicMax(reinterpret_cast<int*>(amax) + 2 * k, __float_as_int(am));
    atomicMax(reinterpret_cast<int*>(amax) + 2 * k + 1, __float_as_int(av));
  }
}

// (b) the update from the old fp16 state and old scales, stored under the
// new scales computed from amax.
__global__ void __launch_bounds__(kThreads)
adam_fp16_update_kernel(Table t, Hyper h, const float* amax) {
  const int c = blockIdx.x;
  const int k = t.chunk_tensor[c];
  const int64_t start = t.chunk_start[c];
  const int64_t end = min(start + (int64_t)t.chunk, t.size[k]);
  float* p = reinterpret_cast<float*>(t.p[k]);
  const float* g = reinterpret_cast<const float*>(t.g[k]);
  __half* m16 = reinterpret_cast<__half*>(t.m[k]);
  __half* v16 = reinterpret_cast<__half*>(t.v[k]);
  const float scale = *h.scale;
  const float ms = *reinterpret_cast<const float*>(t.m_scale[k]);
  const float vs = *reinterpret_cast<const float*>(t.v_scale[k]);
  const float ms_new = new_scale(amax[2 * k]);
  const float vs_new = new_scale(amax[2 * k + 1]);
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    float mi, vi;
    fp16_moments(t, h, k, i, g, scale, ms, vs, mi, vi);
    p[i] = new_param(p[i], mi, vi, h);
    m16[i] = __float2half_rn(__fdiv_rn(mi, ms_new));
    v16[i] = __float2half_rn(__fdiv_rn(vi, vs_new));
  }
}

// (c) the new scales, once every block of (b) has read the old ones.
__global__ void adam_fp16_scales_kernel(Table t, const float* amax,
                                        int n_tensors) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_tensors) return;
  *reinterpret_cast<float*>(t.m_scale[k]) = new_scale(amax[2 * k]);
  *reinterpret_cast<float*>(t.v_scale[k]) = new_scale(amax[2 * k + 1]);
}

Table make_table(const int64_t* p, const int64_t* g, const int64_t* m,
                 const int64_t* v, const int64_t* m_scale,
                 const int64_t* v_scale, const int64_t* size,
                 const int* chunk_tensor, const int64_t* chunk_start,
                 int chunk) {
  return Table{p, g, m, v, m_scale, v_scale, size, chunk_tensor, chunk_start,
               chunk};
}

}  // namespace

extern "C" {

int jk_adam_fp32(const int64_t* p, const int64_t* g, const int64_t* m,
                 const int64_t* v, const int64_t* size,
                 const int* chunk_tensor, const int64_t* chunk_start,
                 int n_chunks, int chunk, const float* scale, float step_size,
                 float b1, float b2, float c1, float c2, float eps, float wd,
                 cudaStream_t stream) {
  if (n_chunks <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const Table t = make_table(p, g, m, v, nullptr, nullptr, size, chunk_tensor,
                             chunk_start, chunk);
  const Hyper h{scale, step_size, b1, b2, c1, c2, eps, wd};
  adam_fp32_kernel<<<n_chunks, kThreads, 0, stream>>>(t, h);
  return (int)cudaGetLastError();
}

int jk_adam_fp16(const int64_t* p, const int64_t* g, const int64_t* m,
                 const int64_t* v, const int64_t* m_scale,
                 const int64_t* v_scale, const int64_t* size,
                 const int* chunk_tensor, const int64_t* chunk_start,
                 int n_chunks, int chunk, int n_tensors, float* amax,
                 const float* scale, float step_size, float b1, float b2,
                 float c1, float c2, float eps, float wd,
                 cudaStream_t stream) {
  if (n_chunks <= 0 || chunk <= 0 || n_tensors <= 0)
    return (int)cudaErrorInvalidValue;
  const Table t = make_table(p, g, m, v, m_scale, v_scale, size, chunk_tensor,
                             chunk_start, chunk);
  const Hyper h{scale, step_size, b1, b2, c1, c2, eps, wd};
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * 2 * n_tensors,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  adam_fp16_amax_kernel<<<n_chunks, kThreads, 0, stream>>>(t, h, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  adam_fp16_update_kernel<<<n_chunks, kThreads, 0, stream>>>(t, h, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  adam_fp16_scales_kernel<<<(n_tensors + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(t, amax, n_tensors);
  return (int)cudaGetLastError();
}

}  // extern "C"
