// Design alternatives of the Adam kernel, for scripts/chip_adam_probe.py
// only: nothing in the package builds this file. It includes the package's
// kernel (jukebox_tpu_torch/csrc/adam.cu) and adds:
//   jk_probe_adam(variant, ...)  the shipped kernel built for other thread-
//                                steps in flight and blocks an SM (variant
//                                0: 2 steps, 2 blocks;
//                                1: 1, 3; 2: 2, 3; 3: 1, 2; 4: 4, 2),
//                                jk_adam's arguments;
//   jk_probe_adam_old_fp32 / _fp16  the kernel this one replaced,
//                                verbatim but for its
//                                namespace and names: one block per chunk
//                                of 32768 elements, scalar loads at block
//                                stride, and in the fp16 form a memset and
//                                three launches (the amax pass, the update
//                                pass, the new scales), reading g, m16 and
//                                v16 from HBM in both passes.

#include "../jukebox_tpu_torch/csrc/adam.cu"

namespace replaced {

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


int old_fp32(const int64_t* p, const int64_t* g, const int64_t* m,
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

int old_fp16(const int64_t* p, const int64_t* g, const int64_t* m,
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

}  // namespace replaced

extern "C" {

int jk_probe_adam(int variant, const int64_t* p, const int64_t* g,
                  const int64_t* m, const int64_t* v, const int64_t* m_scale,
                  const int64_t* v_scale, const int64_t* size,
                  const int* item_tensor, const int64_t* item_start,
                  const int* item_kind, const int* n_amax, const int* n_upd,
                  int n_items, int n_tensors, int chunk, float* amax,
                  int* done, int* ticket, int blocks, int fp16,
                  const float* scale, float step_size, float b1, float b2,
                  float c1, float c2, float eps, float wd,
                  cudaStream_t stream) {
#define JK_PROBE(S, M)                                                      \
  launch_adam<S, M>(p, g, m, v, m_scale, v_scale, size, item_tensor,        \
                    item_start, item_kind, n_amax, n_upd, n_items,           \
                    n_tensors, chunk, amax, done, ticket, blocks, fp16,      \
                    scale, step_size, b1, b2, c1, c2, eps, wd, stream)
  switch (variant) {
    case 0: return JK_PROBE(2, 2);
    case 1: return JK_PROBE(1, 3);
    case 2: return JK_PROBE(2, 3);
    case 3: return JK_PROBE(1, 2);
    case 4: return JK_PROBE(4, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef JK_PROBE
}

int jk_probe_adam_old_fp32(const int64_t* p, const int64_t* g,
                           const int64_t* m, const int64_t* v,
                           const int64_t* size, const int* chunk_tensor,
                           const int64_t* chunk_start, int n_chunks,
                           int chunk, const float* scale, float step_size,
                           float b1, float b2, float c1, float c2, float eps,
                           float wd, cudaStream_t stream) {
  return replaced::old_fp32(p, g, m, v, size, chunk_tensor, chunk_start,
                        n_chunks, chunk, scale, step_size, b1, b2, c1, c2,
                        eps, wd, stream);
}

int jk_probe_adam_old_fp16(const int64_t* p, const int64_t* g,
                           const int64_t* m, const int64_t* v,
                           const int64_t* m_scale, const int64_t* v_scale,
                           const int64_t* size, const int* chunk_tensor,
                           const int64_t* chunk_start, int n_chunks,
                           int chunk, int n_tensors, float* amax,
                           const float* scale, float step_size, float b1,
                           float b2, float c1, float c2, float eps, float wd,
                           cudaStream_t stream) {
  return replaced::old_fp16(p, g, m, v, m_scale, v_scale, size, chunk_tensor,
                        chunk_start, n_chunks, chunk, n_tensors, amax, scale,
                        step_size, b1, b2, c1, c2, eps, wd, stream);
}

}  // extern "C"
