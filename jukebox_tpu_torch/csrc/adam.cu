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
// fp32 form: m, v fp32, updated in place with p. fp16 form: m16, v16 fp16
// with per-tensor fp32 scales, m = m16 * m_scale; after the update each
// moment is stored as x / s in fp16 with s = 1e-8 + max|x| / 65504 over its
// tensor, so a tensor's update needs the max over the whole tensor of the
// moments it is computing.
//
// What bounds it: bytes. Per parameter the fp32 form reads p, g, m, v and
// writes p, m, v (28 B); the fp16 form reads p, g, m16, v16 and writes p,
// m16, v16 (20 B), if every input is read once. A few dozen flops per
// parameter are far below the card's rate.
//
// One launch per update, both forms, on a persistent grid (4 blocks an
// SM) that takes work items in order from an atomic ticket. The items are
// the host's (ops/adam.py item_order): chunks of `chunk` elements of a
// tensor (4096: short items keep the blocks that wait for a tensor's
// amax items from waiting long), each an amax item (the chunk's max |new m|, |new v|), an update
// item, or both (a tensor of one chunk: one block does both, no other
// waits). For each tensor of the fp16 form the list holds its amax items,
// then its update items, the chunks in the reverse of the amax order: the
// g, m16, v16 bytes read last by the amax pass are re-read first, from the
// 50 MB L2 (the update pass reads and writes with the streaming hint, so
// its own traffic leaves first). An amax item ends with atomicMax on the
// bit patterns of its non-negative maxima and a release count on its
// tensor; an update item waits with an acquire load until its tensor's
// amax items are counted, reads the maxima, and stores under the new
// scales. Blocks claim items in list order, so every item an update awaits
// is held by a running block that never waits on it: no deadlock, whatever
// the grid. The tensor's last update item (a second count) writes the new
// scales, after every item of the tensor has read the old ones, and resets
// the tensor's maxima and counts; the last block to finish resets the
// ticket: every launch leaves the state at zero, so no memset precedes it.
// A max does not depend on its order, so two launches give the same bits.
// The fp32 form is the same walk of update items alone.
//
// Loads: 8 elements a thread-step (two float4 of p and g, 8 halves of m16
// and v16 in one 16-byte load each; fp32 moments two float4 each), kSteps
// steps in flight; an element path takes a chunk's ragged tail and every
// tensor whose pointers are not all 16-byte aligned.
//
// The device table (pointers, sizes, the items and their counts per
// tensor) and the zeroed state are built once by the wrapper (ops/adam.py
// AdamTable); per step only the gradient pointers (gradients are new
// tensors each backward), the step size (a host float from the CPU LR
// schedule) and the scale (read here from its device 0-d tensor, so the
// launch adds no host sync) change. The table and state serve one stream.
//
// Arithmetic: every operation rounds as the plain PyTorch version's
// separate element-wise ops do (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn:
// no FMA contraction; x / s and g / scale divide, as PyTorch divides by a
// tensor, while amax / 65504 multiplies by the fp32 reciprocal, as PyTorch
// divides by a host scalar), so the kernel reproduces the plain version's
// fp16 rounding bit for bit.
//
// Entry points return the cudaError_t of the launch (0 on success).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The shipped launch: 8-element thread-steps in flight, and blocks of
// kThreads an SM (the persistent grid; registers capped to fit them): one
// step and 4 blocks, 32 warps an SM to hide the divisions' latency, beat
// 2 steps at 2 or 3 blocks (scripts/chip_adam_probe.py, which builds the
// others from scripts/chip_adam_variants.cu).
constexpr int kSteps = 1, kBlocksPerSm = 4;
constexpr float kInvFloat16Max = 1.f / 65504.f;
enum Kind { kAmax = 0, kUpdate = 1, kBoth = 2 };

struct Table {
  const int64_t* p;        // float*
  const int64_t* g;        // const float*, 0 for a None gradient
  const int64_t* m;        // float* or __half*
  const int64_t* v;
  const int64_t* m_scale;  // float* (fp16 form)
  const int64_t* v_scale;
  const int64_t* size;
  const int* item_tensor;
  const int64_t* item_start;
  const int* item_kind;
  const int* n_amax;  // per tensor: its amax items in the list
  const int* n_upd;   // per tensor: its update items in the list
  int n_items, n_tensors, chunk;
};

// Zero before the first launch; every launch leaves it zero.
struct State {
  float* amax;  // [2 T]: max|new m| at 2k, max|new v| at 2k + 1
  int* done;    // [2 T]: amax items counted at k, update items at T + k
  int* ticket;  // [2]: the next item; blocks finished
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

__device__ __forceinline__ float grad(float gv, float scale) {
  return __fdiv_rn(gv, scale);
}

// s = 1e-8 + amax / 65504 as the plain version rounds it: PyTorch divides
// a tensor by a host scalar as a product with the scalar's fp32 reciprocal.
__device__ __forceinline__ float new_scale(float amax) {
  return __fadd_rn(1e-8f, __fmul_rn(amax, kInvFloat16Max));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Max of a non-negative v over the block, returned to every thread.
// red: 33 floats; ends with a barrier.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// 8 consecutive elements of one tensor: p, g, m, v as fp32 (fp16 moments
// converted, their scales not yet applied)
template <bool FP16>
struct Group {
  float p[8], g[8], m[8], v[8];
};

template <bool FP16>
__device__ __forceinline__ void load_group(const float* p, const float* g,
                                           const void* m, const void* v,
                                           int64_t i, bool need_p,
                                           bool stream, Group<FP16>& x) {
  if (need_p) {
    const float4* pp = reinterpret_cast<const float4*>(p + i);
    const float4 a = stream ? __ldcs(pp) : pp[0];
    const float4 b = stream ? __ldcs(pp + 1) : pp[1];
    x.p[0] = a.x; x.p[1] = a.y; x.p[2] = a.z; x.p[3] = a.w;
    x.p[4] = b.x; x.p[5] = b.y; x.p[6] = b.z; x.p[7] = b.w;
  }
  if (g != nullptr) {
    const float4* gp = reinterpret_cast<const float4*>(g + i);
    const float4 a = stream ? __ldcs(gp) : __ldg(gp);
    const float4 b = stream ? __ldcs(gp + 1) : __ldg(gp + 1);
    x.g[0] = a.x; x.g[1] = a.y; x.g[2] = a.z; x.g[3] = a.w;
    x.g[4] = b.x; x.g[5] = b.y; x.g[6] = b.z; x.g[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x.g[e] = 0.f;
  }
  if constexpr (FP16) {
    const uint4* mp = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __half*>(m) + i);
    const uint4* vp = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __half*>(v) + i);
    const uint4 mr = stream ? __ldcs(mp) : mp[0];
    const uint4 vr = stream ? __ldcs(vp) : vp[0];
    const __half* mh = reinterpret_cast<const __half*>(&mr);
    const __half* vh = reinterpret_cast<const __half*>(&vr);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x.m[e] = __half2float(mh[e]);
      x.v[e] = __half2float(vh[e]);
    }
  } else {
    const float4* mp = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(m) + i);
    const float4* vp = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(v) + i);
    const float4 ma = stream ? __ldcs(mp) : mp[0];
    const float4 mb = stream ? __ldcs(mp + 1) : mp[1];
    const float4 va = stream ? __ldcs(vp) : vp[0];
    const float4 vb = stream ? __ldcs(vp + 1) : vp[1];
    x.m[0] = ma.x; x.m[1] = ma.y; x.m[2] = ma.z; x.m[3] = ma.w;
    x.m[4] = mb.x; x.m[5] = mb.y; x.m[6] = mb.z; x.m[7] = mb.w;
    x.v[0] = va.x; x.v[1] = va.y; x.v[2] = va.z; x.v[3] = va.w;
    x.v[4] = vb.x; x.v[5] = vb.y; x.v[6] = vb.z; x.v[7] = vb.w;
  }
}

// One item's pointers and scalars
template <bool FP16>
struct Item {
  float* p;
  const float* g;
  void* m;
  void* v;
  int64_t start, end;
  float ms, vs, ms_new, vs_new;  // fp16 form: old and new scales
  bool vec;                      // every pointer 16-byte aligned
};

// The new moments of element i from the stored ones
template <bool FP16>
__device__ __forceinline__ void element_moments(const Item<FP16>& it,
                                                int64_t i, float scale,
                                                const Hyper& h, float& mi,
                                                float& vi) {
  if constexpr (FP16) {
    mi = __fmul_rn(__half2float(reinterpret_cast<const __half*>(it.m)[i]),
                   it.ms);
    vi = __fmul_rn(__half2float(reinterpret_cast<const __half*>(it.v)[i]),
                   it.vs);
  } else {
    mi = reinterpret_cast<const float*>(it.m)[i];
    vi = reinterpret_cast<const float*>(it.v)[i];
  }
  moments(grad(it.g ? it.g[i] : 0.f, scale), mi, vi, h);
}

// The amax pass over the item: this thread's max|new m|, max|new v|
template <bool FP16, int STEPS>
__device__ void amax_pass(const Item<FP16>& it, float scale, const Hyper& h,
                          float& am, float& av) {
  int64_t i0 = it.start;
  if (it.vec) {
    const int64_t groups = (it.end - it.start) >> 3;
    for (int64_t j = threadIdx.x; j < groups; j += STEPS * kThreads) {
      Group<FP16> x[STEPS];
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        if (j + s * kThreads < groups)
          load_group<FP16>(it.p, it.g, it.m, it.v,
                           it.start + 8 * (j + s * kThreads), false, false,
                           x[s]);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (j + s * kThreads >= groups) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float mi = __fmul_rn(x[s].m[e], it.ms);
          float vi = __fmul_rn(x[s].v[e], it.vs);
          moments(grad(x[s].g[e], scale), mi, vi, h);
          am = fmaxf(am, fabsf(mi));
          av = fmaxf(av, fabsf(vi));
        }
      }
    }
    i0 = it.start + (groups << 3);
  }
  for (int64_t i = i0 + threadIdx.x; i < it.end; i += kThreads) {
    float mi, vi;
    element_moments<FP16>(it, i, scale, h, mi, vi);
    am = fmaxf(am, fabsf(mi));
    av = fmaxf(av, fabsf(vi));
  }
}

// The update pass over the item: p and the moments, stored under the new
// scales (fp16) or as they are (fp32)
template <bool FP16, int STEPS>
__device__ void update_pass(const Item<FP16>& it, float scale,
                            const Hyper& h) {
  int64_t i0 = it.start;
  if (it.vec) {
    const int64_t groups = (it.end - it.start) >> 3;
    for (int64_t j = threadIdx.x; j < groups; j += STEPS * kThreads) {
      Group<FP16> x[STEPS];
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        if (j + s * kThreads < groups)
          load_group<FP16>(it.p, it.g, it.m, it.v,
                           it.start + 8 * (j + s * kThreads), true, true,
                           x[s]);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (j + s * kThreads >= groups) continue;
        const int64_t i = it.start + 8 * (j + s * kThreads);
        float po[8];
        __align__(16) __half mo[8], vo[8];
        float mf[8], vf[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float mi = x[s].m[e], vi = x[s].v[e];
          if constexpr (FP16) {
            mi = __fmul_rn(mi, it.ms);
            vi = __fmul_rn(vi, it.vs);
          }
          moments(grad(x[s].g[e], scale), mi, vi, h);
          po[e] = new_param(x[s].p[e], mi, vi, h);
          if constexpr (FP16) {
            mo[e] = __float2half_rn(__fdiv_rn(mi, it.ms_new));
            vo[e] = __float2half_rn(__fdiv_rn(vi, it.vs_new));
          } else {
            mf[e] = mi;
            vf[e] = vi;
          }
        }
        float4* pp = reinterpret_cast<float4*>(it.p + i);
        __stcs(pp, make_float4(po[0], po[1], po[2], po[3]));
        __stcs(pp + 1, make_float4(po[4], po[5], po[6], po[7]));
        if constexpr (FP16) {
          __stcs(reinterpret_cast<uint4*>(reinterpret_cast<__half*>(it.m) + i),
                 *reinterpret_cast<const uint4*>(mo));
          __stcs(reinterpret_cast<uint4*>(reinterpret_cast<__half*>(it.v) + i),
                 *reinterpret_cast<const uint4*>(vo));
        } else {
          float4* mp = reinterpret_cast<float4*>(
              reinterpret_cast<float*>(it.m) + i);
          float4* vp = reinterpret_cast<float4*>(
              reinterpret_cast<float*>(it.v) + i);
          __stcs(mp, make_float4(mf[0], mf[1], mf[2], mf[3]));
          __stcs(mp + 1, make_float4(mf[4], mf[5], mf[6], mf[7]));
          __stcs(vp, make_float4(vf[0], vf[1], vf[2], vf[3]));
          __stcs(vp + 1, make_float4(vf[4], vf[5], vf[6], vf[7]));
        }
      }
    }
    i0 = it.start + (groups << 3);
  }
  for (int64_t i = i0 + threadIdx.x; i < it.end; i += kThreads) {
    float mi, vi;
    element_moments<FP16>(it, i, scale, h, mi, vi);
    it.p[i] = new_param(it.p[i], mi, vi, h);
    if constexpr (FP16) {
      reinterpret_cast<__half*>(it.m)[i] = __float2half_rn(__fdiv_rn(mi, it.ms_new));
      reinterpret_cast<__half*>(it.v)[i] = __float2half_rn(__fdiv_rn(vi, it.vs_new));
    } else {
      reinterpret_cast<float*>(it.m)[i] = mi;
      reinterpret_cast<float*>(it.v)[i] = vi;
    }
  }
}

template <bool FP16, int STEPS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
adam_kernel(Table t, Hyper h, State st) {
  __shared__ int slot[2];       // the claimed items, double-buffered
  __shared__ float red[2][33];  // block maxima
  __shared__ float scales[2];   // the new scales of an update item
  const float scale = *h.scale;
  if (threadIdx.x == 0) slot[0] = atomicAdd(st.ticket, 1);
  __syncthreads();
  for (int round = 0;; ++round) {
    const int item = slot[round & 1];
    if (item >= t.n_items) break;
    int next = 0;  // the next claim, in flight while this item runs
    if (threadIdx.x == 0) next = atomicAdd(st.ticket, 1);
    const int k = t.item_tensor[item], kind = t.item_kind[item];
    Item<FP16> it;
    it.p = reinterpret_cast<float*>(t.p[k]);
    it.g = reinterpret_cast<const float*>(t.g[k]);
    it.m = reinterpret_cast<void*>(t.m[k]);
    it.v = reinterpret_cast<void*>(t.v[k]);
    it.start = t.item_start[item];
    it.end = min(it.start + (int64_t)t.chunk, t.size[k]);
    it.vec = ((reinterpret_cast<uintptr_t>(it.p) |
               reinterpret_cast<uintptr_t>(it.g) |
               reinterpret_cast<uintptr_t>(it.m) |
               reinterpret_cast<uintptr_t>(it.v)) & 15) == 0;
    it.ms = it.vs = it.ms_new = it.vs_new = 1.f;
    if constexpr (FP16) {
      it.ms = __ldcg(reinterpret_cast<const float*>(t.m_scale[k]));
      it.vs = __ldcg(reinterpret_cast<const float*>(t.v_scale[k]));
      if (kind != kUpdate) {
        float am = 0.f, av = 0.f;
        amax_pass<FP16, STEPS>(it, scale, h, am, av);
        am = block_max(am, red[0]);
        av = block_max(av, red[1]);
        if (kind == kAmax) {
          if (threadIdx.x == 0) {
            atomicMax(reinterpret_cast<int*>(st.amax) + 2 * k,
                      __float_as_int(am));
            atomicMax(reinterpret_cast<int*>(st.amax) + 2 * k + 1,
                      __float_as_int(av));
            __threadfence();
            atomicAdd(st.done + k, 1);
          }
        } else {  // kBoth: the tensor's one item
          it.ms_new = new_scale(am);
          it.vs_new = new_scale(av);
        }
      } else {
        if (threadIdx.x == 0) {
          const int want = t.n_amax[k];
          while (load_acquire(st.done + k) < want) __nanosleep(32);
          scales[0] = new_scale(__ldcg(st.amax + 2 * k));
          scales[1] = new_scale(__ldcg(st.amax + 2 * k + 1));
        }
        __syncthreads();
        it.ms_new = scales[0];
        it.vs_new = scales[1];
      }
      if (kind != kAmax) {
        update_pass<FP16, STEPS>(it, scale, h);
        __syncthreads();  // every thread has read the old scales
        if (threadIdx.x == 0) {
          bool last = kind == kBoth;
          if (!last) {
            __threadfence();
            last = atomicAdd(st.done + t.n_tensors + k, 1) == t.n_upd[k] - 1;
          }
          if (last) {  // the new scales; the tensor's state back to zero
            *reinterpret_cast<float*>(t.m_scale[k]) = it.ms_new;
            *reinterpret_cast<float*>(t.v_scale[k]) = it.vs_new;
            if (kind != kBoth) {
              st.amax[2 * k] = st.amax[2 * k + 1] = 0.f;
              st.done[k] = st.done[t.n_tensors + k] = 0;
            }
          }
        }
      }
    } else {
      update_pass<FP16, STEPS>(it, scale, h);
    }
    if (threadIdx.x == 0) slot[(round + 1) & 1] = next;
    __syncthreads();
  }
  // the last block to finish resets the ticket
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(st.ticket + 1, 1) == (int)gridDim.x - 1) {
      st.ticket[0] = 0;
      st.ticket[1] = 0;
    }
  }
}

// One update: fp16 != 0 the fp16-moment form (m_scale, v_scale, n_amax,
// amax used), else fp32 moments; blocks: the persistent grid.
template <int STEPS, int MINB>
int launch_adam(const int64_t* p, const int64_t* g, const int64_t* m,
                const int64_t* v, const int64_t* m_scale,
                const int64_t* v_scale, const int64_t* size,
                const int* item_tensor, const int64_t* item_start,
                const int* item_kind, const int* n_amax, const int* n_upd,
                int n_items, int n_tensors, int chunk, float* amax, int* done,
                int* ticket, int blocks, int fp16, const float* scale,
                float step_size, float b1, float b2, float c1, float c2,
                float eps, float wd, cudaStream_t stream) {
  if (n_items <= 0 || n_tensors <= 0 || chunk <= 0 || chunk % 8 ||
      blocks <= 0 || (fp16 && (!m_scale || !v_scale || !amax || !n_amax)))
    return (int)cudaErrorInvalidValue;
  const Table t{p, g, m, v, m_scale, v_scale, size, item_tensor, item_start,
                item_kind, n_amax, n_upd, n_items, n_tensors, chunk};
  const State s{amax, done, ticket};
  const Hyper h{scale, step_size, b1, b2, c1, c2, eps, wd};
  if (fp16)
    adam_kernel<true, STEPS, MINB><<<blocks, kThreads, 0, stream>>>(t, h, s);
  else
    adam_kernel<false, STEPS, MINB><<<blocks, kThreads, 0, stream>>>(t, h, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The persistent grid's blocks an SM that the kernel is built for.
int jk_adam_blocks_per_sm() { return kBlocksPerSm; }

// One update over the items of the table (launch_adam). state: amax [2 T]
// floats, done [2 T] and ticket [2] ints, zero before the first launch
// (every launch leaves them zero).
int jk_adam(const int64_t* p, const int64_t* g, const int64_t* m,
            const int64_t* v, const int64_t* m_scale, const int64_t* v_scale,
            const int64_t* size, const int* item_tensor,
            const int64_t* item_start, const int* item_kind,
            const int* n_amax, const int* n_upd, int n_items, int n_tensors,
            int chunk, float* amax, int* done, int* ticket, int blocks,
            int fp16, const float* scale, float step_size, float b1,
            float b2, float c1, float c2, float eps, float wd,
            cudaStream_t stream) {
  return launch_adam<kSteps, kBlocksPerSm>(
      p, g, m, v, m_scale, v_scale, size, item_tensor, item_start, item_kind,
      n_amax, n_upd, n_items, n_tensors, chunk, amax, done, ticket, blocks,
      fp16, scale, step_size, b1, b2, c1, c2, eps, wd, stream);
}

}  // extern "C"
