// Design alternatives of layer_norm_bwd, for scripts/chip_gemv_ln_probe.py
// only: nothing in the package builds this file. It includes the package's
// LayerNorm kernels and adds ln_bwd_variant_kernel, the shipped backward
// at one 16-byte vector a thread (the training widths, bf16) with its
// choices made template parameters: R rows a group, PF whether the next
// group's loads are issued before the current group is reduced (the
// shipped kernel: R 4, PF off), GREG whether a thread's 8 values of g stay
// in registers (shipped: read from L1 at each use).
// Entry: jk_probe_ln_bwd(variant, <jk_layer_norm_bwd's arguments>) with
// variant 0 (R 4), 1 (R 2, PF), 2 (R 4, PF), 3 (R 8), 4 (R 4, GREG);
// bf16 rows with D % 8 == 0 and D <= 2048 only.

#include "../jukebox_tpu_torch/csrc/layer_norm.cu"

namespace {

// R rows of a thread's columns as loaded, with their statistics
template <typename T, int VEC, int CV, int R>
struct BwdRows {
  RawOf<T, VEC> x[R][CV], dy[R][CV];
  float mu[R], rstd[R];
};

template <int R, bool PF, bool GREG>
__global__ void __launch_bounds__(256, R <= 2 ? 3 : 2)
ln_bwd_variant_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ mu,
                      const float* __restrict__ rstd,
                      const __nv_bfloat16* __restrict__ dy,
                      __nv_bfloat16* __restrict__ dx,
                      float* __restrict__ part, int N, int D) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8, CV = 1;
  using Raw = RawOf<T, VEC>;
  using Rows = BwdRows<T, VEC, CV, R>;
  __shared__ float red[2][8][2 * R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t r_begin = (int64_t)N * blockIdx.x / gridDim.x;
  const int64_t r_end = (int64_t)N * (blockIdx.x + 1) / gridDim.x;
  const float inv_d = 1.f / (float)D;
  const int col = threadIdx.x * VEC;
  float gk[VEC];
  if (GREG && col < D) load_f32<VEC>(g + col, gk);
  float dga[VEC], dba[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) dga[j] = dba[j] = 0.f;

  auto gval = [&](float (&gv)[VEC]) {
    if (GREG) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) gv[j] = gk[j];
    } else {
      load_f32<VEC>(g + col, gv);
    }
  };
  auto load = [&](Rows& t, int64_t r0) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      const bool ok = row < r_end;
      t.mu[rr] = ok ? mu[row] : 0.f;
      t.rstd[rr] = ok ? rstd[row] : 0.f;
      if (ok && col < D) {
        t.x[rr][0] = *reinterpret_cast<const Raw*>(x + row * D + col);
        t.dy[rr][0] = *reinterpret_cast<const Raw*>(dy + row * D + col);
      }
    }
  };
  auto process = [&](const Rows& t, int64_t r0, int buf) {
    float s[2 * R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      float s1 = 0.f, s2 = 0.f;
      if (r0 + rr < r_end && col < D) {
        float gv[VEC];
        gval(gv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = elem<T, VEC>(t.dy[rr][0], j);
          const float xhat = (elem<T, VEC>(t.x[rr][0], j) - t.mu[rr]) *
                             t.rstd[rr];
          const float w = d * gv[j];
          s1 += xhat * w;
          s2 += w;
          dga[j] += d * xhat;
          dba[j] += d;
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
      s[k] = v * inv_d;
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      if (row >= r_end || col >= D) continue;
      float gv[VEC];
      gval(gv);
      Raw out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (elem<T, VEC>(t.x[rr][0], j) - t.mu[rr]) *
                           t.rstd[rr];
        const float w = elem<T, VEC>(t.dy[rr][0], j) * gv[j];
        oe[j] = from_f<T>((w - xhat * s[rr] - s[R + rr]) * t.rstd[rr]);
      }
      *reinterpret_cast<Raw*>(dx + row * D + col) = out;
    }
  };

  if constexpr (PF) {
    Rows a, b;
    load(a, r_begin);
    for (int64_t r0 = r_begin; r0 < r_end; r0 += 2 * R) {
      load(b, r0 + R);
      process(a, r0, 0);
      load(a, r0 + 2 * R);
      process(b, r0 + R, 1);
    }
  } else {
    int buf = 0;
    for (int64_t r0 = r_begin; r0 < r_end; r0 += R, buf ^= 1) {
      Rows a;
      load(a, r0);
      process(a, r0, buf);
    }
  }
  if (col < D) {
    float* pg = part + (int64_t)blockIdx.x * 2 * D;
    store_f32<VEC>(pg + col, dga);
    store_f32<VEC>(pg + D + col, dba);
  }
}

template <int R, bool PF, bool GREG>
int launch_variant(const void* x, const float* g, const float* mu,
                   const float* rstd, const void* dy, void* dx, float* part,
                   int N, int D, int blocks, cudaStream_t st) {
  ln_bwd_variant_kernel<R, PF, GREG><<<blocks, (D / 8 + 31) / 32 * 32, 0,
                                       st>>>(
      (const __nv_bfloat16*)x, g, mu, rstd, (const __nv_bfloat16*)dy,
      (__nv_bfloat16*)dx, part, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jk_probe_ln_bwd(int variant, const void* x, const float* g,
                               const float* mu, const float* rstd,
                               const void* dy, void* dx, float* part, int N,
                               int D, int blocks, int vec, int dtype,
                               cudaStream_t st) {
  if (dtype != 1 || !vec || D % 8 || D > 2048 || blocks > N)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch_variant<4, false, false>(x, g, mu, rstd, dy, dx, part, N, D, blocks, st);
    case 1: return launch_variant<2, true, false>(x, g, mu, rstd, dy, dx, part, N, D, blocks, st);
    case 2: return launch_variant<4, true, false>(x, g, mu, rstd, dy, dx, part, N, D, blocks, st);
    case 3: return launch_variant<8, false, false>(x, g, mu, rstd, dy, dx, part, N, D, blocks, st);
    case 4: return launch_variant<4, false, true>(x, g, mu, rstd, dy, dx, part, N, D, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
