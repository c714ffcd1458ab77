// Design alternatives of the LayerNorm kernels, for
// scripts/chip_gemv_ln_probe.py only: nothing in the package builds this
// file. It includes the package's LayerNorm kernels and adds, for the
// forward (entry jk_probe_ln_fwd, at the end): ln_fwd_rows_kernel, the
// shipped forward at one 16-byte vector a thread (bf16, D % 8 == 0,
// D <= 2048) with R rows a group a template parameter (shipped: 4);
// ln_fwd_warp_kernel, a warp per row (lane l holds the vectors l, l + 32,
// ... of its row, no barrier; g and b read at each use); and
// ln_fwd_old_kernel, the forward this design replaced. For the backward,
// ln_bwd_variant_kernel, the shipped backward
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

constexpr int kThreads = 256;  // the old forward's block

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

// The forward as it shipped before, verbatim but for its name: one block
// of 256 threads per row, the row staged in shared memory as fp32, read
// element by element. Shared memory: the row as fp32, D floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_old_kernel(const T* __restrict__ x, const float* __restrict__ g,
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


// The shipped forward at one 16-byte bf16 vector a thread with R rows a
// group (the shipped kernel's loop, R its template parameter)
template <int R>
__global__ void __launch_bounds__(256, 4)
ln_fwd_rows_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ g, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ mu_out,
                   float* __restrict__ rstd_out, int N, int D, float eps) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  using Raw = RawOf<T, VEC>;
  __shared__ float red[2][8][R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t r_begin = (int64_t)N * blockIdx.x / gridDim.x;
  const int64_t r_end = (int64_t)N * (blockIdx.x + 1) / gridDim.x;
  const float inv_d = 1.f / (float)D;
  const int col = threadIdx.x * VEC;
  float gv[VEC], bv[VEC];
  if (col < D) {
    load_f32<VEC>(g + col, gv);
    load_f32<VEC>(b + col, bv);
  }
  auto row_sums = [&](float (&s)[R], float (&buf)[8][R]) {
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
    Raw xv[R];
    float mean[R], s[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      if (r0 + rr < r_end && col < D)
        xv[rr] = *reinterpret_cast<const Raw*>(x + (r0 + rr) * D + col);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      s[rr] = 0.f;
      if (r0 + rr < r_end && col < D)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[rr] += elem<T, VEC>(xv[rr], j);
    }
    row_sums(s, red[0]);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      mean[rr] = s[rr] * inv_d;
      s[rr] = 0.f;
      if (r0 + rr < r_end && col < D)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = elem<T, VEC>(xv[rr], j) - mean[rr];
          s[rr] += c * c;
        }
    }
    row_sums(s, red[1]);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t row = r0 + rr;
      if (row >= r_end) continue;
      const float rstd = rsqrtf(s[rr] * inv_d + eps);
      if (col < D) {
        Raw out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          oe[j] = from_f<T>((elem<T, VEC>(xv[rr], j) - mean[rr]) * rstd *
                                gv[j] + bv[j]);
        *reinterpret_cast<Raw*>(y + row * D + col) = out;
      }
      if (threadIdx.x == 0) {
        mu_out[row] = mean[rr];
        rstd_out[row] = rstd;
      }
    }
  }
}

// A warp per row: the block's warps take contiguous shares of the rows;
// lane l holds the bf16 vectors l, l + 32, ... (CW of them) of its row;
// the two sums by shuffles alone; g and b read at each use (from L1)
template <int CW>
__global__ void __launch_bounds__(256)
ln_fwd_warp_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ g, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ mu_out,
                   float* __restrict__ rstd_out, int N, int D, float eps) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  using Raw = RawOf<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t gw = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  const float inv_d = 1.f / (float)D;
  for (int64_t row = N * gw / warps; row < N * (gw + 1) / warps; ++row) {
    Raw xv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i)
      xv[i] = *reinterpret_cast<const Raw*>(x + row * D +
                                            (lane + 32 * i) * VEC);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += elem<T, VEC>(xv[i], j);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s * inv_d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = elem<T, VEC>(xv[i], j) - mean;
        q += c * c;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q * inv_d + eps);
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const int col = (lane + 32 * i) * VEC;
      float gv[VEC], bv[VEC];
      load_f32<VEC>(g + col, gv);
      load_f32<VEC>(b + col, bv);
      Raw out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        oe[j] = from_f<T>((elem<T, VEC>(xv[i], j) - mean) * rstd * gv[j] +
                          bv[j]);
      *reinterpret_cast<Raw*>(y + row * D + col) = out;
    }
    if (lane == 0) {
      mu_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

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
                               int D, int blocks, int vec, int cv,
                               int dtype, cudaStream_t st) {
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

// The forward's alternatives on bf16 rows with D % 8 == 0 and D <= 2048
// (variant 3: D == 2048) over `blocks` blocks: 0, 1, 2 the shipped loop
// at R 4, 2, 8 rows a group; 3 a warp per row (8 warps a block); 4 the
// old design (one block per row, blocks unused).
extern "C" int jk_probe_ln_fwd(int variant, const void* x, const float* g,
                               const float* b, void* y, float* mu,
                               float* rstd, int N, int D, float eps,
                               int blocks, int vec, int cv, int dtype,
                               cudaStream_t st) {
  if (dtype != 1 || !vec || D % 8 || D > 2048 || blocks > N ||
      (variant == 3 && D != 2048))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  auto* yb = (__nv_bfloat16*)y;
  const int threads = (D / 8 + 31) / 32 * 32;
  switch (variant) {
    case 0: ln_fwd_rows_kernel<4><<<blocks, threads, 0, st>>>(xb, g, b, yb, mu, rstd, N, D, eps); break;
    case 1: ln_fwd_rows_kernel<2><<<blocks, threads, 0, st>>>(xb, g, b, yb, mu, rstd, N, D, eps); break;
    case 2: ln_fwd_rows_kernel<8><<<blocks, threads, 0, st>>>(xb, g, b, yb, mu, rstd, N, D, eps); break;
    case 3: ln_fwd_warp_kernel<8><<<blocks, 256, 0, st>>>(xb, g, b, yb, mu, rstd, N, D, eps); break;
    case 4:
      ln_fwd_old_kernel<__nv_bfloat16><<<N, kThreads, D * sizeof(float), st>>>(
          xb, g, b, yb, mu, rstd, D, eps);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
