// Decode-step kernels for Hopper (sm_90a): bf16 activations, bf16 or
// weight-only int8 weights, bf16 or int8 ring caches.
//
// Replace: jukebox_tpu/ops/pallas/decode_stack.py::build_stack_decode
// (the whole-stack Pallas megakernel, body `_kernel`), in all its options:
// bf16 or `quantized` int8 weights, bf16 or `cache_quantized` int8 caches,
// f6 cross-attention against a read-only encoder cache, every head width
// (its sliced / masked / matmul head modes are Mosaic layouts of one piece
// of math: here blocks per (batch row, head) serve them all) and
// `res_scale`. That kernel runs one token through a segment of layers in
// one launch; here the same per-layer arithmetic runs as kernels launched
// per layer:
//
//   gemv         y[B, N] = epilogue(x[B, K] @ W[K, N] (* s[N]) + b), W in
//                the JAX (in, out) layout, fp32 accumulation, optionally
//                with a LayerNorm prologue (x the raw residual stream,
//                fp32 statistics, eps given, fp32 gain/bias, the
//                normalised row rounded to bf16 before the product, as
//                the megakernel's u / um at decode_stack.py:625-636 and
//                999-1008): gemv_bf16
//                (W bf16) and gemv_int8 (W int8 with one fp32 scale per
//                output column, applied after the accumulation, as the
//                megakernel's piece_mm does). Serves c_attn (qkv, or q
//                alone in f6 layers), c_proj (+ residual), mlp c_fc
//                (+ quick_gelu) and mlp c_proj (+ residual, or the
//                res_scale residual x + (a + m) * res_scale).
//   attn         one token of one layer against its cache, its live rows
//                split over blocks (grid B x H x splits):
//                ring_attn_decode (bf16 ring: write the token's k, v into
//                its slot, masked scores over the live rows, fp32 softmax,
//                fp32 weights x V); ring_attn_int8 (int8 ring with
//                one bf16 scale per (batch row, slot): the new row is
//                quantised on write from its fp32 values, absmax over A /
//                127 floored at 1e-8, int8 = round(k * (1 / scale)), the
//                bf16-rounded scale stored; on read the scales fold into
//                the scores and the softmax weights, and the current
//                token's own score and value use its bf16 k and v, as the
//                megakernel's sc_new / w_ins patch does); cross_attn_decode
//                (f6: a q-only query against the read-only encoder K/V,
//                bf16 or int8, nothing written).
//
// What bounds them on an H100: a decode step at batch <= 16 does ~2 flops
// per weight byte (~4 in int8), far below the ~295 flop/byte ridge, so the
// GEMVs are bound by streaming W from HBM (one read of every weight per
// token step; int8 halves the bytes). Both GEMVs are one kernel template
// (gemv_kernel), its weight loader the parameter: K is split over the
// blocks of a thread block cluster (the host's ops/decode_stack.py
// gemv_split_plan: one wave, at most 8 splits), every lane keeps eight
// loads of 16 bytes of W in flight and reads x from L2 (no staging copy),
// the weights become bf16 mma fragments by byte permutes (int8: and masks;
// no conversion instruction per weight), the tensor cores multiply
// (mma.sync), and the splits' partials are summed through the cluster's
// distributed shared memory in the same launch. The attention kernels are
// bound
// by the cache rows they read (the f0 dense layer reads t+1 rows, f6 the
// 512 encoder rows: 19.9 MB at the 1b top's last f0 position, 5.95 us at
// 3.35 TB/s). With one block per (batch row, head) that is 8 blocks on 132
// SMs, so the rows are split: the host picks `splits` blocks per head
// (ops/decode_stack.py attn_split_plan: enough to fill the SMs a few times,
// 64-256 rows each; one split up to 128 rows), each warp reads its rows' K
// and V 16 bytes a lane with several rows in flight and keeps an online
// softmax in registers (no block-wide step before the end), and the last
// block of each head to finish combines the splits' partial sums in the
// same launch: a decode layer still launches one attention kernel. The
// arithmetic is the megakernel's (decode_stack.py:649-653, 766-799): q is
// the fp32 row of the c_attn product plus bias (the GEMV's out32 row),
// not its bf16 rounding; the new token's k and v are the bf16 rows (int8:
// quantised from the fp32 rows); the fp32 softmax weights multiply V and
// only the head output is rounded to bf16. Each LayerNorm is the prologue
// of the GEMV that reads it (c_attn or f6's q, and mlp c_fc), so a decode
// layer launches 5 kernels: 2 LN-GEMVs, the attention, 2 residual GEMVs.
// A persistent whole-stack kernel, CUDA graphs and wgmma/TMA are later
// work.
//
// Every entry point is a plain C function that launches on the given stream
// and returns cudaGetLastError(); the Python wrappers
// (jukebox_tpu_torch/ops/decode_stack.py) check shapes, types and layout,
// allocate outputs, and raise on a non-zero return.

#include <cooperative_groups.h>
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
// The GEMV epilogue of the four outputs at .. at + 3 (at = b * N + n, n a
// multiple of 4), from s, the fp32 products (scaled) plus bias, and r, r2
// the bf16 residuals there. y32, when given, receives s itself: the
// attention reads q from it, and the int8 cache mode quantises the new k, v
// rows from it. EPI: 0 none, 1 quick_gelu, 2 residual (out = r + bf16(s);
// aux, when given, also receives bf16(s)), 3 res_scale (out = r +
// bf16(bf16(r2 + bf16(s)) * bf16(rs)), the bf16 roundings of x + (a + m)
// * res_scale).
// ---------------------------------------------------------------------------
template <int EPI>
__device__ __forceinline__ void gemv_store4(const float (&s)[4], size_t at,
                                            uint2 r, uint2 r2,
                                            __nv_bfloat16* __restrict__ aux,
                                            float* __restrict__ y32,
                                            __nv_bfloat16* __restrict__ y,
                                            float rs) {
  if (y32 != nullptr)
    *reinterpret_cast<float4*>(y32 + at) = make_float4(s[0], s[1], s[2], s[3]);
  const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&r);
  const __nv_bfloat16* r2v = reinterpret_cast<const __nv_bfloat16*>(&r2);
  __align__(8) __nv_bfloat16 out[4], kept[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float o = s[e];
    if (EPI == 1) {
      o = s[e] / (1.0f + expf(-1.702f * s[e]));
    } else if (EPI == 2) {
      kept[e] = __float2bfloat16(s[e]);
      o = __bfloat162float(rv[e]) + bf16_round(s[e]);
    } else if (EPI == 3) {
      const float am = bf16_round(__bfloat162float(r2v[e]) + bf16_round(s[e]));
      o = __bfloat162float(rv[e]) + bf16_round(am * bf16_round(rs));
    }
    out[e] = __float2bfloat16(o);
  }
  if (EPI == 2 && aux != nullptr)
    *reinterpret_cast<uint2*>(aux + at) = *reinterpret_cast<const uint2*>(kept);
  *reinterpret_cast<uint2*>(y + at) = *reinterpret_cast<const uint2*>(out);
}

// ---------------------------------------------------------------------------
// The GEMV, one kernel template for both weight types: WL is the weight
// loader (I8Weights: int8 W with fp32 column scales s, applied after the
// accumulation; Bf16Weights: bf16 W), which loads a lane's weights and
// turns them into mma fragments; the split plan, the products, the
// combine and the epilogue are shared. Grid (N / 128 column tiles, splits
// of K), 8 warps a block, and the splits of a tile are one thread block
// cluster (at most 16 blocks). Split z of a tile owns the rows z * chunk
// .. + chunk - 1 (the last ragged; chunk a multiple of 16), and warp w of
// its block the 16-row steps w, w + 8, ... of them, U steps loaded before
// any is multiplied: one (a lane's 4 rows of 16 columns: 128 bytes of bf16
// in two 16-byte loads a row, 64 of int8), or two where nearly every warp
// has two (B <= 8), so all of a small product's loads are in flight at
// once. The
// host's plan (ops/decode_stack.py gemv_split_plan) keeps the grid in one
// wave and every tile's cluster at most 8 blocks.
//
// Each step is one mma.sync m16n8k16 (bf16 in, fp32 accumulate) per pair
// of columns with W^T as the A operand and x^T as B: lane (g = lane / 4,
// q = lane % 4) loads its 16 columns col .. col + 15 (col = tile * 128 +
// 16 g) of the rows k + 4q .. k + 4q + 3 and x[g][k + 4q .. + 3] (8 bytes,
// from L2, or from the block's normalised rows u under the LayerNorm
// prologue). The mma's k index 2q, 2q + 1, 2q + 8,
// 2q + 9 stands for row k + 4q + 0..3 in both operands (a sum over k does
// not depend on its order), and its m index g (g + 8) for column col + 2j
// (+ 1) of the j-th mma, so every register holds whole loads and no value
// crosses lanes. The batch rows are the mma's n side (8, or two mmas for
// B > 8); lane (g, q) ends with columns col + 0..15 of batch rows 2q,
// 2q + 1.
//
// The combine never leaves the SMs: the 8 warps' sums meet in shared
// memory, each block sums them (warps in order) into its partial of every
// 4-column quad of [B, 128] and writes it straight into the shared memory
// of the quad's owner (rank quad % splits) through distributed shared
// memory; one cluster barrier later, each owner sums the splits' partials
// in rank order and applies s, bias and the epilogue (their operands
// loaded before the products). No workspace, fence,
// counter or fp32 atomic: two launches on the same inputs give the same
// bits. (The earlier combine through a global workspace and the tile's
// last block, and reading the partials after the barrier, which needs a
// second one, are in scripts/chip_gemv_variants.cu with their times.)
//
// The LayerNorm prologue (the epilogues none and quick_gelu, EPI 0 and 1:
// c_attn, f6's q, mlp c_fc; every product that reads a LayerNorm): x
// is the raw residual stream and the product reads u = bf16((x - mean)
// rstd g + b) in its place. Each block needs its rows' statistics over all
// of K but holds only its split's columns, and the cluster spans every
// split of a column tile, so the splits' partials meet in distributed
// shared memory, as the products' do: the block copies its columns of x,
// g and b into shared memory (every load in flight at once); warp w takes
// rows w, w + 8: its lanes sum the row's columns (then the xor butterfly),
// and, about that split mean m_z, their centred squares q_z (two passes
// over shared memory), and write (sum, q_z) into every block of the
// cluster. After one cluster barrier each block forms, in rank order, the
// mean m (the splits' sums over K) and the centred sum of squares about it
// by the exact identity sum_z [q_z + n_z (m_z - m)^2] (a two-pass variance
// met in one exchange; never E[x^2] - E[x]^2), rstd = rsqrt(var + eps),
// and normalises its columns into u [B][pitch] bf16 (pitch = chunk
// rounded to 16 mod 64 elements, so the loop's 8-byte reads of 8 rows
// meet no bank twice). Every block sums the same partials in the same
// order, so all splits use the same statistics and two launches give the
// same bits. The block loads x, g and b first; then every lane issues its
// first U steps' weight loads (at the 1b top's c_attn a lane's only
// steps), which stream while the statistics meet, and the first
// iteration multiplies them; every later iteration (and every iteration of
// the residual products, EPI 2 and 3, which have no prologue) loads its
// own steps' weights and x before its products (issuing each iteration's
// next weights after its products read 0.1-0.5 us slower at the residual
// products and 0.6 at the 5b mlp c_fc's LN-GEMV). The alternatives are in
// scripts/chip_gemv_variants.cu with their times: the mean and the
// centred squares met in two exchanges (two cluster barriers), every
// block reading its B rows from L2, the weight loads before x's or after
// the prologue, the prologue alone, the unfused pair (the replaced
// one-block-per-row ln_rows kernel, then the GEMV), the LN-GEMV issuing
// each iteration's next weights after its products, and the products
// without the prologue in either loop order.
// ---------------------------------------------------------------------------
constexpr int kGemvCols = 128;
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvStep = 16;
constexpr int kGemvRedPitch = kGemvCols + 4;
constexpr int kGemvMaxSplits = 16;  // a cluster's blocks (above 8: opt-in)
// recv's float4s: splits * ceil(quads / splits) for quads <= 16 * 32
constexpr int kGemvRecv = 16 * (kGemvCols / 4) + kGemvMaxSplits;

// The bf16 pair {v(a, sa), v(b, sb)} of int8 byte sa of a and byte sb of b
template <int SA, int SB>
__device__ __forceinline__ uint32_t i8_pair(uint32_t a, uint32_t b) {
  const uint32_t p = __byte_perm(a, b, SA | ((4 + SB) << 8));
  const uint32_t lo = (p & 0x007f007fu) | 0x43004300u;
  const uint32_t hi = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
              *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// 16 / 8 bytes of read-only global memory (ld.global.nc). ORDERED: as an
// asm volatile statement, which the compiler keeps in its place before the
// LayerNorm prologue's barriers (an __ldg load may be moved past them, to
// its first use, and then waits out the prologue instead of streaming
// beside it).
template <bool ORDERED>
__device__ __forceinline__ uint4 ldg16(const void* p) {
  if constexpr (!ORDERED) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <bool ORDERED>
__device__ __forceinline__ uint2 ldg8(const void* p) {
  if constexpr (!ORDERED) return __ldg(reinterpret_cast<const uint2*>(p));
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// int8 W: a lane's 16 columns of a row are 16 bytes, one load (V16), else
// two of 8 bytes (N % 16 != 0: W's rows are 8-byte aligned only). No
// conversion instruction per weight (i8_pair): a byte permute puts two int8
// bytes v into two bf16 words 0x43vv, and the two masks 0x4300 | (v & 0x7f)
// = 128 + (v & 127) and 0x4300 | (v & 0x80) = 128 or 256 differ by v
// exactly (int8 values are exact in bf16): four instructions for two
// weights.
struct I8Weights {
  using T = int8_t;
  static constexpr bool kScaled = true;
  static constexpr int kWords = 4;  // 32-bit words of a row's 16 columns

  template <bool V16, bool ORDERED = false>
  static __device__ __forceinline__ void load(const int8_t* p, bool hi_ok,
                                              uint32_t (&w)[kWords]) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (V16) {
      v = ldg16<ORDERED>(p);
    } else {
      const uint2 lo = ldg8<ORDERED>(p);
      v.x = lo.x;
      v.y = lo.y;
      if (hi_ok) {
        const uint2 hi = ldg8<ORDERED>(p + 8);
        v.z = hi.x;
        v.w = hi.y;
      }
    }
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }

  // The A fragment of columns 2j, 2j + 1 of the lane's 16 from the words
  // w[r] of its rows k + 4q + r
  template <int J>
  static __device__ __forceinline__ void frag(const uint32_t (&w)[4][kWords],
                                              uint32_t (&a)[4]) {
    constexpr int WD = J >> 1, S = 2 * (J & 1);
    a[0] = i8_pair<S, S>(w[0][WD], w[1][WD]);
    a[1] = i8_pair<S + 1, S + 1>(w[0][WD], w[1][WD]);
    a[2] = i8_pair<S, S>(w[2][WD], w[3][WD]);
    a[3] = i8_pair<S + 1, S + 1>(w[2][WD], w[3][WD]);
  }
};

// bf16 W: a lane's 16 columns of a row are two loads of 16 bytes (the
// second left out where col + 8 >= N, N % 16 == 8); one byte permute
// pairs two rows' bf16 values of a column, one instruction for two weights.
struct Bf16Weights {
  using T = __nv_bfloat16;
  static constexpr bool kScaled = false;
  static constexpr int kWords = 8;

  template <bool V16, bool ORDERED = false>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              bool hi_ok,
                                              uint32_t (&w)[kWords]) {
    const uint4 lo = ldg16<ORDERED>(p);
    const uint4 hi = V16 || hi_ok ? ldg16<ORDERED>(p + 8)
                                  : make_uint4(0u, 0u, 0u, 0u);
    w[0] = lo.x;
    w[1] = lo.y;
    w[2] = lo.z;
    w[3] = lo.w;
    w[4] = hi.x;
    w[5] = hi.y;
    w[6] = hi.z;
    w[7] = hi.w;
  }

  template <int J>
  static __device__ __forceinline__ void frag(const uint32_t (&w)[4][kWords],
                                              uint32_t (&a)[4]) {
    a[0] = __byte_perm(w[0][J], w[1][J], 0x5410);
    a[1] = __byte_perm(w[0][J], w[1][J], 0x7632);
    a[2] = __byte_perm(w[2][J], w[3][J], 0x5410);
    a[3] = __byte_perm(w[2][J], w[3][J], 0x7632);
  }
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The j-th mma of a step: columns 2j, 2j + 1 of the lane's 16
template <class WL, int J, int NB>
__device__ __forceinline__ void gemv_mma(float (&acc)[NB][8][4],
                                         const uint32_t (&w)[4][WL::kWords],
                                         const uint32_t (&xb)[NB][2]) {
  uint32_t a[4];
  WL::template frag<J>(w, a);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    mma_bf16_16816(acc[nb][J], a, xb[nb][0], xb[nb][1]);
}

// The products of U loaded steps: eight mmas a step
template <class WL, int NB, int U>
__device__ __forceinline__ void gemv_products(
    float (&acc)[NB][8][4], const uint32_t (&w)[U][4][WL::kWords],
    const uint32_t (&xb)[U][NB][2]) {
#pragma unroll
  for (int s = 0; s < U; ++s) {
    gemv_mma<WL, 0>(acc, w[s], xb[s]);
    gemv_mma<WL, 1>(acc, w[s], xb[s]);
    gemv_mma<WL, 2>(acc, w[s], xb[s]);
    gemv_mma<WL, 3>(acc, w[s], xb[s]);
    gemv_mma<WL, 4>(acc, w[s], xb[s]);
    gemv_mma<WL, 5>(acc, w[s], xb[s]);
    gemv_mma<WL, 6>(acc, w[s], xb[s]);
    gemv_mma<WL, 7>(acc, w[s], xb[s]);
  }
}

// A lane's weights of U steps from row k0 (the rows at or past k_hi, and
// every row of a lane past N, read as zeros); ORDERED: see ldg16
template <class WL, bool V16, int U, bool ORDERED = false>
__device__ __forceinline__ void gemv_load_w(
    const typename WL::T* __restrict__ W, int k0, int k_hi, int N, int col,
    bool col_ok, bool hi_ok, int q, uint32_t (&w)[U][4][WL::kWords]) {
  constexpr int STRIDE = kGemvWarps * kGemvStep;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = k0 + u * STRIDE + 4 * q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (col_ok && k + r < k_hi) {
        WL::template load<V16, ORDERED>(W + (size_t)(k + r) * N + col,
                                        hi_ok, w[u][r]);
      } else {
#pragma unroll
        for (int i = 0; i < WL::kWords; ++i) w[u][r][i] = 0u;
      }
    }
  }
}

// x[b][k + 4q .. + 3] of U steps from row k0 as bf16 pairs, for the batch
// rows b = g + 8 nb: from x [B, K] in L2 (8-byte loads when K % 4 == 0,
// else element by element), or, with LN (the prologue), from the block's
// normalised rows
// u [B][pitch] (columns from k_lo; zero-filled past k_hi to a multiple of
// 16, so a piece that starts before k_hi is read whole)
template <bool LN, int NB, int U>
__device__ __forceinline__ void gemv_load_x(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* u, int pitch,
    int k0, int k_lo, int k_hi, int B, int K, int g, int q,
    uint32_t (&xb)[U][NB][2]) {
  constexpr int STRIDE = kGemvWarps * kGemvStep;
#pragma unroll
  for (int s = 0; s < U; ++s) {
    const int k = k0 + s * STRIDE + 4 * q;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int b = g + 8 * nb;
      xb[s][nb][0] = xb[s][nb][1] = 0u;
      if (b >= B || k >= k_hi) continue;
      if constexpr (LN) {
        const uint2 xv =
            *reinterpret_cast<const uint2*>(u + b * pitch + (k - k_lo));
        xb[s][nb][0] = xv.x;
        xb[s][nb][1] = xv.y;
      } else {
        const __nv_bfloat16* px = x + (size_t)b * K + k;
        if ((K & 3) == 0) {
          const uint2 xv = __ldg(reinterpret_cast<const uint2*>(px));
          xb[s][nb][0] = xv.x;
          xb[s][nb][1] = xv.y;
        } else {
          uint16_t h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h[e] = k + e < k_hi ? __bfloat16_as_ushort(px[e]) : 0;
          xb[s][nb][0] = h[0] | ((uint32_t)h[1] << 16);
          xb[s][nb][1] = h[2] | ((uint32_t)h[3] << 16);
        }
      }
    }
  }
}

// The LayerNorm prologue (see above), in two parts. gemv_ln_load: the
// block's columns k_lo .. k_hi - 1 of the B rows of x into u [B][pitch],
// and of g and b into gb [2][pitch] fp32, every load in flight at once;
// ends with a block barrier.
__device__ __forceinline__ void gemv_ln_load(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ lnb, __nv_bfloat16* u, float* gb, int pitch,
    int B, int K, int k_lo, int k_hi) {
  const int len = k_hi - k_lo;
  if ((K & 3) == 0) {  // x 8 bytes a thread-step: its rows 8-byte aligned
    const int n4 = len >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < B * n4; i += kGemvThreads) {
      const int b = i / n4, c = (i - b * n4) * 4;
      *reinterpret_cast<uint2*>(u + b * pitch + c) = __ldg(
          reinterpret_cast<const uint2*>(x + (size_t)b * K + k_lo + c));
    }
  } else {
    for (int i = threadIdx.x; i < B * len; i += kGemvThreads) {
      const int b = i / len, c = i - b * len;
      u[b * pitch + c] = x[(size_t)b * K + k_lo + c];
    }
  }
  for (int c = threadIdx.x; c < len; c += kGemvThreads) {
    gb[c] = __ldg(lng + k_lo + c);
    gb[pitch + c] = __ldg(lnb + k_lo + c);
  }
  __syncthreads();
}

// gemv_ln_stats: the row statistics of all K columns met across the
// cluster's splits, and u normalised in place. Opens with the wait of the
// cluster's first barrier phase (every block has started) and ends after
// one more cluster barrier and a block barrier: u is complete.
__device__ __forceinline__ void gemv_ln_stats(__nv_bfloat16* u,
                                              const float* gb, int pitch,
                                              int B, int K, int k_lo,
                                              int k_hi, int chunk,
                                              float eps) {
  namespace cg = cooperative_groups;
  // [sender][row]: the sender's sum and its centred sum of squares about
  // its own mean
  __shared__ float2 part[kGemvMaxSplits][16];
  __shared__ float mean[16], rstd[16];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = k_hi - k_lo, padded = (len + kGemvStep - 1) & ~(kGemvStep - 1);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // each row's sum over the split's columns and, about the split's own
  // mean, its centred sum of squares: into every block of the cluster
  for (int b = warp; b < B; b += kGemvWarps) {
    const __nv_bfloat16* ub = u + b * pitch;
    float s = 0.0f;
    for (int c = lane; c < len; c += 32) s += __bfloat162float(ub[c]);
    s = warp_sum(s);
    const float m = s / (float)len;
    float q = 0.0f;
    for (int c = lane; c < len; c += 32) {
      const float d = __bfloat162float(ub[c]) - m;
      q += d * d;
    }
    q = warp_sum(q);
    if (lane < splits)
      *cluster.map_shared_rank(&part[rank][b], lane) = make_float2(s, q);
  }
  cluster.sync();  // every split's sums have landed
  // the mean from the splits' sums in rank order; the centred sum of
  // squares about it by the exact identity sum_z [q_z + n_z (m_z - m)^2],
  // in rank order (never E[x^2] - E[x]^2)
  for (int b = warp; b < B; b += kGemvWarps) {
    if (lane != 0) continue;
    float t = 0.0f;
    for (int z = 0; z < splits; ++z) t = __fadd_rn(t, part[z][b].x);
    const float m = __fdiv_rn(t, (float)K);
    float m2 = 0.0f;
    for (int z = 0; z < splits; ++z) {
      const float n = (float)(z < splits - 1 ? chunk : K - z * chunk);
      const float d = __fsub_rn(__fdiv_rn(part[z][b].x, n), m);
      m2 = __fadd_rn(m2, __fadd_rn(part[z][b].y,
                                   __fmul_rn(n, __fmul_rn(d, d))));
    }
    mean[b] = m;
    rstd[b] = rsqrtf(__fadd_rn(__fdiv_rn(m2, (float)K), eps));
  }
  __syncthreads();
  // normalise in place, rounding as the plain version's separate ops; zero
  // the columns past k_hi up to the last piece the loop reads
  for (int i = threadIdx.x; i < B * padded; i += kGemvThreads) {
    const int b = i / padded, c = i - b * padded;
    float v = 0.0f;
    if (c < len) {
      const float d = __fsub_rn(__bfloat162float(u[b * pitch + c]), mean[b]);
      v = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd[b]), gb[c]), gb[pitch + c]);
    }
    u[b * pitch + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

template <class WL, int BT, int EPI, bool V16, int U>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_kernel(const __nv_bfloat16* __restrict__ x,
            const typename WL::T* __restrict__ W,
            const float* __restrict__ scale,
            const __nv_bfloat16* __restrict__ bias,
            const __nv_bfloat16* __restrict__ res,
            const __nv_bfloat16* __restrict__ res2,
            __nv_bfloat16* __restrict__ aux, float* __restrict__ y32,
            __nv_bfloat16* __restrict__ y, const float* __restrict__ lng,
            const float* __restrict__ lnb, int B, int K, int N, int chunk,
            int pitch, float rs, float eps) {
  namespace cg = cooperative_groups;
  constexpr int NB = BT / 8;  // mmas per column pair (8 batch rows)
  constexpr int STRIDE = kGemvWarps * kGemvStep;
  constexpr bool LN = EPI == 0 || EPI == 1;  // the LayerNorm prologue
  // [warp][b][kGemvRedPitch] fp32, then (LN) u [B][pitch] bf16 and g, b
  // [2][pitch] fp32
  extern __shared__ __align__(16) float red[];
  __shared__ float4 recv[kGemvRecv];  // [sender rank][quad / splits]
  // the first barrier phase, awaited before any block writes into
  // another's shared memory: every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kGemvCols, col = c0 + 16 * g;
  const int k_lo = rank * chunk, k_hi = min(K, k_lo + chunk);
  const bool col_ok = col < N, hi_ok = V16 || col + 8 < N;
  // 4 columns a quad, quad i = b * 32 + c / 4: owned by rank i % splits,
  // whose thread j = i / splits sums it (m of them a rank)
  const int cols = min(kGemvCols, N - c0);
  const int quads = B * (kGemvCols / 4);
  const int m = (quads + splits - 1) / splits;
  // the bias, int8 scales and residuals of this thread's first owned quad,
  // loaded before the products so the epilogue does not wait for them
  const int own = rank + splits * threadIdx.x;
  uint2 own_b, own_r, own_r2;
  float4 own_s;
  auto quad_in = [&](int i, uint2& bi, float4& sc, uint2& r, uint2& r2) {
    const int n = c0 + (i % (kGemvCols / 4)) * 4;
    const size_t at = (size_t)(i / (kGemvCols / 4)) * N + n;
    bi = r = r2 = make_uint2(0u, 0u);
    sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (i >= quads || n >= N) return;
    bi = __ldg(reinterpret_cast<const uint2*>(bias + n));
    if constexpr (WL::kScaled)
      sc = __ldg(reinterpret_cast<const float4*>(scale + n));
    if constexpr (EPI == 2 || EPI == 3)
      r = __ldg(reinterpret_cast<const uint2*>(res + at));
    if constexpr (EPI == 3)
      r2 = __ldg(reinterpret_cast<const uint2*>(res2 + at));
  };
  quad_in(own, own_b, own_s, own_r, own_r2);

  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][j][e] = 0.0f;

  // LN: the prologue's loads first, then the first U steps' weights, in
  // flight while the statistics meet (their loads kept in place: ORDERED),
  // and the first iteration's products on them
  __nv_bfloat16* u =
      reinterpret_cast<__nv_bfloat16*>(red + kGemvWarps * B * kGemvRedPitch);
  float* gb = reinterpret_cast<float*>(u + B * pitch);
  int k0 = k_lo + kGemvStep * warp;
  uint32_t w[U][4][WL::kWords];  // [step][row k + 4q + r][word]
  uint32_t xb[U][NB][2];         // x[b][k + 4q .. + 3] as two bf16 pairs
  if constexpr (LN) {
    gemv_ln_load(x, lng, lnb, u, gb, pitch, B, K, k_lo, k_hi);
    gemv_load_w<WL, V16, U, true>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_ln_stats(u, gb, pitch, B, K, k_lo, k_hi, chunk, eps);
    if (k0 < k_hi) {
      gemv_load_x<true, NB, U>(x, u, pitch, k0, k_lo, k_hi, B, K, g, q, xb);
      gemv_products<WL, NB, U>(acc, w, xb);
    }
    k0 += U * STRIDE;
  }
  // each iteration's weights, then its x, then its products
  for (; k0 < k_hi; k0 += U * STRIDE) {
    gemv_load_w<WL, V16, U>(W, k0, k_hi, N, col, col_ok, hi_ok, q, w);
    gemv_load_x<LN, NB, U>(x, u, pitch, k0, k_lo, k_hi, B, K, g, q, xb);
    gemv_products<WL, NB, U>(acc, w, xb);
  }

  // acc[nb][j][e]: column 16 g + 2j + (e >> 1), batch row 8 nb + 2q + (e & 1)
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * nb + 2 * q + h;
      if (b < B) {
        float* row = red + (warp * B + b) * kGemvRedPitch + 16 * g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[nb][j][h], acc[nb][j][2 + h]);
      }
    }
  __syncthreads();
  if constexpr (!LN)  // the prologue has awaited it
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // the block's partial of each quad (its warps in order), pushed into the
  // owner's recv
  for (int i = threadIdx.x; i < quads; i += kGemvThreads) {
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(red + b * kGemvRedPitch + c);
#pragma unroll
    for (int ww = 1; ww < kGemvWarps; ++ww) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (ww * B + b) * kGemvRedPitch + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *cluster.map_shared_rank(&recv[rank * m + i / splits], i % splits) = s;
  }
  cluster.sync();  // every partial has landed; nothing remote after this

  // the owned quads: the splits' partials in rank order, then the epilogue
  for (int j = threadIdx.x; j < m; j += kGemvThreads) {
    const int i = rank + splits * j;
    const int b = i / (kGemvCols / 4), c = (i % (kGemvCols / 4)) * 4;
    if (i >= quads || c >= cols) continue;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int z = 0; z < splits; ++z) {
      const float4 t = recv[z * m + j];
      v[0] += t.x;
      v[1] += t.y;
      v[2] += t.z;
      v[3] += t.w;
    }
    uint2 bi = own_b, r = own_r, r2 = own_r2;
    float4 sc = own_s;
    if (j != threadIdx.x) quad_in(i, bi, sc, r, r2);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bi);
    const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (WL::kScaled ? v[e] * sv[e] : v[e]) + __bfloat162float(bv[e]);
    gemv_store4<EPI>(v, (size_t)b * N + c0 + c, r, r2, aux, y32, y, rs);
  }
}

// ---------------------------------------------------------------------------
// attn_kernel: grid (B, H, splits), one token of one layer. Caches k/v
// [B, R, A] (CT = bf16, or int8 with bf16 row scales ks/vs [B, R]); the
// fp32 q row b at q + b * qstride; the live rows are r0 .. r0 + n - 1, and split z of the
// grid reads rows r0 + z * chunk .. + chunk - 1 (the last split ragged).
// The token's new k, v (bf16 rows of stride qstride; for INT8 also their
// fp32 values k32 / v32, rows of stride stride32) go to slot w (w < 0: no
// write, knew may be null). Split 0 of each head writes that head's
// columns of the slot (and head 0 the int8 row scales); no block reads the
// slot row from the cache: the split holding it takes its score and value
// from knew / vnew, as the megakernel's sc_new / w_ins patch does.
//
// Each block: q in registers, its rows read 16 bytes a lane (8 bf16 or 16
// int8 values; 2 values a lane when the head width is not a multiple of
// that; CPL vectors a lane), U rows in flight per warp; block-wide max and
// sum of its scores; P.V accumulated per warp in fp32 and summed in shared
// memory.
//   splits == 1: p = e / sum in fp32 and o written directly.
//   splits > 1: the split's max m, sum l of e = exp(s - m) and fp32 partial
//     output sum(e v) (int8: sum(e * v_scale * v_int)) go to the
//     workspace ws [B, H, splits, 2 + hd]; the block that arrives last at
//     the (b, h) counter (atomicAdd after __threadfence) combines them, each
//     warp a fixed subset of splits and the warps summed in a fixed order,
//     so the result does not depend on which block came last: o = sum_z
//     exp(m_z - M) acc_z / sum_z exp(m_z - M) l_z. It resets the counter
//     for the next launch.
// Dynamic shared memory: per-warp partial outputs [kWarps][hd] | scores
// [chunk], fp32.
// ---------------------------------------------------------------------------
constexpr int kMaxHead = 512;

template <typename CT, int VEC>
struct RowLoad;

template <>
struct RowLoad<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h2[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
};

template <>
struct RowLoad<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = t.x;
    f[1] = t.y;
  }
};

template <>
struct RowLoad<int8_t, 16> {
  static __device__ __forceinline__ void load(const int8_t* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = static_cast<float>(c[j]);
  }
};

template <>
struct RowLoad<int8_t, 2> {
  static __device__ __forceinline__ void load(const int8_t* p, float* f) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = static_cast<float>(c.x);
    f[1] = static_cast<float>(c.y);
  }
};

template <bool INT8, int VEC, int CPL>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, int qstride,
            const __nv_bfloat16* __restrict__ knew,
            const __nv_bfloat16* __restrict__ vnew,
            const float* __restrict__ k32, const float* __restrict__ v32,
            int stride32,
            typename std::conditional<INT8, int8_t, __nv_bfloat16>::type* kc,
            typename std::conditional<INT8, int8_t, __nv_bfloat16>::type* vc,
            __nv_bfloat16* __restrict__ ks, __nv_bfloat16* __restrict__ vs,
            __nv_bfloat16* __restrict__ o, float* __restrict__ ws,
            int* __restrict__ counters, int A, int H, int R, int r0, int n,
            int w, int chunk, float scale) {
  using CT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  constexpr int NE = CPL * VEC;              // values a lane, at most
  constexpr int U = NE >= 16 ? 4 : 8;        // rows in flight per warp
  extern __shared__ float sm[];
  __shared__ float scratch[kWarps], wl[kWarps];
  __shared__ int is_last;
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int splits = gridDim.z, hd = A / H, nvec = hd / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = z * chunk, cnt = min(chunk, n - lo);
  float* part = sm;
  float* sc = sm + kWarps * hd;
  // the slot row's index among this split's rows, or -1
  const int ins = (w >= r0 + lo && w < r0 + lo + cnt) ? w - r0 - lo : -1;

  const __nv_bfloat16* kn = w >= 0 ? knew + (size_t)b * qstride + h * hd
                                   : nullptr;
  const __nv_bfloat16* vn = w >= 0 ? vnew + (size_t)b * qstride + h * hd
                                   : nullptr;
  CT* kb = kc + (size_t)b * R * A + h * hd;
  CT* vb = vc + (size_t)b * R * A + h * hd;

  if (w >= 0 && z == 0) {
    if constexpr (INT8) {
      // quantise the row from its fp32 values: the scale is over all A
      // columns (every head's block derives the same one)
      const float* k32r = k32 + (size_t)b * stride32;
      const float* v32r = v32 + (size_t)b * stride32;
      float km = 0.0f, vm = 0.0f;
      for (int i = threadIdx.x; i < A; i += kThreads) {
        km = fmaxf(km, fabsf(k32r[i]));
        vm = fmaxf(vm, fabsf(v32r[i]));
      }
      km = block_max(km, scratch);
      vm = block_max(vm, scratch);
      const float ksc = fmaxf(km / 127.0f, 1e-8f);
      const float vsc = fmaxf(vm / 127.0f, 1e-8f);
      const float kinv = 1.0f / ksc, vinv = 1.0f / vsc;
      for (int d = threadIdx.x; d < hd; d += kThreads) {
        const float kq = rintf(k32r[h * hd + d] * kinv);
        const float vq = rintf(v32r[h * hd + d] * vinv);
        kb[(size_t)w * A + d] = (CT)(int)fminf(fmaxf(kq, -127.0f), 127.0f);
        vb[(size_t)w * A + d] = (CT)(int)fminf(fmaxf(vq, -127.0f), 127.0f);
      }
      if (h == 0 && threadIdx.x == 0) {
        ks[(size_t)b * R + w] = __float2bfloat16(ksc);
        vs[(size_t)b * R + w] = __float2bfloat16(vsc);
      }
    } else {
      for (int d = threadIdx.x; d < hd; d += kThreads) {
        kb[(size_t)w * A + d] = kn[d];
        vb[(size_t)w * A + d] = vn[d];
      }
    }
  }

  // q (times scale) in registers, in the lane's vector layout
  float qf[NE];
  {
    const float* qrow = q + (size_t)b * qstride + h * hd;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int v = lane + 32 * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qf[c * VEC + e] = v < nvec ? qrow[v * VEC + e] * scale : 0.0f;
    }
  }
  const float kscale = INT8 ? 1.0f : scale;  // bf16: (q s) . (k s)

  // scores of this split's rows, U rows in flight per warp
  for (int i0 = warp; i0 < cnt; i0 += kWarps * U) {
    float kv[U][NE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = i0 + u * kWarps;
      const bool live = l < cnt && l != ins;
      const CT* row = kb + (size_t)(r0 + lo + l) * A;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int v = lane + 32 * c;
        if (live && v < nvec) {
          RowLoad<CT, VEC>::load(row + v * VEC, &kv[u][c * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[u][c * VEC + e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < NE; ++e) s = fmaf(qf[e], kv[u][e] * kscale, s);
      s = warp_sum(s);
      const int l = i0 + u * kWarps;
      if (lane == 0 && l < cnt && l != ins) {
        if constexpr (INT8)
          s *= __bfloat162float(ks[(size_t)b * R + r0 + lo + l]) * scale;
        sc[l] = s;
      }
    }
  }
  if (ins >= 0 && warp == 0) {  // the slot row's score from its bf16 k
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int v = lane + 32 * c;
      if (v < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s = fmaf(qf[c * VEC + e],
                   __bfloat162float(kn[v * VEC + e]) * scale, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) sc[ins] = s;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int l = threadIdx.x; l < cnt; l += kThreads) m = fmaxf(m, sc[l]);
  m = block_max(m, scratch);
  float sum = 0.0f;
  for (int l = threadIdx.x; l < cnt; l += kThreads) {
    const float e = expf(sc[l] - m);
    sc[l] = e;
    sum += e;
  }
  sum = block_sum(sum, scratch);  // ends in __syncthreads: sc[] is complete
  for (int l = threadIdx.x; l < cnt; l += kThreads) {
    // one split: the normalised weight; several: exp(s - m) of the split;
    // fp32 either way (int8: the V row scales fold into them)
    float p = splits == 1 ? sc[l] / sum : sc[l];
    if (INT8 && l != ins)
      p *= __bfloat162float(vs[(size_t)b * R + r0 + lo + l]);
    sc[l] = p;
  }
  __syncthreads();

  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.0f;
  for (int i0 = warp; i0 < cnt; i0 += kWarps * U) {
    float vv[U][NE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = i0 + u * kWarps;
      const bool live = l < cnt && l != ins;
      const CT* row = vb + (size_t)(r0 + lo + l) * A;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int v = lane + 32 * c;
        if (live && v < nvec) {
          RowLoad<CT, VEC>::load(row + v * VEC, &vv[u][c * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vv[u][c * VEC + e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = i0 + u * kWarps;
      const float p = (l < cnt && l != ins) ? sc[l] : 0.0f;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
  }
  if (ins >= 0 && warp == 0) {  // the slot row's value from its bf16 v
    const float p = sc[ins];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int v = lane + 32 * c;
      if (v < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[c * VEC + e] = fmaf(p, __bfloat162float(vn[v * VEC + e]),
                                  acc[c * VEC + e]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int v = lane + 32 * c;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        part[warp * hd + v * VEC + e] = acc[c * VEC + e];
    }
  }
  __syncthreads();

  const int bh = b * H + h;
  if (splits == 1) {
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) s += part[ww * hd + d];
      o[(size_t)b * A + h * hd + d] = __float2bfloat16(s);
    }
    return;
  }

  // several splits: publish this split's (m, l, partial output)
  const int wst = 2 + hd;
  float* mine = ws + ((size_t)bh * splits + z) * wst;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s += part[ww * hd + d];
    mine[2 + d] = s;
  }
  if (threadIdx.x == 0) {
    mine[0] = m;
    mine[1] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[bh], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block combines every split: warp ww takes splits ww, ww +
  // kWarps, ..., its lanes the columns; then the warps are summed in order
  const float* all = ws + (size_t)bh * splits * wst;
  float gm = -INFINITY;
  for (int s = lane; s < splits; s += 32)
    gm = fmaxf(gm, __ldcg(all + (size_t)s * wst));
  gm = warp_max(gm);
  float num[kMaxHead / 32], den = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxHead / 32; ++j) num[j] = 0.0f;
  for (int s = warp; s < splits; s += kWarps) {
    const float* ps = all + (size_t)s * wst;
    const float f = expf(__ldcg(ps) - gm);
    den = fmaf(f, __ldcg(ps + 1), den);
#pragma unroll
    for (int j = 0; j < kMaxHead / 32; ++j)
      if (lane + 32 * j < hd)
        num[j] = fmaf(f, __ldcg(ps + 2 + lane + 32 * j), num[j]);
  }
  __syncthreads();  // part[] is free again
#pragma unroll
  for (int j = 0; j < kMaxHead / 32; ++j)
    if (lane + 32 * j < hd) part[warp * hd + lane + 32 * j] = num[j];
  if (lane == 0) wl[warp] = den;
  __syncthreads();
  float tden = 0.0f;
#pragma unroll
  for (int ww = 0; ww < kWarps; ++ww) tden += wl[ww];
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s += part[ww * hd + d];
    o[(size_t)b * A + h * hd + d] = __float2bfloat16(s / tden);
  }
  if (threadIdx.x == 0) counters[bh] = 0;
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

// The pointers and sizes of one GEMV launch (s: int8 only; lng, lnb and
// pitch: the LayerNorm prologue only).
struct GemvArgs {
  const __nv_bfloat16* x;
  const void* W;
  const float* s;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;
  const __nv_bfloat16* res2;
  __nv_bfloat16* aux;
  float* y32;
  __nv_bfloat16* y;
  const float* lng;
  const float* lnb;
  int B, K, N, splits, chunk, pitch;
  float rs, eps;
};

// Dynamic shared memory of one GEMV block (bytes): its warps' sums, and
// under the LayerNorm prologue (pitch > 0) its normalised rows and its
// columns of g and b
size_t gemv_smem(int B, int pitch) {
  return (size_t)kGemvWarps * B * kGemvRedPitch * sizeof(float) +
         (size_t)B * pitch * sizeof(__nv_bfloat16) +
         (size_t)2 * pitch * sizeof(float);
}

// One launch: grid (column tiles, splits), the splits of a tile one
// cluster
template <class WL, int BT, int EPI, bool V16, int U>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  constexpr bool LN = EPI == 0 || EPI == 1;
  auto kernel = gemv_kernel<WL, BT, EPI, V16, U>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LN ? kMaxDynSmem : (int)gemv_smem(BT, 0));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.N + kGemvCols - 1) / kGemvCols, a.splits);
  config.blockDim = dim3(kGemvThreads);
  config.dynamicSmemBytes = gemv_smem(a.B, LN ? a.pitch : 0);
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = a.splits;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, a.x,
                            (const typename WL::T*)a.W, a.s, a.bias, a.res,
                            a.res2, a.aux, a.y32, a.y, a.lng, a.lnb, a.B,
                            a.K, a.N, a.chunk, a.pitch, a.rs, a.eps);
}

// U: the steps a lane keeps in flight: two where a split has 15 or 16
// steps (B <= 8: every warp but at most one has two), so all of a small
// product's loads are issued at once; else one (fewer second steps gain
// nothing: scripts/chip_gemv_ln_probe.py).
template <class WL, int BT, bool V16, int U>
cudaError_t launch_gemv_epi(int epi, const GemvArgs& a, cudaStream_t st) {
  switch (epi) {
    case 0: return launch_gemv<WL, BT, 0, V16, U>(a, st);
    case 1: return launch_gemv<WL, BT, 1, V16, U>(a, st);
    case 2: return launch_gemv<WL, BT, 2, V16, U>(a, st);
    case 3: return launch_gemv<WL, BT, 3, V16, U>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <class WL, bool V16>
cudaError_t launch_gemv_b(int epi, const GemvArgs& a, cudaStream_t st) {
  const int steps = (a.chunk + kGemvStep - 1) / kGemvStep;
  if (a.B > 8) return launch_gemv_epi<WL, 16, V16, 1>(epi, a, st);
  if (steps >= 2 * kGemvWarps - 1 && steps <= 2 * kGemvWarps)
    return launch_gemv_epi<WL, 8, V16, 2>(epi, a, st);
  return launch_gemv_epi<WL, 8, V16, 1>(epi, a, st);
}

// A GEMV over splits K slices of chunk rows (split z: rows z * chunk ..
// + chunk - 1, the last ragged; chunk a multiple of 16; 1 <= splits <=
// 16). vec16: N % 16 == 0 (int8: W's rows are read 16 bytes a lane, else
// 8; bf16: every lane's 16 columns lie in N). epi 0 and 1 take the
// LayerNorm prologue and 2 and 3 none: lng, lnb, the prologue's fp32 gain
// and bias [K] (given exactly for epi 0 and 1), with pitch (>= chunk, a
// multiple of 4) the row pitch of its normalised rows in shared memory and
// eps its epsilon.
template <class WL>
int gemv_entry(const void* x, const void* W, const void* s, const void* bias,
               const void* res, const void* res2, void* aux, void* y32,
               void* y, const void* lng, const void* lnb, int B, int K,
               int N, int splits, int chunk, int pitch, int epi, int vec16,
               float rs, float eps, void* stream) {
  const bool ln = epi == 0 || epi == 1;
  if (epi < 0 || epi > 3 || B < 1 || B > 16 || K < 1 || N < 8 || N % 8 || splits < 1 ||
      splits > kGemvMaxSplits || chunk < kGemvStep || chunk % kGemvStep ||
      (long)(splits - 1) * chunk >= K || (long)splits * chunk < K ||
      (vec16 && N % 16) || (WL::kScaled != (s != nullptr)) ||
      ln != (lng != nullptr) || ln != (lnb != nullptr) ||
      (ln && (pitch < chunk || pitch % 4 ||
              gemv_smem(B, pitch) > (size_t)kMaxDynSmem)))
    return (int)cudaErrorInvalidValue;
  const GemvArgs a{(const __nv_bfloat16*)x, W, (const float*)s,
                   (const __nv_bfloat16*)bias, (const __nv_bfloat16*)res,
                   (const __nv_bfloat16*)res2, (__nv_bfloat16*)aux,
                   (float*)y32, (__nv_bfloat16*)y, (const float*)lng,
                   (const float*)lnb, B, K, N, splits, chunk,
                   ln ? pitch : 0, rs, eps};
  const auto st = (cudaStream_t)stream;
  return (int)(vec16 ? launch_gemv_b<WL, true>(epi, a, st)
                     : launch_gemv_b<WL, false>(epi, a, st));
}

// Dynamic shared memory of one attention block (bytes).
size_t attn_smem(int hd, int chunk) {
  return (size_t)(kWarps * hd + chunk) * sizeof(float);
}

template <bool INT8, int VEC, int CPL>
int attn_launch(const void* q, int qstride, const void* knew,
                const void* vnew, const void* k32, const void* v32,
                int stride32, void* kc, void* vc, void* ks, void* vs, void* o,
                void* ws, void* counters, int B, int A, int H, int R, int r0,
                int n, int w, int splits, int chunk, float scale,
                void* stream) {
  using CT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  static bool configured = false;
  const cudaError_t e =
      allow_dyn_smem(attn_kernel<INT8, VEC, CPL>, &configured);
  if (e != cudaSuccess) return (int)e;
  attn_kernel<INT8, VEC, CPL>
      <<<dim3(B, H, splits), kThreads, attn_smem(A / H, chunk),
         (cudaStream_t)stream>>>(
          (const float*)q, qstride, (const __nv_bfloat16*)knew,
          (const __nv_bfloat16*)vnew, (const float*)k32, (const float*)v32,
          stride32, (CT*)kc, (CT*)vc, (__nv_bfloat16*)ks,
          (__nv_bfloat16*)vs, (__nv_bfloat16*)o, (float*)ws, (int*)counters,
          A, H, R, r0, n, w, chunk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a launch may ask for (bytes).
int jk_max_dyn_smem() { return kMaxDynSmem; }

// The GEMVs (gemv_entry): W bf16 with s null, or int8 with its fp32
// column scales s; lng / lnb the LayerNorm prologue's (epi 0 and 1), else
// null.
int jk_gemv_bf16(const void* x, const void* W, const void* s,
                 const void* bias, const void* res, const void* res2,
                 void* aux, void* y32, void* y, const void* lng,
                 const void* lnb, int B, int K, int N, int splits, int chunk,
                 int pitch, int epi, int vec16, float rs, float eps,
                 void* stream) {
  return gemv_entry<Bf16Weights>(x, W, s, bias, res, res2, aux, y32, y, lng,
                                 lnb, B, K, N, splits, chunk, pitch, epi,
                                 vec16, rs, eps, stream);
}

int jk_gemv_int8(const void* x, const void* W, const void* s,
                 const void* bias, const void* res, const void* res2,
                 void* aux, void* y32, void* y, const void* lng,
                 const void* lnb, int B, int K, int N, int splits, int chunk,
                 int pitch, int epi, int vec16, float rs, float eps,
                 void* stream) {
  return gemv_entry<I8Weights>(x, W, s, bias, res, res2, aux, y32, y, lng,
                               lnb, B, K, N, splits, chunk, pitch, epi, vec16,
                               rs, eps, stream);
}

// The attention kernels, q the fp32 q rows (row b at b * qstride floats):
// int8 == 0 bf16 caches (ks, vs, k32, v32 unused),
// 1 int8 caches with bf16 row scales, the new row quantised from its fp32
// values k32 / v32 (rows of stride stride32). knew / vnew may be null when
// w < 0. splits > 1 needs ws (B * H * splits * (2 + hd) floats) and
// counters (B * H ints, zero; every launch leaves them zero). A head row is
// read 16 bytes a lane when the head width and A are multiples of 8 (bf16)
// or 16 (int8), else 2 values a lane.
int jk_attn_decode(const void* q, int qstride, const void* knew,
                   const void* vnew, const void* k32, const void* v32,
                   int stride32, void* kc, void* vc, void* ks, void* vs,
                   void* o, void* ws, void* counters, int B, int A, int H,
                   int R, int r0, int n, int w, int splits, int chunk,
                   float scale, int int8, void* stream) {
  const int hd = A / H;
  if (A % H || hd % 2 || hd > kMaxHead || splits < 1 || chunk < 1 ||
      (long)(splits - 1) * chunk >= n || (long)splits * chunk < n ||
      attn_smem(hd, chunk) > (size_t)kMaxDynSmem)
    return (int)cudaErrorInvalidValue;
#define JK_ATTN(I8, V, C)                                                    \
  attn_launch<I8, V, C>(q, qstride, knew, vnew, k32, v32, stride32, kc, vc,  \
                        ks, vs, o, ws, counters, B, A, H, R, r0, n, w,       \
                        splits, chunk, scale, stream)
  // VEC values a lane per load, CPL loads a lane per row
  if (int8) {
    if (hd % 16 == 0 && A % 16 == 0) return JK_ATTN(true, 16, 1);
    return hd <= 256 ? JK_ATTN(true, 2, 4) : JK_ATTN(true, 2, 8);
  }
  if (hd % 8 == 0 && A % 8 == 0)
    return hd <= 256 ? JK_ATTN(false, 8, 1) : JK_ATTN(false, 8, 2);
  return hd <= 256 ? JK_ATTN(false, 2, 4) : JK_ATTN(false, 2, 8);
#undef JK_ATTN
}

}  // extern "C"
