"""Decode-step kernels of the port: wrappers, plain versions, launch counts.

Replaces jukebox_tpu/ops/pallas/decode_stack.py::build_stack_decode, the
whole-stack Pallas megakernel that runs every sampled token of the priors.
The port keeps what that kernel computes per layer (fp32-statistics
LayerNorm -> qkv -> ring-cache attention -> proj + residual -> LayerNorm ->
quick_gelu MLP + residual; each LayerNorm the prologue of the GEMV after it,
so a layer launches 5 kernels) in all its options (bf16 or int8 weights,
bf16 or int8 ring caches, f6 cross-attention, any head width, res_scale) and
drops its TPU blocking (single launch, ping-pong VMEM canvas, slot-leading
lane-padded caches): here the CUDA kernels of csrc/decode_stack.cu run per
layer against the standard cache layout [B, slots, A] of
models/attention.py. An int8 cache is {"k", "v"} int8 [B, ..., A] with
{"ks", "vs"} bf16 [B, ...]: one scale per (batch row, slot). The attention
kernels split a head's live rows over blocks (attn_split_plan) and combine
the splits in the same launch, through an fp32 workspace and counters kept
per device (workspace); the GEMVs split their K rows over the blocks of a
thread block cluster (gemv_split_plan) and combine them in the cluster's
shared memory, and so do the LayerNorm prologue's row statistics.

Each wrapper takes the plain PyTorch version for tensors on the CPU (that is
what the CPU tests run) and, for CUDA tensors, checks device, dtype, shape
and contiguity, launches its kernel on the current stream, raises if the
launch failed, and adds one to LAUNCHES[name]. While torch.profiler
records, the launch's host time, from its checks to the return of its
ctypes call, goes to the counter launch_host.<name> (utils/profiler.py).
There is no fallback from a CUDA tensor to the plain version.
"""

import functools
import time

import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.parallel.dist import (all_reduce_, gather_cols,
                                             rank_cols)
from jukebox_tpu_torch.utils import profiler

LAUNCHES = {"ln_gemv_bf16": 0, "ln_gemv_int8": 0, "gemv_bf16": 0,
            "gemv_int8": 0, "ring_attn_decode": 0, "ring_attn_int8": 0,
            "cross_attn_decode": 0}
EPILOGUES = {None: 0, "gelu": 1, "residual": 2, "res_scale": 3}
MAX_BATCH = 16
BF16 = torch.bfloat16


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def layer_launches(attn_func, quantized, cache_int8):
    """Kernel launches of one decode step of one layer (stack_layer_step)."""
    attn = ("cross_attn_decode" if attn_func == 6 else
            "ring_attn_int8" if cache_int8 else "ring_attn_decode")
    gemv = "gemv_int8" if quantized else "gemv_bf16"
    return {"ln_" + gemv: 2, gemv: 2, attn: 1}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _require(t, name, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like the others")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _check(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(t):
    """A tensor's address for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The LayerNorm of the decode step: [B, S], fp32 statistics, fp32 g/b. It
# has no kernel of its own: the GEMV that reads it normalises its rows in
# a prologue (gemv(..., ln=(g, b))), and this is the prologue's plain
# version.
# ---------------------------------------------------------------------------

# The plain versions compute in fp32 and round to the input's dtype where
# the kernels round to bf16, so fed fp32 they compute the JAX package's fp32
# decode path up to fp32 rounding.

def ln_rows_plain(x, g, b, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


# ---------------------------------------------------------------------------
# gemv_bf16 / gemv_int8: y = epilogue(x @ W (* s) + b); W (in, out) bf16, or
# int8 with fp32 per-column scales s applied after the fp32 accumulation
# ---------------------------------------------------------------------------

def _epilogue(y, x_dtype, epilogue, res, res2, rs, keep, out32=False):
    """y fp32 (the product, scaled, plus bias) -> the epilogue's output in
    x_dtype, rounding where the kernels round to bf16; with out32, also y
    itself."""
    if out32:
        return _epilogue(y, x_dtype, epilogue, res, res2, rs, keep), y
    if epilogue == "gelu":
        return (y * torch.sigmoid(1.702 * y)).to(x_dtype)
    if epilogue is None:
        return y.to(x_dtype)
    a = y.to(x_dtype)
    if epilogue == "residual":
        out = (res.float() + a.float()).to(x_dtype)
        return (out, a) if keep else out
    am = (res2.float() + a.float()).to(x_dtype)
    rsb = torch.tensor(rs, dtype=x_dtype).float()
    return (res.float() + (am.float() * rsb).to(x_dtype).float()).to(x_dtype)


def _gemv_plain(x, w, s, b, epilogue, res, res2, rs, keep, out32, ln):
    if ln is not None:
        x = ln_rows_plain(x, *ln)
    y = x.float() @ w.float()
    if s is not None:
        y = y * s.float()
    y = y + b.float()
    return _epilogue(y, x.dtype, epilogue, res, res2, rs, keep, out32)


def gemv_bf16_plain(x, w, b, epilogue=None, res=None, res2=None, rs=1.0,
                    keep=False, out32=False):
    return _gemv_plain(x, w, None, b, epilogue, res, res2, rs, keep, out32,
                       None)


def gemv_int8_plain(x, w_q, s, b, epilogue=None, res=None, res2=None,
                    rs=1.0, keep=False, out32=False):
    return _gemv_plain(x, w_q, s, b, epilogue, res, res2, rs, keep, out32,
                       None)


def ln_gemv_bf16_plain(x, w, b, ln, epilogue=None, out32=False):
    """gemv_bf16_plain of the LayerNorm ln_rows_plain(x, *ln): the plain
    version of gemv_bf16(..., ln=ln)."""
    return _gemv_plain(x, w, None, b, epilogue, None, None, 1.0, False,
                       out32, ln)


def ln_gemv_int8_plain(x, w_q, s, b, ln, epilogue=None, out32=False):
    """gemv_int8_plain of the LayerNorm ln_rows_plain(x, *ln)."""
    return _gemv_plain(x, w_q, s, b, epilogue, None, None, 1.0, False, out32,
                       ln)


def _check_epilogue(epilogue, res, res2, keep, out32=False, ln=None):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (epilogue in ("residual", "res_scale")) != (res is not None):
        raise ValueError("res is given exactly for the residual epilogues")
    if (epilogue == "res_scale") != (res2 is not None):
        raise ValueError("res2 is given exactly for the res_scale epilogue")
    if keep and epilogue != "residual":
        raise ValueError("keep returns the product beside a residual only")
    if out32 and keep:
        raise ValueError("out32 and keep do not combine")
    if (ln is not None) != (epilogue in LN_EPILOGUES):
        raise ValueError(f"ln (the LayerNorm prologue) is given exactly for "
                         f"the epilogues {LN_EPILOGUES}, not {epilogue!r}")


# The LayerNorm prologue keeps the block's normalised rows in shared memory
# beside the warps' sums: [B][pitch] bf16, pitch = chunk rounded up to 16
# mod 64 elements, and its columns of g and b (csrc/decode_stack.cu
# gemv_ln_load, gemv_ln_stats)
LN_EPILOGUES = (None, "gelu")
LN_EPS = 1e-5


def ln_pitch(chunk):
    """Row pitch (elements) of the prologue's normalised rows: chunk
    rounded up to 16 mod 64, so the loop's 8-byte reads of 8 rows fall on
    distinct banks."""
    return chunk + (16 - chunk) % 64


def gemv_smem(B, pitch=0):
    """Dynamic shared memory of one GEMV block (bytes): its 8 warps' fp32
    sums [8][B][GEMV_COLS + 4], and under the LayerNorm prologue (pitch >
    0) its normalised rows [B][pitch] bf16 and its columns of g and b
    [2][pitch] fp32."""
    return 8 * B * (GEMV_COLS + 4) * 4 + B * pitch * 2 + 2 * pitch * 4


def _gemv_launch(name, x, w, s, b, epilogue, res, res2, rs, keep, out32,
                 ln):
    t0 = profiler.fine_start()
    B, K = x.shape
    N = w.shape[1]
    if not 1 <= B <= MAX_BATCH or N % 8:
        raise ValueError(f"{name} takes 1..{MAX_BATCH} rows and N % 8 == 0 "
                         f"(got B={B}, K={K}, N={N})")
    int8 = s is not None
    _require(x, "x", BF16)
    _require(w, "w", torch.int8 if int8 else BF16, (K, N))
    _require(b, "b", BF16, (N,))
    if int8:
        _require(s, "s", torch.float32, (N,))
    for nm, t in (("res", res), ("res2", res2)):
        if t is not None:
            _require(t, nm, BF16, (B, N))
    lib = _build.lib()
    splits, chunk, _ = gemv_split_plan(K, N, sm_count(x.device))
    key, pitch = name, 0  # key: the LAUNCHES count
    if ln is not None:  # the epilogues None and "gelu"
        _require(ln[0], "ln g", torch.float32, (K,))
        _require(ln[1], "ln b", torch.float32, (K,))
        pitch = ln_pitch(chunk)
        if gemv_smem(B, pitch) > lib.jk_max_dyn_smem():
            raise ValueError(f"ln_{name}: {B} rows of {chunk} columns a block "
                             f"exceed the kernel's shared memory")
        key = "ln_" + name
    y = torch.empty((B, N), dtype=BF16, device=x.device)
    aux = torch.empty_like(y) if keep else None
    y32 = (torch.empty((B, N), dtype=torch.float32, device=x.device)
           if out32 else None)
    g_ln, b_ln = (None, None) if ln is None else ln
    err = getattr(lib, f"jk_{name}")(
        x.data_ptr(), w.data_ptr(), _ptr(s), b.data_ptr(), _ptr(res),
        _ptr(res2), _ptr(aux), _ptr(y32), y.data_ptr(), _ptr(g_ln),
        _ptr(b_ln), B, K, N, splits, chunk, pitch, EPILOGUES[epilogue],
        int(N % 16 == 0), float(rs), LN_EPS, _stream())
    if t0:
        profiler.add(f"launch_host.{key}", time.time_ns() - t0)
    _check(err, key)
    _build.count(LAUNCHES, key)
    return (y, aux) if keep else (y, y32) if out32 else y


def gemv_bf16(x, w, b, epilogue=None, res=None, res2=None, rs=1.0,
              keep=False, out32=False, ln=None):
    """epilogue: None, "gelu" (quick_gelu), "residual" (res + bf16(y); with
    keep=True also returns bf16(y)) or "res_scale" (res + bf16(bf16(res2 +
    bf16(y)) * bf16(rs)): x + (a + m) * res_scale with res = x, res2 = a).
    out32=True also returns y in fp32 (the product plus bias, before the
    epilogue), written by the same launch. The epilogues None and "gelu"
    take the LayerNorm prologue and need ln=(g, b) (fp32 [K]): x is the raw
    residual stream and the product reads its LayerNorm,
    ln_rows_plain(x, g, b), computed by the same launch (counted as
    ln_gemv_bf16); the residual epilogues take none."""
    _check_epilogue(epilogue, res, res2, keep, out32, ln)
    if not x.is_cuda:
        if ln is not None:
            return ln_gemv_bf16_plain(x, w, b, ln, epilogue, out32)
        return gemv_bf16_plain(x, w, b, epilogue, res, res2, rs, keep, out32)
    return _gemv_launch("gemv_bf16", x, w, None, b, epilogue, res, res2, rs,
                        keep, out32, ln)


def gemv_int8(x, w_q, s, b, epilogue=None, res=None, res2=None, rs=1.0,
              keep=False, out32=False, ln=None):
    """gemv_bf16 with int8 weights w_q (in, out) and fp32 column scales s:
    y = (x @ w_q) * s + b, accumulated in fp32, then the epilogue."""
    _check_epilogue(epilogue, res, res2, keep, out32, ln)
    if not x.is_cuda:
        if ln is not None:
            return ln_gemv_int8_plain(x, w_q, s, b, ln, epilogue, out32)
        return gemv_int8_plain(x, w_q, s, b, epilogue, res, res2, rs, keep,
                               out32)
    return _gemv_launch("gemv_int8", x, w_q, s, b, epilogue, res, res2, rs,
                        keep, out32, ln)


def gemv(x, p, epilogue=None, res=None, res2=None, rs=1.0, keep=False,
         plain=False, out32=False, ln=None):
    """The GEMV of a staged dense dict: {"w", "b"} -> gemv_bf16,
    {"w_q", "s", "b"} -> gemv_int8 (plain=True: their plain versions);
    ln=(g, b): the LayerNorm prologue, given exactly for the epilogues None
    and "gelu"."""
    int8 = "w_q" in p
    wts = (p["w_q"], p["s"]) if int8 else (p["w"],)
    if plain:
        _check_epilogue(epilogue, res, res2, keep, out32, ln)
    if plain and ln is not None:
        fn = ln_gemv_int8_plain if int8 else ln_gemv_bf16_plain
        return fn(x, *wts, p["b"], ln, epilogue, out32)
    if plain:
        fn = gemv_int8_plain if int8 else gemv_bf16_plain
        return fn(x, *wts, p["b"], epilogue, res, res2, rs, keep, out32)
    fn = gemv_int8 if int8 else gemv_bf16
    return fn(x, *wts, p["b"], epilogue, res, res2, rs, keep, out32, ln)


# ---------------------------------------------------------------------------
# ring_attn_decode: one token of one layer against its ring cache
# ---------------------------------------------------------------------------

def ring_geometry(attn_func, t, cache_shape, block_ctx=None, prime_len=None):
    """Where token t of an attn_func layer writes and which rows it reads,
    for the standard cache layouts of models/attention.py viewed as
    [B, rows, A]: returns (rows, write_row or -1, first_read_row, n_read).

    The rows read are contiguous in every pattern; rows that the JAX decode
    path masks (NEG = -1e9 before the softmax, so exp(.) == 0 exactly) are
    simply not read. Patterns (models/attention.py decode_step):
      f0 dense  [B, n_ctx, A]: write t, read 0..t
      f1 row    [B, bc, A]: write t % bc, read 0..t % bc
      f2 column [B, bc, blocks, A]: write (t % bc, t // bc), read column
                t % bc, blocks 0..t // bc
      f3 prev   [B, 2bc, A]: write ring (t // bc) % 2 slot t % bc, read the
                whole previous ring ((t // bc) - 1) % 2 UNMASKED (in the first
                block that ring is the zero init: scores 0, output 0)
      f4 summary [B, blocks + 1, A]: row 0 the zero pad (it scores 0 and
                adds its weight to the softmax, as the JAX mask keeps it);
                write row 1 + t // bc at a block's last token, else
                nothing; read rows 0..min((t + 1) // bc, blocks - 1)
      f7 prime  [B, prime_len, A]: write t while t < prime_len (later writes
                are dropped), read 0..min(t, prime_len - 1)
      f6 cross  [B, encoder_dims, A]: the read-only encoder K/V, no write,
                read every row
    """
    rows = 1
    for d in cache_shape[1:-1]:
        rows *= d
    if attn_func == 0:
        return rows, t, 0, t + 1
    if attn_func == 1:
        s = t % block_ctx
        return rows, s, 0, s + 1
    if attn_func == 2:
        c, blk = t % block_ctx, t // block_ctx
        blocks = cache_shape[2]
        return rows, c * blocks + blk, c * blocks, blk + 1
    if attn_func == 3:
        blk = t // block_ctx
        return (rows, (blk % 2) * block_ctx + t % block_ctx,
                ((blk - 1) % 2) * block_ctx, block_ctx)
    if attn_func == 4:
        blk, c = divmod(t, block_ctx)
        return (rows, 1 + blk if c == block_ctx - 1 else -1, 0,
                min((t + 1) // block_ctx, rows - 2) + 1)
    if attn_func == 7:
        return (rows, t if t < prime_len else -1, 0,
                min(t, prime_len - 1) + 1)
    if attn_func == 6:
        return rows, -1, 0, rows
    raise NotImplementedError(f"attn_func {attn_func} has no decode kernel")


# The split plan of the attention kernels: up to ONE_SPLIT_ROWS live rows
# run in one block per (batch row, head); more are cut into chunks of
# SPLIT_MIN_ROWS..SPLIT_MAX_ROWS rows (a multiple of the block's 8 warps),
# as many as make B x H x splits about SPLIT_WAVES blocks per SM (two:
# the blocks that fit on an SM at once, so every split runs in the first
# wave). Chosen on the H100 over 16-128 one-split rows, 16-64 row chunks
# and 1-4 waves: the short rings (24-128 rows) gain most from 16-row
# chunks, the dense f0 ring from two waves.
ONE_SPLIT_ROWS, SPLIT_MIN_ROWS, SPLIT_MAX_ROWS, SPLIT_WAVES = 32, 16, 256, 2
H100_SMS = 132


def attn_split_plan(n, B, H, hd, sms=H100_SMS):
    """(splits, chunk, workspace floats) of an attention launch over n live
    rows: split z reads rows z * chunk .. min((z + 1) * chunk, n) - 1 of
    the live range (the last split ragged), and the splits' partial sums
    take B * H * splits * (2 + hd) fp32 workspace floats (0 for one
    split). The split holding the slot row is (w - r0) // chunk."""
    if n <= ONE_SPLIT_ROWS:
        return 1, n, 0
    want = -(-SPLIT_WAVES * sms // (B * H))
    chunk = min(max(-(-n // want), SPLIT_MIN_ROWS), SPLIT_MAX_ROWS)
    chunk = -(-chunk // 8) * 8
    splits = -(-n // chunk)
    if splits == 1:
        return 1, n, 0
    return splits, chunk, B * H * splits * (2 + hd)


# The split plan of the GEMVs (gemv_bf16 and gemv_int8, one kernel
# template): a block of 8 warps owns GEMV_COLS columns and one slice of K,
# a multiple of GEMV_STEP rows (one mma step), and the slices of a column
# tile are one thread block cluster, which sums their partials in shared
# memory. K is cut into as many slices as keep tiles x splits within one
# wave of GEMV_BLOCKS_PER_SM blocks per SM (the blocks of 8 warps that fit
# on an SM at once: every block starts at once, so a small product's loads
# are all in flight together), and at most GEMV_MAX_SPLITS, a portable
# cluster (scripts/chip_gemv_ln_probe.py times 4-16).
GEMV_COLS, GEMV_STEP, GEMV_BLOCKS_PER_SM, GEMV_MAX_SPLITS = 128, 16, 2, 8


def gemv_split_plan(K, N, sms=H100_SMS):
    """(splits, chunk, tiles) of a GEMV launch over x [B, K] and W [K, N]:
    ceil(N / GEMV_COLS) column tiles, each a cluster of `splits` blocks;
    split z of a tile sums the rows z * chunk .. min((z + 1) * chunk, K) - 1
    (the last split ragged)."""
    tiles = -(-N // GEMV_COLS)
    want = max(1, min(GEMV_BLOCKS_PER_SM * sms // tiles, GEMV_MAX_SPLITS))
    chunk = -(-K // want)
    chunk = -(-chunk // GEMV_STEP) * GEMV_STEP
    return -(-K // chunk), chunk, tiles


def _attn_plain(q32, k3, v3, r0, n, n_head, dtype):
    """bf16 (or fp32) cache rows r0 .. r0 + n - 1 of [B, rows, A] against
    the fp32 q row q32 [B, A]: the megakernel's arithmetic
    (jukebox_tpu/ops/pallas/decode_stack.py:649-653, 766-799): (q * scale)
    . (k * scale) in fp32, fp32 softmax, fp32 weights times V, the head
    output rounded once to dtype."""
    B, A = q32.shape
    hd = A // n_head
    scale = hd ** -0.25
    qs = (q32.float() * scale).view(B, n_head, hd)
    kr = (k3[:, r0:r0 + n].float() * scale).view(B, n, n_head, hd)
    vr = v3[:, r0:r0 + n].float().view(B, n, n_head, hd)
    p = torch.softmax(torch.einsum("bhd,bnhd->bhn", qs, kr), dim=-1)
    o = torch.einsum("bhn,bnhd->bhd", p, vr)
    return o.reshape(B, A).to(dtype)


def ring_attn_decode_plain(qkv, k_cache, v_cache, geom, n_head, qkv32):
    B, A3 = qkv.shape
    A = A3 // 3
    rows, w, r0, n = geom
    k3 = k_cache.view(B, rows, A)
    v3 = v_cache.view(B, rows, A)
    _, k, v = qkv.split(A, dim=1)
    if w >= 0:
        k3[:, w] = k
        v3[:, w] = v
    return _attn_plain(qkv32[:, :A], k3, v3, r0, n, n_head, qkv.dtype)


def _attn_int8_plain(q32, kq, vq, ks, vs, r0, n, n_head, dtype, ins=-1,
                     k_new=None, v_new=None):
    """int8 rows r0 .. r0 + n - 1 of [B, rows, A] with row scales [B, rows]
    against the fp32 q row q32 [B, A]: the megakernel's arithmetic
    (decode_stack.py:738-810): (q * scale) . k_int * (k_scale * scale) per
    row, fp32 softmax, fp32 weights times v_scale against v_int, the head
    output rounded once to dtype; row ins (the current token's slot)
    scores and weighs its unquantised bf16 k_new, v_new instead."""
    B, A = q32.shape
    hd = A // n_head
    scale = hd ** -0.25
    qs = (q32.float() * scale).view(B, n_head, hd)
    kr = kq[:, r0:r0 + n].float().view(B, n, n_head, hd)
    vr = vq[:, r0:r0 + n].float().view(B, n, n_head, hd)
    st = torch.einsum("bhd,bnhd->bhn", qs, kr) \
        * (ks[:, r0:r0 + n].float() * scale)[:, None]
    if ins >= 0:
        kn = (k_new.float() * scale).view(B, n_head, hd)
        st[:, :, ins] = (qs * kn).sum(-1)
    p = torch.softmax(st, dim=-1)
    pv = p * vs[:, r0:r0 + n].float()[:, None]
    if ins >= 0:
        pv[:, :, ins] = 0.0
    o = torch.einsum("bhn,bnhd->bhd", pv, vr)
    if ins >= 0:
        o = o + p[:, :, ins, None] * v_new.float().view(B, n_head, hd)
    return o.reshape(B, A).to(dtype)


def quantize_row(x):
    """The megakernel's on-write int8 row (decode_stack.py:671-689): absmax
    over the last axis / 127 floored at 1e-8 (fp32 scale s), int8 =
    clip(round(x * (1 / s))), and the bf16-rounded scale. Divisors are
    tensors so the card rounds as the kernels do."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    inv = torch.ones_like(s) / s
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return q.to(torch.int8), s.to(BF16)


def quantize_rows(c):
    """An existing bf16 cache [..., A] as int8 rows and bf16 scales [...],
    as pack_caches(quantize=True) converts them at the prefill -> decode
    boundary (decode_stack.py:316-324): the same scale, but int8 =
    clip(round(x / s))."""
    cf = c.float()
    amax = cf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(cf / s), -127, 127)
    return q.to(torch.int8), s[..., 0].to(BF16)


def ring_attn_int8_plain(qkv, k_cache, v_cache, k_scale, v_scale, geom,
                         n_head, qkv32):
    B, A3 = qkv.shape
    A = A3 // 3
    rows, w, r0, n = geom
    k3, v3 = k_cache.view(B, rows, A), v_cache.view(B, rows, A)
    ks2, vs2 = k_scale.view(B, rows), v_scale.view(B, rows)
    _, k, v = qkv.split(A, dim=1)
    if w >= 0:
        _, k32, v32 = qkv32.split(A, dim=1)
        k3[:, w], ks2[:, w] = quantize_row(k32)
        v3[:, w], vs2[:, w] = quantize_row(v32)
    ins = w - r0 if r0 <= w < r0 + n else -1
    return _attn_int8_plain(qkv32[:, :A], k3, v3, ks2, vs2, r0, n, n_head,
                            qkv.dtype, ins, k, v)


def cross_attn_decode_plain(q32, k_cache, v_cache, n_head, k_scale=None,
                            v_scale=None, dtype=BF16):
    rows = k_cache.shape[1]
    if k_scale is None:
        return _attn_plain(q32, k_cache, v_cache, 0, rows, n_head, dtype)
    return _attn_int8_plain(q32, k_cache, v_cache, k_scale, v_scale, 0, rows,
                            n_head, dtype)


_WORKSPACE = {}  # (user, device) -> (fp32 workspace, int32 counters)


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The SMs of a CUDA device, the split plan's unit (the H100's for
    another device: its plain versions do not split)."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count



def workspace(user, device, floats, counters):
    """A kernel's fp32 workspace and int32 counters on `device` (user: the
    kernel's name), kept across launches and grown when a launch needs
    more, so a decode step does not pay the allocator on every layer. The
    counters start at zero and every launch leaves them at zero."""
    ws, cnt = _WORKSPACE.get((user, device), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=device)
    _WORKSPACE[(user, device)] = (ws, cnt)
    return ws, cnt


def _attn_launch(name, q, qstride, A, kv_new, caches, scales, geom, n_head,
                 kv32=(None, None)):
    """Shared checks and launch of the attention kernels; q: the fp32 q
    rows, row b at b * qstride."""
    t0 = profiler.fine_start()
    B = q.shape[0]
    rows, w, r0, n = geom
    hd = A // n_head
    if A % n_head or hd % 2 or hd > 512 or not 1 <= B <= MAX_BATCH:
        raise ValueError(f"{name} takes even head widths <= 512 and "
                         f"1..{MAX_BATCH} rows (A={A}, H={n_head}, B={B})")
    if not (0 <= r0 and r0 + n <= rows and -1 <= w < rows and n >= 1):
        raise ValueError(f"ring geometry {geom} out of range")
    lib = _build.lib()
    splits, chunk, floats = attn_split_plan(n, B, n_head, hd,
                                            sm_count(q.device))
    if (8 * hd + chunk) * 4 > lib.jk_max_dyn_smem():
        raise ValueError(f"{chunk} rows a block exceed the kernel's shared "
                         f"memory")
    _require(q, "q32", torch.float32)
    int8 = scales is not None
    for nm, c in zip(("k_cache", "v_cache"), caches):
        _require(c, nm, torch.int8 if int8 else BF16)
        if c.shape[0] != B or c.shape[-1] != A or c.numel() != B * rows * A:
            raise ValueError(f"{nm} shape {tuple(c.shape)} does not match "
                             f"[{B}, {rows} rows, {A}]")
    if int8:
        for nm, c in zip(("k_scale", "v_scale"), scales):
            _require(c, nm, BF16)
            if c.numel() != B * rows:
                raise ValueError(f"{nm} holds {c.numel()} scales, not "
                                 f"{B} x {rows}")
    ks, vs = scales if int8 else (None, None)
    ws, cnt = (workspace("attn", q.device, floats, B * n_head)
               if splits > 1 else (None, None))
    o = torch.empty((B, A), dtype=BF16, device=q.device)
    err = lib.jk_attn_decode(
        q.data_ptr(), qstride, _ptr(kv_new[0]), _ptr(kv_new[1]),
        _ptr(kv32[0]), _ptr(kv32[1]), 3 * A, caches[0].data_ptr(),
        caches[1].data_ptr(), _ptr(ks), _ptr(vs), o.data_ptr(), _ptr(ws),
        _ptr(cnt), B, A, n_head, rows, r0, n, w, splits, chunk, hd ** -0.25,
        int(int8), _stream())
    if t0:
        profiler.add(f"launch_host.{name}", time.time_ns() - t0)
    _check(err, name)
    _build.count(LAUNCHES, name)
    return o


def ring_attn_decode(qkv, k_cache, v_cache, geom, n_head, qkv32):
    """qkv [B, 3A] bf16 (q | k | v) and qkv32 [B, 3A] its fp32 values (the
    c_attn product plus bias before rounding, gemv(..., out32=True));
    caches [B, ...slots..., A] bf16, updated in place at the token's slot
    with the bf16 k, v; geom from ring_geometry. The scores take the fp32
    q, the fp32 softmax weights multiply V, and the head output is rounded
    to bf16 once, as in the megakernel. Returns [B, A]."""
    if not qkv.is_cuda:
        return ring_attn_decode_plain(qkv, k_cache, v_cache, geom, n_head,
                                      qkv32)
    _require(qkv, "qkv", BF16)
    A = qkv.shape[1] // 3
    _require(qkv32, "qkv32", torch.float32, qkv.shape)
    return _attn_launch("ring_attn_decode", qkv32, 3 * A, A,
                        (qkv[:, A:], qkv[:, 2 * A:]), (k_cache, v_cache),
                        None, geom, n_head)


def ring_attn_int8(qkv, k_cache, v_cache, k_scale, v_scale, geom, n_head,
                   qkv32):
    """ring_attn_decode against int8 caches [B, ...slots..., A] with bf16
    row scales [B, ...slots...], all updated in place at the token's slot:
    the row quantised as quantize_row does from the fp32 k, v of qkv32, as
    the megakernel quantises its fp32 accumulator; the token's own score
    and value use the bf16 k and v of qkv, the scores the fp32 q."""
    if not qkv.is_cuda:
        return ring_attn_int8_plain(qkv, k_cache, v_cache, k_scale, v_scale,
                                    geom, n_head, qkv32)
    _require(qkv, "qkv", BF16)
    A = qkv.shape[1] // 3
    _require(qkv32, "qkv32", torch.float32, qkv.shape)
    return _attn_launch("ring_attn_int8", qkv32, 3 * A, A,
                        (qkv[:, A:], qkv[:, 2 * A:]), (k_cache, v_cache),
                        (k_scale, v_scale), geom, n_head,
                        (qkv32[:, A:], qkv32[:, 2 * A:]))


def cross_attn_decode(q32, k_cache, v_cache, n_head, k_scale=None,
                      v_scale=None, dtype=BF16):
    """f6: the fp32 q row q32 [B, A] (gemv(..., out32=True) of the q-only
    c_attn) against the read-only encoder K/V [B, rows, A] (bf16, or int8
    with bf16 row scales [B, rows]). Returns [B, A] in dtype (the kernel:
    bf16)."""
    if not q32.is_cuda:
        return cross_attn_decode_plain(q32, k_cache, v_cache, n_head,
                                       k_scale, v_scale, dtype)
    if dtype != BF16:
        raise TypeError(f"cross_attn_decode returns bf16, not {dtype}")
    rows = k_cache.shape[1]
    scales = None if k_scale is None else (k_scale, v_scale)
    return _attn_launch("cross_attn_decode", q32, q32.shape[1],
                        q32.shape[1], (None, None), (k_cache, v_cache),
                        scales, (rows, -1, 0, rows), n_head)


# ---------------------------------------------------------------------------
# One layer of the decode stack, composed from the kernels
# ---------------------------------------------------------------------------

def _row_split(o, p, bias, group, plain, epilogue, res, res2=None,
               rs=1.0, keep=False):
    """A row-split product of a Megatron split: the GEMV of the rank's rows
    (zero bias, a zero residual) writes its fp32 product, summed over the
    "mp" group; the layer's bias and the epilogue follow as the kernel
    applies them (_epilogue)."""
    _, y32 = gemv(o, p, "residual", torch.zeros_like(res), plain=plain,
                  out32=True)
    y = all_reduce_(y32.contiguous(), group) + bias
    return _epilogue(y, res.dtype, epilogue, res, res2, rs, keep)


def stack_layer_step(p, cache, x, geom, n_head, plain=False, res_scale=1.0,
                     group=None, whole=False):
    """x [B, S] -> x + a + m (or x + (a + m) * res_scale) for one layer
    (ResAttnBlock.decode_step), with p the layer's staged params
    (Transformer.prepare_decode_params: "qkv" is q alone in f6 layers) and
    cache its ring cache, updated in place: {"k", "v"}, plus {"ks", "vs"}
    when int8; an f6 layer's is the read-only encoder K/V. plain=True runs
    the plain versions on any device: the reference a kernel run is held
    against. group: the "mp" group of a Megatron split, where p holds the
    rank's pieces and n_head its heads: the proj and mlp products are the
    rank's rows, all-reduced in fp32 before the bias (_row_split). With
    whole (mp does not divide the heads), n_head is the layer's and the
    cache whole: the rank's columns of q, k, v (both roundings) are
    gathered before the attention, which runs whole on every rank, and
    the proj rows read the rank's columns of its output."""
    if plain:
        ring, ring8, cross = (ring_attn_decode_plain, ring_attn_int8_plain,
                              cross_attn_decode_plain)
    else:
        ring, ring8, cross = (ring_attn_decode, ring_attn_int8,
                              cross_attn_decode)
    # the attention reads q in fp32, as the megakernel's qkv pieces; each
    # LayerNorm is the prologue of the GEMV that reads it
    qkv, qkv32 = gemv(x, p["qkv"], plain=plain, out32=True,
                      ln=(p["ln0_g"], p["ln0_b"]))
    if whole:
        parts = 1 if geom is None else 3
        qkv, qkv32 = (gather_cols(qkv, group, parts),
                      gather_cols(qkv32, group, parts))
    if geom is None:  # f6
        o = cross(qkv32, cache["k"], cache["v"], n_head, cache.get("ks"),
                  cache.get("vs"), x.dtype)
    elif "ks" in cache:
        o = ring8(qkv, cache["k"], cache["v"], cache["ks"], cache["vs"],
                  geom, n_head, qkv32)
    else:
        o = ring(qkv, cache["k"], cache["v"], geom, n_head, qkv32)
    if group is not None:
        keep = res_scale != 1.0
        if whole:
            o = rank_cols(o, group).contiguous()
        r = _row_split(o, p["proj"], p["proj_b"], group, plain, "residual",
                       x, keep=keep)
        r, a = r if keep else (r, None)
        h = gemv(r, p["fc"], "gelu", plain=plain, ln=(p["ln1_g"],
                                                       p["ln1_b"]))
        if not keep:
            return _row_split(h, p["mlp"], p["mlp_b"], group, plain,
                              "residual", r)
        return _row_split(h, p["mlp"], p["mlp_b"], group, plain,
                          "res_scale", x, a, res_scale)
    if res_scale == 1.0:
        r = gemv(o, p["proj"], "residual", x, plain=plain)
    else:
        r, a = gemv(o, p["proj"], "residual", x, keep=True, plain=plain)
    h = gemv(r, p["fc"], "gelu", plain=plain, ln=(p["ln1_g"], p["ln1_b"]))
    if res_scale == 1.0:
        return gemv(h, p["mlp"], "residual", r, plain=plain)
    return gemv(h, p["mlp"], "res_scale", x, a, res_scale, plain=plain)
