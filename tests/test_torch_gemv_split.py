"""The host plans behind two kernels of the port, pure arithmetic and
plain PyTorch on the CPU:

- the GEMVs' split plan (ops/decode_stack.py gemv_split_plan) at every
  product shape of the three priors the cascades sample (the 5b_lyrics
  top: c_attn, the f6 layers' q-only c_attn, c_proj, mlp c_fc and c_proj;
  the 1b_lyrics top's and the upsamplers' four; the plan does not depend
  on the batch): the K splits cover every row once (the last ragged), the column tiles every
  column once, a tile's splits are one portable thread block cluster (at
  most 8 blocks), the grid stays in one wave of the H100's 132 SMs and K
  is cut as far as both allow. Its arithmetic, each split's fp32 partial
  (each warp's 16-row steps in order, then the block's warps in order)
  summed in the plan's order and then scaled (int8) and biased, against jukebox_tpu.ops.core.dense on quantize_dense
  weights (fp32 x) and on fp32 copies of bf16 weights, bias and x, within
  fp32 rounding (2e-6, as test_torch_int8.py's int8 dense test), at K
  multiples of 16 and not.
- the GEMVs' LayerNorm prologue: its row statistics summed in the
  kernel's order (each split's lanes over its columns, the xor butterfly;
  each split's sum and its centred squares about its own mean, met in rank
  order: the mean, then the centred sum of squares about it),
  the normalised rows rounded to bf16 (at least 99.9% of them equal to
  jukebox_tpu.ops.core.layer_norm's bf16 output) and multiplied in the
  split order against jukebox_tpu.ops.core.dense on the same rows within
  2e-6, at K 12288, K not a multiple of 16 or of 4, and 1 and 8 splits;
  and its rows fit in shared memory beside the warps' sums at every
  LayerNorm product of the three priors at batch 1..16.
- layer_norm_fwd's grouping of rows over blocks (ops/layer_norm.py
  fwd_blocks, row_layout: a block per group of rows) and its two-pass
  statistics summed in the kernel's order (each thread over its columns, the warp's xor
  butterfly, the warps in order) against the Pallas LayerNorm forward in
  interpret mode within test_torch_layer_norm.py's 1e-4, at every row
  layout (one, two and four 16-byte vectors a thread, D up to 12288, and
  the element path of a ragged D).
- layer_norm_bwd's grouping of rows into per-block partials (ops/
  layer_norm.py bwd_blocks): each block's dg / db summed row by row in
  fp32, the partials then summed by torch.sum as the wrapper does, against
  the Pallas LayerNorm's vjp (jukebox_tpu/ops/pallas/layer_norm.py, in
  interpret mode) within test_torch_layer_norm.py's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops import core as jcore
from jukebox_tpu.ops.pallas.layer_norm import layer_norm_pallas
from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.ops import layer_norm as tln

torch.set_num_threads(1)
SMS = ds.H100_SMS
GEMV_WARPS = 8  # warps a GEMV block (csrc/decode_stack.cu kGemvWarps)
PRESETS = ["prior_5b_lyrics", "prior_1b_lyrics", "upsampler_level_0"]


def products(preset):
    """(K, N) of each GEMV of a decode layer of the preset."""
    h = setup_hparams(preset, {})
    S = h.prior_width
    A, Sm = int(h.m_attn * S), int(h.m_mlp * S)
    out = [(S, 3 * A), (A, S), (S, Sm), (Sm, S)]
    if preset == "prior_5b_lyrics":
        out.append((S, A))  # the f6 layers' q-only c_attn
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_split_plan_covers_every_product(preset):
    for K, N in products(preset):
        splits, chunk, tiles = ds.gemv_split_plan(K, N, SMS)
        assert chunk % ds.GEMV_STEP == 0 and chunk >= ds.GEMV_STEP
        rows = np.zeros(K, int)
        for z in range(splits):
            rows[z * chunk:min((z + 1) * chunk, K)] += 1
        assert (rows == 1).all() and (splits - 1) * chunk < K
        cols = np.zeros(N, int)
        for t in range(tiles):
            cols[t * ds.GEMV_COLS:(t + 1) * ds.GEMV_COLS] += 1
        assert (cols == 1).all() and (tiles - 1) * ds.GEMV_COLS < N
        # a tile's splits are one portable cluster, the grid one wave, and
        # K is cut as far as both allow
        per_wave = ds.GEMV_BLOCKS_PER_SM * SMS
        assert 1 < splits <= ds.GEMV_MAX_SPLITS <= 8, (K, N)
        assert tiles * splits <= per_wave, (K, N)
        assert splits == min(ds.GEMV_MAX_SPLITS, per_wave // tiles), (K, N)


def _bf16(a):
    """fp32 copy of a's bf16 rounding."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _split_product(xt, wt, splits, chunk):
    """x [B, K] @ w [K, N] as the GEMV sums it: split z's rows z * chunk ..
    (the owners' rank order), warp w of the split's block its 16-row steps
    w, w + 8, ... in order, the block's warps in order, all in fp32."""
    B, K = xt.shape
    acc = torch.zeros(B, wt.shape[1])
    for z in range(splits):
        lo, hi = z * chunk, min((z + 1) * chunk, K)
        warps = [torch.zeros(B, wt.shape[1]) for _ in range(GEMV_WARPS)]
        for i, k in enumerate(range(lo, hi, ds.GEMV_STEP)):
            k_end = min(k + ds.GEMV_STEP, hi)
            warps[i % GEMV_WARPS] = (warps[i % GEMV_WARPS]
                                     + xt[:, k:k_end] @ wt[k:k_end])
        block = warps[0]
        for part in warps[1:]:
            block = block + part
        acc = acc + block
    return acc


def _dense_operands(kind, K, N, rs):
    """(params for jcore.dense, the kernel's weight as fp32, bias)."""
    w = (0.02 * rs.randn(K, N)).astype(np.float32)
    b = (0.1 * rs.randn(N)).astype(np.float32)
    if kind == "int8":
        params = jcore.quantize_dense({"w": w, "b": b})
        return params, np.asarray(params["w_q"]), b
    w, b = _bf16(w), _bf16(b)  # the kernel's bf16 operands, as fp32
    return {"w": w, "b": b}, w, b


def _finish(acc, kind, params, b):
    if kind == "int8":
        acc = acc * torch.from_numpy(np.asarray(params["s"]))
    return acc + torch.from_numpy(b)


def _jax_dense(params, x):
    return np.asarray(jcore.dense(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("B,K,N", [(3, 64, 40), (5, 72, 24), (16, 200, 136),
                                   (4, 4800, 1208)], ids=str)
def test_split_sum_matches_jax_dense(B, K, N, kind):
    rs = np.random.RandomState(K + N)
    params, wk, b = _dense_operands(kind, K, N, rs)
    x = rs.randn(B, K).astype(np.float32)
    if kind == "bf16":
        x = _bf16(x)
    ref = _jax_dense(params, x)
    splits, chunk, _ = ds.gemv_split_plan(K, N, SMS)
    assert splits > 1
    acc = _split_product(torch.from_numpy(x), torch.from_numpy(wk).float(),
                         splits, chunk)
    out = _finish(acc, kind, params, b)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


def _warp_sums(v):
    """Row sums of v [rows, n] as a warp of the prologue takes them: lane l
    over the columns l, l + 32, ... in order, then the xor butterfly of its
    shuffles, all in fp32."""
    rows, n = v.shape
    lanes = torch.zeros(rows, 32)
    for c in range(0, n, 32):
        part = v[:, c:c + 32]
        lanes[:, :part.shape[1]] = lanes[:, :part.shape[1]] + part
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    return lanes[:, 0]


def _ln_prologue(x, g, b, splits, chunk, eps=ds.LN_EPS):
    """The prologue's normalised rows u (fp32 values of bf16) of x [B, K]
    (bf16 values): each split's row sums s_z and, about its own mean m_z =
    s_z / n_z, its centred sums of squares q_z; in rank order the mean m =
    sum s_z / K and the centred sum of squares sum [q_z + n_z (m_z - m)^2];
    rstd = rsqrt(var + eps), then bf16(((x - m) rstd) g + b), each
    operation rounded in fp32."""
    K = x.shape[1]
    one = torch.tensor(1.0)
    parts = []
    for z in range(splits):
        xs = x[:, z * chunk:min((z + 1) * chunk, K)]
        s = _warp_sums(xs)
        d = xs - (s / (one * xs.shape[1]))[:, None]
        parts.append((s, _warp_sums(d * d), one * xs.shape[1]))
    t = torch.zeros(x.shape[0])
    for s, _, _ in parts:
        t = t + s
    mean = t / (one * K)
    m2 = torch.zeros(x.shape[0])
    for s, q, n in parts:
        d = s / n - mean
        m2 = m2 + (q + n * (d * d))
    rstd = torch.rsqrt(m2 / (one * K) + eps)
    return (((x - mean[:, None]) * rstd[:, None]) * g + b).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("B,K,N,splits", [
    (4, 2048, 1536, None),   # the 1b top's c_attn, its plan (8 splits)
    (3, 1000, 136, None),    # K % 16 == 8: the last split ragged
    (2, 1002, 40, None),     # K % 4 == 2: x copied element by element
    (2, 12288, 64, 1),       # K 12288 in one split
    (5, 12288, 64, 8),
], ids=str)
def test_ln_prologue_stats_match_jax(B, K, N, splits, kind):
    rs = np.random.RandomState(K + N + B)
    params, wk, b = _dense_operands(kind, K, N, rs)
    x = _bf16((2.0 * rs.randn(B, K) + 0.5).astype(np.float32))
    g = (1.0 + 0.1 * rs.randn(K)).astype(np.float32)
    gb = (0.1 * rs.randn(K)).astype(np.float32)
    if splits is None:
        splits, chunk, _ = ds.gemv_split_plan(K, N, SMS)
    else:
        chunk = -(-K // splits // ds.GEMV_STEP) * ds.GEMV_STEP
    assert (splits - 1) * chunk < K <= splits * chunk
    u = _ln_prologue(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(gb), splits, chunk)
    # the rows against the JAX LayerNorm's bf16 output
    ln_ref = jcore.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(gb)},
                              jnp.asarray(x, jnp.bfloat16), ds.LN_EPS)
    ln_ref = np.asarray(ln_ref.astype(jnp.float32))
    same = (u.numpy() == ln_ref).mean()
    assert same >= 0.999, same
    assert np.abs(u.numpy() - ln_ref).max() <= 2.0 ** -6 * np.abs(ln_ref).max()
    # and the product of those rows in the split order against dense
    acc = _split_product(u, torch.from_numpy(wk).float(), splits, chunk)
    out = _finish(acc, kind, params, b)
    np.testing.assert_allclose(out.numpy(), _jax_dense(params, u.numpy()),
                               rtol=2e-6, atol=2e-6)
    # the port's plain prologue rounds the same rows
    plain = ds.ln_rows_plain(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(g), torch.from_numpy(gb))
    assert (plain.float() == u).float().mean() >= 0.999


MAX_DYN_SMEM = 200 * 1024      # csrc/decode_stack.cu kMaxDynSmem
SM_SMEM = 228 * 1024           # an H100 SM's shared memory
GEMV_STATIC_SMEM = 8448 + 2048 + 128 + 1024  # recv, statistics, reserved


@pytest.mark.parametrize("preset", PRESETS)
def test_ln_prologue_fits_shared_memory(preset):
    """The normalised rows [B][ln_pitch(chunk)] bf16 and g, b beside the
    warps' sums at every LayerNorm product (c_attn, f6's q, mlp c_fc) at batch
    1..16: within the kernel's limit, and two blocks an SM, so the plan's
    one wave holds; the pitch is 16 mod 64 elements and covers the
    chunk."""
    h = setup_hparams(preset, {})
    S = h.prior_width
    A, Sm = int(h.m_attn * S), int(h.m_mlp * S)
    for N in (3 * A, A, Sm):
        splits, chunk, _ = ds.gemv_split_plan(S, N, SMS)
        pitch = ds.ln_pitch(chunk)
        assert pitch >= chunk and pitch % 64 == 16
        for B in range(1, ds.MAX_BATCH + 1):
            smem = ds.gemv_smem(B, pitch)
            assert smem <= MAX_DYN_SMEM, (N, B)
            assert 2 * (smem + GEMV_STATIC_SMEM) <= SM_SMEM, (N, B)


def _block_sums(v):
    """Row sums of v [rows, threads, n] as the LayerNorm kernels take them:
    each thread over its n values in order, each warp by the xor butterfly
    of its shuffles, then the warps' sums in warp order, all in fp32."""
    s = torch.zeros(v.shape[:2])
    for p in range(v.shape[2]):
        s = s + v[:, :, p]
    s = s.view(s.shape[0], -1, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, :, lane ^ o]
    total = torch.zeros(s.shape[0])
    for ww in range(s.shape[1]):
        total = total + s[:, ww, 0]
    return total


def _fwd_rows(x, g, b, eps):
    """layer_norm_fwd's arithmetic on rows x [R, D] fp32 (16-byte vectors
    where D allows): mean, then the mean of the centred square, from the
    kernel's per-thread-then-warp sums."""
    D = x.shape[1]
    VEC, CV, T, _ = tln.row_layout(D, 4, D % 4 == 0)
    cols = torch.tensor([[(t + i * T) * VEC + j for i in range(CV)
                          for j in range(VEC)] for t in range(T)])
    ok = cols < D
    cols = cols.clamp(max=D - 1)
    inv_d = torch.tensor(1.0) / D

    def gathered(v):
        return torch.where(ok, v[:, cols], torch.zeros(()))
    mean = _block_sums(gathered(x)) * inv_d
    xc = x - mean[:, None]
    rstd = torch.rsqrt(_block_sums(gathered(xc * xc)) * inv_d + eps)
    return xc * rstd[:, None] * g + b, mean, rstd


@pytest.mark.parametrize("N,D", [(517, 64), (64, 1920), (5, 12288),
                                 (37, 33)], ids=str)
def test_layer_norm_fwd_rows_match_pallas(N, D):
    """layer_norm_fwd's grouping of rows over blocks (fwd_blocks: a block
    per GROUP_ROWS rows at one vector a thread, else per row; the rows of
    a block loaded together) and its sums against the Pallas
    forward in interpret mode, at the vector layouts CV 1, 2, 4 and the
    element path (a ragged D)."""
    rs = np.random.RandomState(N + D)
    x = (2.0 * rs.randn(N, D) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(D)).astype(np.float32)
    bb = (0.1 * rs.randn(D)).astype(np.float32)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(bb), 1e-5, True))
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, bb))
    VEC, CV, _, R = tln.row_layout(D, 4, D % 4 == 0)
    assert R == (tln.GROUP_ROWS if CV == 1 and VEC > 1 else 1)
    blocks = tln.fwd_blocks(N, R)
    y = torch.full((N, D), float("nan"))
    seen = np.zeros(N, int)
    for blk in range(blocks):  # each block's rows, at most R of them
        lo, hi = N * blk // blocks, N * (blk + 1) // blocks
        assert hi - lo <= R
        y[lo:hi] = _fwd_rows(xt[lo:hi], gt, bt, 1e-5)[0]
        seen[lo:hi] += 1
    assert (seen == 1).all()
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-4)
    _, mu, rstd = tln.layer_norm_fwd_plain(xt, gt, bt)
    _, mu_k, rstd_k = _fwd_rows(xt, gt, bt, 1e-5)
    np.testing.assert_allclose(mu_k.numpy(), mu.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rstd_k.numpy(), rstd.numpy(), rtol=1e-5)


@pytest.mark.parametrize("N,D,sms", [(600, 48, SMS), (517, 64, 4),
                                     (37, 33, SMS)], ids=str)
def test_layer_norm_bwd_partials_match_pallas(N, D, sms):
    rs = np.random.RandomState(N)
    x = (2.0 * rs.randn(N, D) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(D)).astype(np.float32)
    bb = (0.1 * rs.randn(D)).astype(np.float32)
    dy = rs.randn(N, D).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, g_, b_: layer_norm_pallas(x_, g_, b_, 1e-5,
                                                          True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(bb))
    _, ref_dg, ref_db = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    _, mu, rstd = tln.layer_norm_fwd_plain(xt, torch.from_numpy(g),
                                           torch.from_numpy(bb))
    xhat = (xt - mu[:, None]) * rstd[:, None]
    blocks = tln.bwd_blocks(N, sms)
    assert blocks == min(N, tln.BWD_BLOCKS_PER_SM * sms)
    part = torch.zeros(blocks, 2, D)
    seen = np.zeros(N, int)
    for blk in range(blocks):  # each block's rows, in order
        for r in range(N * blk // blocks, N * (blk + 1) // blocks):
            part[blk, 0] += dyt[r] * xhat[r]
            part[blk, 1] += dyt[r]
            seen[r] += 1
    assert (seen == 1).all()
    dg, db = part.sum(dim=0)
    np.testing.assert_allclose(dg.numpy(), ref_dg, rtol=0, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), ref_db, rtol=0, atol=1e-4)
