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


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("B,K,N", [(3, 64, 40), (5, 72, 24), (16, 200, 136),
                                   (4, 4800, 1208)], ids=str)
def test_split_sum_matches_jax_dense(B, K, N, kind):
    rs = np.random.RandomState(K + N)
    w = (0.02 * rs.randn(K, N)).astype(np.float32)
    b = (0.1 * rs.randn(N)).astype(np.float32)
    x = rs.randn(B, K).astype(np.float32)
    if kind == "int8":
        params = jcore.quantize_dense({"w": w, "b": b})
        wk = np.asarray(params["w_q"])
    else:  # the kernel's bf16 operands, as fp32 on both sides
        w, b, x = _bf16(w), _bf16(b), _bf16(x)
        params = {"w": w, "b": b}
        wk = w
    ref = np.asarray(jcore.dense(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(x)))
    splits, chunk, _ = ds.gemv_split_plan(K, N, SMS)
    assert splits > 1
    wt = torch.from_numpy(wk).float()
    xt = torch.from_numpy(x)
    acc = torch.zeros(B, N)
    for z in range(splits):  # the owners' rank order
        lo, hi = z * chunk, min((z + 1) * chunk, K)
        # warp w of the split's block takes its 16-row steps w, w + 8, ...
        # in order; the block sums its warps in order
        warps = [torch.zeros(B, N) for _ in range(GEMV_WARPS)]
        for i, k in enumerate(range(lo, hi, ds.GEMV_STEP)):
            k_end = min(k + ds.GEMV_STEP, hi)
            warps[i % GEMV_WARPS] = (warps[i % GEMV_WARPS]
                                     + xt[:, k:k_end] @ wt[k:k_end])
        block = warps[0]
        for part in warps[1:]:
            block = block + part
        acc = acc + block
    if kind == "int8":
        acc = acc * torch.from_numpy(np.asarray(params["s"]))
    out = acc + torch.from_numpy(b)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


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
