"""The host plans behind two kernels of the port, pure arithmetic and
plain PyTorch on the CPU:

- gemv_int8's split plan (ops/decode_stack.py gemv_split_plan) at every
  product shape of the three priors the cascades sample (the 5b_lyrics
  top: c_attn, the f6 layers' q-only c_attn, c_proj, mlp c_fc and c_proj;
  the 1b_lyrics top's and the upsamplers' four) and batch 1-16: the K
  splits cover every row once (the last ragged), the column tiles every
  column once, the grid fills the H100's 132 SMs and stays in one wave,
  and the workspace holds every index the kernel writes. Its arithmetic,
  each split's fp32 partial summed in the plan's order and then scaled
  and biased, against jukebox_tpu.ops.core.dense on quantize_dense
  weights (fp32 x), within fp32 rounding (2e-6, as test_torch_int8.py's
  int8 dense test).
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
        for B in range(1, ds.MAX_BATCH + 1):
            splits, chunk, floats, tiles = ds.gemv_split_plan(B, K, N, SMS)
            assert chunk % ds.GEMV_STEP == 0 and chunk >= ds.GEMV_STEP
            rows = np.zeros(K, int)
            for z in range(splits):
                rows[z * chunk:min((z + 1) * chunk, K)] += 1
            assert (rows == 1).all() and (splits - 1) * chunk < K
            cols = np.zeros(N, int)
            for t in range(tiles):
                cols[t * ds.GEMV_COLS:(t + 1) * ds.GEMV_COLS] += 1
            assert (cols == 1).all() and (tiles - 1) * ds.GEMV_COLS < N
            assert SMS <= tiles * splits <= ds.GEMV_WAVES * SMS, (K, N, B)
            # the kernel writes ws[(z * B + b) * N + n] for every split z,
            # batch row b and column n
            assert floats == ((splits - 1) * B + B - 1) * N + N


@pytest.mark.parametrize("B,K,N", [(3, 64, 40), (5, 72, 24), (16, 200, 136),
                                   (4, 4800, 1208)], ids=str)
def test_split_sum_matches_jax_dense(B, K, N):
    rs = np.random.RandomState(K + N)
    w = (0.02 * rs.randn(K, N)).astype(np.float32)
    b = (0.1 * rs.randn(N)).astype(np.float32)
    x = rs.randn(B, K).astype(np.float32)
    jq = jcore.quantize_dense({"w": w, "b": b})
    ref = np.asarray(jcore.dense(jax.tree_util.tree_map(jnp.asarray, jq),
                                 jnp.asarray(x)))
    splits, chunk, _, _ = ds.gemv_split_plan(B, K, N, SMS)
    assert splits > 1
    wq = torch.from_numpy(np.asarray(jq["w_q"])).float()
    xt = torch.from_numpy(x)
    acc = torch.zeros(B, N)
    for z in range(splits):  # the last block's fixed order
        lo, hi = z * chunk, min((z + 1) * chunk, K)
        acc = acc + xt[:, lo:hi] @ wq[lo:hi]
    out = acc * torch.from_numpy(np.asarray(jq["s"])) + torch.from_numpy(b)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


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
