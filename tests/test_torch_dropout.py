"""The draws of a placed train step, in one process on the CPU: a
data-parallel rank holding some rows of the global batch (ops/core.py
dropout_rows: the loader's every n-th row, or a contiguous slice), and a
Megatron rank holding some of the heads, draw exactly their rows of one
process's dropout masks and aug_blend mixes:

* dropout of activations [B, L, W] and of attention weights [B, H, Lq,
  Lkv] (whole heads, and a rank's heads) equals the global draw's slice,
  bit for bit;
* the flash attention's dropout (plain versions, the kernels' hash) on a
  rank's rows and heads equals the slice of the global batch's output, on
  one batch row and on several (one launch a row);
* audio_preprocess's aug_blend mix of a rank's rows equals the slice of
  the global batch's;
* the mask is the flash kernels' hash of (seed, row, position): keep_mask
  on tensor rows equals it on int rows, and the kept share is 1 - rate.
"""

import numpy as np
import pytest
import torch

from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.ops.core import dropout, dropout_rows, keep_mask
from jukebox_tpu_torch.ops.flash_attention import flash_dense_attn
from jukebox_tpu_torch.utils.audio_utils import audio_preprocess

torch.set_num_threads(1)
RATE, SEED = 0.1, 12345


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


# the rows of a batch of 4 that rank i of 2 holds: the loader's, a slice
PARTS = {"strided": [[0, 2], [1, 3]], "slice": [[0, 1], [2, 3]]}


@pytest.mark.parametrize("parts", sorted(PARTS))
@pytest.mark.parametrize("shape", [(4, 6, 10), (4, 3, 6, 6), (4, 40)])
def test_dropout_rows_of_global(shape, parts):
    x = _x(*shape)
    whole = dropout(x, RATE, SEED)
    assert (whole == 0).any() and not torch.equal(whole, x)
    for rows in PARTS[parts]:
        with dropout_rows(rows):
            part = dropout(x[rows], RATE, SEED)
        assert torch.equal(part, whole[rows]), rows


def test_dropout_heads_rows_of_global():
    """Attention weights [B, H, Lq, Lkv] at dp=2 x mp=2, and their batch
    folded with blocks ([B * 2, ...], the f1 layout): rank (i, j) holds the
    loader's rows of i and heads 2j, 2j + 1 of four."""
    w = _x(8, 4, 5, 5)
    whole = dropout(w, RATE, SEED)
    for rows in PARTS["strided"]:
        lead = [2 * r + j for r in rows for j in range(2)]
        for j in range(2):
            hs = slice(2 * j, 2 * j + 2)
            with dropout_rows(rows):
                part = dropout(w[lead, hs], RATE, SEED, heads=(2 * j, 4))
            assert torch.equal(part, whole[lead, hs])


@pytest.mark.parametrize("parts", sorted(PARTS))
@pytest.mark.parametrize("rows", [1, 2])
def test_flash_dropout_rows_of_global(rows, parts):
    """Each rank holding `rows` rows of 2 * rows (the loader's every other
    row, or a slice), with all heads and with two of four: the rank's
    output columns equal the global output's."""
    B, L, H, hd = 2 * rows, 12, 4, 4
    q, k, v = (_x(B, L, H * hd, seed=s) for s in range(3))
    whole = flash_dense_attn(q, k, v, H, RATE, SEED, plain=True)
    ref = flash_dense_attn(q, k, v, H, 0.0, None, plain=True)
    assert not torch.allclose(whole, ref)
    for i in range(2):
        rs = (list(range(i, B, 2)) if parts == "strided"
              else list(range(i * rows, (i + 1) * rows)))
        with dropout_rows(rs):
            np.testing.assert_array_equal(
                flash_dense_attn(q[rs], k[rs], v[rs], H, RATE, SEED,
                                 plain=True).numpy(), whole[rs].numpy())
            for j in range(2):
                cs = slice(2 * j * hd, (2 * j + 2) * hd)
                part = flash_dense_attn(q[rs, :, cs], k[rs, :, cs],
                                        v[rs, :, cs], 2, RATE, SEED,
                                        plain=True, heads=(2 * j, H))
                np.testing.assert_array_equal(part.numpy(),
                                              whole[rs, :, cs].numpy())


def test_aug_blend_mix_rows_of_global():
    hps = Hyperparams(aug_blend=True)
    x = _x(4, 32, 2)
    gen = torch.Generator().manual_seed(3)
    whole = audio_preprocess(x, hps, gen=gen)
    assert not torch.allclose(whole, audio_preprocess(x, hps))
    for rows in PARTS["strided"]:
        gen = torch.Generator().manual_seed(3)
        part = audio_preprocess(x[rows], hps, gen=gen, rows=rows, total=4)
        assert torch.equal(part, whole[rows])


def test_keep_mask_rows_and_rate():
    q = torch.arange(64)[:, None]
    kv = torch.arange(64)[None, :]
    rows = torch.arange(3)[:, None, None]
    m = keep_mask(SEED, rows, q, kv, RATE)
    for r in range(3):
        assert torch.equal(m[r], keep_mask(SEED, r, q, kv, RATE))
    assert abs(float(m.float().mean()) - (1 - RATE)) < 0.01
