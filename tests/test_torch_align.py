"""The port's attention recording and lyric alignment against jukebox_tpu
on the CPU, on the same weights (the tiny family of tests/_torch_tiny.py,
from_jax_params), in fp32:

1. PriorRuntime.z_forward(get_attn_weights={layer}, attn_head=h): the
   recorded head cast to fp16 by both packages, to 1e-3 (one fp16 step of
   a weight near 1 is 4.9e-4);
2. the full recorded maps [N, H, Lq, Lkv] without a head at every pattern
   the cascades use: f0-f3 (an order-9 upsampler [1, 2, 3, 0]), f7 (the
   order-12 lyric top, its lyric keys cut as factored_attention.py:101-105
   cuts them) and f6 (a narrow separate encoder-decoder top of order 6,
   the lyric encoder's activations as keys), to 1e-5 (fp32, summation
   order only);
3. get_alignment on the top's codes, longer than n_ctx (three hops at
   hop_fraction 0.5, each with its own lyric window) and shorter (padded
   to n_ctx), to 1e-3 (the fp16 heads of 1).
"""

import numpy as np
import pytest
import torch

from _torch_tiny import TAPS, TOP, UP, VQ, priors, vqvaes
from jukebox_tpu import align as jalign
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu_torch import align as talign
from jukebox_tpu_torch.hparams import Hyperparams as THyperparams

torch.set_num_threads(1)
N = 2
# f0-f3: an upsampler on attn_order 9, one layer of each pattern
UP9 = dict(UP, level=1, attn_order=9, prior_depth=4)
# f6: a separate encoder-decoder top on attn_order 6 ([1, 2, 3, 6]) whose
# 2-layer lyric encoder reads 8 lyric tokens
TOP6 = dict(level=2, n_ctx=48, prior_width=32, prior_depth=4, heads=2,
            attn_order=6, blocks=4, init_scale=0.7, labels=True,
            y_bins=(120, 4111), t_bins=16, max_bow_genre_size=5, n_vocab=80,
            min_duration=0.0, max_duration=600.0, use_tokens=True,
            n_tokens=8, prime_width=32, prime_depth=2, prime_heads=2,
            prime_attn_order=2, prime_blocks=4, prime_init_scale=0.7,
            prime_loss_fraction=0.4, sr=8000)
# lyrics long enough, and a total length short enough, that the hops of a
# 96-code top see different lyric windows
META = dict(artist="unknown", genre="unknown",
            lyrics="oh la la, la la la, the sea is calm tonight",
            total_length=96 * 16, offset=0)


@pytest.fixture(scope="module")
def models():
    jvq, tvq = vqvaes()
    jps, tps = priors([UP9, dict(TOP, **TAPS), TOP6], jvq, tvq)
    return dict(zip(("up9", "top", "top6"), zip(jps, tps)))


def inputs(jp, seed=0):
    """(z, z_conds, y) of one window at start 0."""
    rng = np.random.RandomState(seed)
    z = rng.randint(0, VQ["l_bins"], (N, jp.n_ctx))
    z_conds = []
    if jp.level < 2:
        up = rng.randint(0, VQ["l_bins"], (N, jp.n_ctx // jp.cond_downsample))
        z_conds = [up]
    y = jp.get_y(jp.labeller.get_batch_labels([META] * N), 0)
    return z, z_conds, y


def record(pair, layer, head=None):
    jp, tp = pair
    z, z_conds, y = inputs(jp)
    jw = jp.z_forward(z, z_conds, y, get_attn_weights={layer},
                      attn_head=head)
    tw = tp.z_forward(z, z_conds, y, get_attn_weights={layer},
                      attn_head=head)
    assert len(jw) == len(tw) == 1
    return np.asarray(jw[0]), tw[0]


@pytest.mark.parametrize("head", [0, 1])
def test_recorded_head_matches_jax(models, head):
    jw, tw = record(models["top"], TAPS["alignment_layer"], head)
    assert tw.dtype == torch.float16 and jw.dtype == np.float16
    # music queries x lyric keys of the prime
    assert tw.shape == (N, TOP["n_ctx"], TOP["n_tokens"])
    np.testing.assert_allclose(tw.float().numpy(), jw.astype(np.float32),
                               atol=1e-3)


@pytest.mark.parametrize("name,layer,func,shape", [
    ("up9", 0, 1, (N * 4, 1, 8, 8)),       # blocks of 8 positions
    ("up9", 1, 2, (N * 8, 1, 4, 4)),       # columns over 4 blocks
    ("up9", 2, 3, (N * 4, 1, 8, 8)),       # the previous block
    ("up9", 3, 0, (N, 1, 32, 32)),         # dense, causal
    ("top", 15, 7, (N, 2, 48, 8)),         # music x lyric keys
    ("top6", 3, 6, (N, 2, 48, 8)),         # the lyric encoder's keys
])
def test_recorded_maps_match_jax(models, name, layer, func, shape):
    tr = models[name][1].model.prior.transformer
    assert tr.attn_func(layer) == func
    jw, tw = record(models[name], layer)
    assert tw.dtype == torch.float32 and tuple(tw.shape) == shape
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-5)


@pytest.mark.parametrize("length,hops", [(96, 3), (32, 1)])
def test_get_alignment_matches_jax(models, length, hops):
    jp, tp = models["top"]
    labels = jp.labeller.get_batch_labels([META] * N)
    z = np.random.RandomState(length).randint(0, VQ["l_bins"], (N, length))
    zs = [None, None, z]
    kw = dict(levels=3, hop_fraction=(0.5, 0.5, 0.5))
    starts = [0, 24, 48][:hops]
    windows = {tuple(map(tuple, tp.get_y(labels, s, get_indices=True)[1]))
               for s in starts}
    assert len(windows) == hops  # every hop stitches its own lyric window
    want = jalign.get_alignment(None, zs, labels, jp, False,
                                JHyperparams(**kw))
    got = talign.get_alignment(None, zs, labels, tp, False,
                               THyperparams(**kw))
    n_chars = len(labels["info"][0]["full_tokens"])
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g.shape == w.shape == (length, n_chars)
        np.testing.assert_allclose(g, w, atol=1e-3)
        assert (g >= 0).all()
        if hops == 1:  # overlapping hops stitch two windows into a row
            assert (g.sum(axis=1) <= 1 + 1e-3).all()
