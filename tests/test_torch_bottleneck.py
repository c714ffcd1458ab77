"""The port's codebooks (jukebox_tpu_torch/models/bottleneck.py) against
jukebox_tpu/models/bottleneck.py on the CPU, on latents drawn from a numpy
seed, emb_width 16 and 32 codes as in the verify recipe.

The EMA update without restarts: from an initialised state in which every
code is in use (restore_state with a large num_tokens: usage all ones, so
the restart candidates, which jax.random and torch draw differently, are
not taken), the codes must be equal, and k, k_sum, k_elem and every metric
(fit, pn, entropy, used_curr, usage, dk) within rtol 1e-5. The latents are
ties-free: each row's nearest code is nearer than the second by more than
1e-6 of the largest distance, so the share of codes that may differ
between the packages' roundings of |x|^2 - 2 x.k + |k|^2 is 0 here.

What torch cannot repeat is held to what it means: the first-batch init
and the restarts take rows of the batch (exactly when the batch has at
least as many rows as codes; within noise of std 0.01 / sqrt(emb_width) of
a row, the draws distinct, when it has fewer), while the codes that stay
in use update as JAX's do. restore_state equals JAX's bit for bit; eval
leaves the state as it was; NoBottleneck passes its input through."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.models import bottleneck as jbn
from jukebox_tpu_torch.models import bottleneck as tbn

torch.set_num_threads(1)
W, K, MU = 16, 32, 0.99
RTOL = 1e-5
STATE_KEYS = ("k", "k_sum", "k_elem", "init", "threshold")


def _latents(seed, n=4, t=24, width=W):
    return np.random.RandomState(seed).standard_normal(
        (n, t, width)).astype(np.float32)


def _codebook(seed):
    return (1.5 * np.random.RandomState(seed).standard_normal(
        (K, W))).astype(np.float32)


def _pair(k=None, num_tokens=1e6, threshold=1.0):
    jb = jbn.BottleneckBlock(K, W, MU)
    tb = tbn.BottleneckBlock(K, W, MU)
    if k is None:
        return jb, jb.init_state(), tb
    js = jb.restore_state(k, num_tokens=num_tokens, threshold=threshold)
    tb.restore_state(torch.from_numpy(k), num_tokens=num_tokens,
                     threshold=threshold)
    return jb, js, tb


def _tie_free(x, k):
    flat = x.reshape(-1, W).astype(np.float64)
    d = ((flat[:, None, :] - k[None].astype(np.float64)) ** 2).sum(-1)
    d.sort(axis=-1)
    assert (d[:, 1] - d[:, 0]).min() > 1e-6 * d.max()


def _state(tb):
    return {key: getattr(tb, key).numpy() for key in STATE_KEYS}


def test_restore_state_matches_jax():
    k = _codebook(0)
    for num_tokens in (None, 4096, 1e6):
        jb, js, tb = _pair(k, num_tokens, threshold=2.0)
        for key in STATE_KEYS:
            np.testing.assert_array_equal(_state(tb)[key], np.asarray(js[key]))
    jb, js, tb = _pair()
    tb.reset_state()
    for key in STATE_KEYS:
        np.testing.assert_array_equal(_state(tb)[key], np.asarray(js[key]))


@pytest.mark.parametrize("sum_input", [False, True])
def test_update_matches_jax(sum_input):
    """Three training forwards in a row, each from the state the last left."""
    k = _codebook(1)
    jb, js, tb = _pair(k)
    for step in range(3):
        x = _latents(10 + step, width=2 * W if sum_input else W)
        flat = x[..., :W] + x[..., W:] if sum_input else x
        _tie_free(flat, np.asarray(js["k"]))
        jz, jq, jc, jm, js = jb.forward(js, jnp.asarray(x), update_k=True,
                                        rng=jax.random.key(step))
        tz, tq, tc, tm = tb(torch.from_numpy(x), update_k=True,
                            gen=torch.Generator().manual_seed(step))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(float(tc), float(jc), rtol=RTOL)
        assert set(tm) == set(jm) == {"fit", "pn", "entropy", "used_curr",
                                      "usage", "dk"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=RTOL, err_msg=key)
        assert float(tm["usage"]) == K  # no code restarted
        for key in ("k", "k_sum", "k_elem"):
            np.testing.assert_allclose(_state(tb)[key], np.asarray(js[key]),
                                       rtol=RTOL, atol=RTOL, err_msg=key)


def test_straight_through_and_commit_gradients():
    """The quantised output carries the latents' gradient unchanged (the
    straight-through estimator), and the commit loss's gradient is
    2 (x - k[code]) / numel, as jax.grad gives it."""
    k = _codebook(2)
    x = _latents(20)
    jb, js, tb = _pair(k)

    def jloss(x):
        _, xq, commit, _, _ = jb.forward(js, x, update_k=False)
        return jnp.sum(xq * 3.0) + commit
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    _, xq, commit, _ = tb(xt, update_k=False)
    (torch.sum(xq * 3.0) + commit).backward()
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=1e-5, atol=1e-7)


def test_eval_leaves_state():
    k = _codebook(3)
    jb, js, tb = _pair(k)
    before = {key: v.copy() for key, v in _state(tb).items()}
    x = torch.from_numpy(_latents(30)).requires_grad_(True)
    zs, xs_q, commits, metrics = tbn.Bottleneck.forward(
        _multi(tb), [x], update_k=False)
    assert metrics == []
    assert not xs_q[0].requires_grad  # no gradient through the codes
    for key, v in _state(tb).items():
        np.testing.assert_array_equal(v, before[key])


def _multi(tb):
    bn = tbn.Bottleneck(K, W, 1, MU)
    bn.level_blocks[0] = tb
    return bn


def test_init_from_first_batch():
    """An unseeded codebook seeds itself from the batch: every code a row of
    it (more rows than codes), then the EMA update; a second forward does
    not seed again."""
    jb, js, tb = _pair()
    tb.reset_state()
    x = _latents(40)  # 96 rows >= 32 codes
    flat = x.reshape(-1, W)
    g = torch.Generator().manual_seed(0)
    tb._init_k(torch.from_numpy(flat), g)
    rows = {r.tobytes() for r in flat}
    assert all(r.tobytes() in rows for r in tb.k.numpy())
    assert len({r.tobytes() for r in tb.k.numpy()}) == K
    np.testing.assert_array_equal(tb.k_sum.numpy(), tb.k.numpy())
    np.testing.assert_array_equal(tb.k_elem.numpy(), np.ones(K, np.float32))
    assert bool(tb.init)
    tb.reset_state()
    xt = torch.from_numpy(x)
    tb(xt, update_k=True, gen=torch.Generator().manual_seed(0))
    assert bool(tb.init)
    flat = xt.reshape(-1, W)
    want = MU * tb.k_sum + (1 - MU) * tb._segment_sum(
        flat, tb.quantise(flat)[0])[0]
    tb(xt, update_k=True, gen=torch.Generator().manual_seed(1))
    # the second forward does not seed again: k_sum moves by the EMA only
    np.testing.assert_allclose(tb.k_sum.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # and JAX seeds from its own draws: same shapes, init set
    _, _, _, _, js = jb.forward(js, jnp.asarray(x), update_k=True,
                                rng=jax.random.key(0))
    assert bool(js["init"]) and np.asarray(js["k"]).shape == (K, W)


def test_init_from_small_batch():
    """Fewer rows than codes: the batch is tiled and jittered; every code
    within 6 std of a row, and the draws distinct."""
    tb = tbn.BottleneckBlock(K, W, MU)
    flat = _latents(41, n=1, t=10).reshape(-1, W)
    tb._init_k(torch.from_numpy(flat), torch.Generator().manual_seed(0))
    std = 0.01 / np.sqrt(W)
    d = np.abs(tb.k.numpy()[:, None, :] - flat[None]).max(-1).min(-1)
    assert d.max() < 6 * std and d.min() > 0
    assert len({r.tobytes() for r in tb.k.numpy()}) == K


def test_restarts():
    """Codes whose k_elem falls under the threshold restart at rows of the
    batch; the others update as JAX's."""
    k = _codebook(5)
    # k_elem = 2 for every code, threshold 1.5: a code unused this step
    # falls to mu * 2 < 1.5 only when mu is small, so use mu = 0.5
    jb = jbn.BottleneckBlock(K, W, 0.5)
    tb = tbn.BottleneckBlock(K, W, 0.5)
    js = jb.restore_state(k, num_tokens=2 * K, threshold=1.5)
    tb.restore_state(torch.from_numpy(k), num_tokens=2 * K, threshold=1.5)
    x = _latents(50, n=2, t=48)  # 96 rows
    _tie_free(x, k)
    _, _, _, jm, js = jb.forward(js, jnp.asarray(x), update_k=True,
                                 rng=jax.random.key(0))
    _, _, _, tm = tb(torch.from_numpy(x), update_k=True,
                     gen=torch.Generator().manual_seed(0))
    live = np.asarray(js["k_elem"]) >= 1.5
    assert 0 < live.sum() < K  # some codes restart
    assert float(tm["usage"]) == float(jm["usage"]) == live.sum()
    np.testing.assert_allclose(tb.k.numpy()[live], np.asarray(js["k"])[live],
                               rtol=RTOL, atol=RTOL)
    rows = {r.tobytes() for r in x.reshape(-1, W)}
    assert all(r.tobytes() in rows for r in tb.k.numpy()[~live])
    for key in ("k_sum", "k_elem"):
        np.testing.assert_allclose(_state(tb)[key], np.asarray(js[key]),
                                   rtol=RTOL, atol=RTOL)
    for key in ("entropy", "used_curr", "fit", "pn"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL)


def test_chunked_products_equal_whole(monkeypatch):
    """The distance and one-hot products in row chunks give what one
    product gives (codes and counts equal, sums within fp32 rounding), the
    counts those of a bincount."""
    tb = tbn.BottleneckBlock(K, W, MU)
    tb.restore_state(torch.from_numpy(_codebook(6)), num_tokens=1e6)
    x = torch.from_numpy(_latents(60).reshape(-1, W))
    codes, fit = tb.quantise(x)
    sums, counts = tb._segment_sum(x, codes)
    monkeypatch.setattr(tbn, "CHUNK_ELEMS", 7 * K)  # 7 rows a chunk
    codes7, fit7 = tb.quantise(x)
    assert torch.equal(codes, codes7)
    np.testing.assert_allclose(float(fit7), float(fit), rtol=1e-6)
    sums7, counts7 = tb._segment_sum(x, codes)
    np.testing.assert_allclose(sums7.numpy(), sums.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(counts7, counts)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(codes.numpy(), minlength=K))
    ref = np.zeros((K, W), np.float32)
    np.add.at(ref, codes.numpy(), x.numpy())
    np.testing.assert_allclose(sums.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("update_k", [False, True])
def test_no_bottleneck(update_k):
    jb = jbn.NoBottleneck(2)
    tb = tbn.NoBottleneck(2)
    xs = [_latents(70), _latents(71, t=12)]
    jz, jq, jc, jm, _ = jb.forward(jb.init_state(),
                                   [jnp.asarray(x) for x in xs],
                                   update_k=update_k, rng=jax.random.key(0))
    tz, tq, tc, tm = tb([torch.from_numpy(x) for x in xs], update_k=update_k)
    for a, b, x in zip(tz, tq, xs):
        np.testing.assert_array_equal(a.numpy(), x)
        np.testing.assert_array_equal(b.numpy(), x)
    assert [float(c) for c in tc] == [float(c) for c in jc] == [0.0, 0.0]
    assert len(tm) == len(jm) == (2 if update_k else 0)
    for a, b in zip(tm, jm):
        assert set(a) == set(b) and all(float(v) == 0.0 for v in a.values())
