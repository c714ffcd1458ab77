"""Factored attention of the PyTorch port against jukebox_tpu's on the CPU,
fp32, on the same numpy inputs and converted params: the full forward,
token-by-token decode over four blocks, chunked prefill followed by
decode, and the ring-cache kernel's plain version (the decode path of the
bf16 stack) driven by ring_geometry. Tolerance 1e-5: fp32 on both sides,
differing only in summation order.

One case per ring-cache trap: f3 in the first block attends the zero ring
unmasked (scores 0, output exactly the c_proj bias); f7 stops writing at
_prime_len and keeps attending the prime; masks fill NEG = -1e9, not -inf
(a fully masked row is uniform, not NaN); f2 reads column t % bc up to block
t // bc and f1 its row up to t % bc (covered by every decode position)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.models.attention import FactoredAttention as JAttn
from jukebox_tpu.models.attention import dense_attn as j_dense_attn
from jukebox_tpu_torch.models.attention import FactoredAttention, dense_attn
from jukebox_tpu_torch.ops.decode_stack import (ring_attn_decode_plain,
                                                ring_geometry)
from jukebox_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
N_IN, A, H, N_CTX, BLOCKS, PRIME, B = 16, 8, 2, 24, 4, 5, 2
BC = N_CTX // BLOCKS


def make(f, seed=0):
    kw = dict(n_in=N_IN, n_ctx=N_CTX, n_state=A, n_head=H, attn_func=f,
              blocks=BLOCKS, prime_len=PRIME, mask=True)
    ja = JAttn(**kw)
    params = ja.init(jax.random.key(seed))
    # non-zero biases so the traps are visible through c_proj
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(seed + 7),
                                              p.shape), params)
    ta = FactoredAttention(**kw, device="cpu")
    from_jax_params(ta, jax.tree_util.tree_map(np.asarray, params))
    return ja, params, ta


def x_seq(T, seed=1):
    return np.random.RandomState(seed).randn(B, T, N_IN).astype(np.float32)


@pytest.mark.parametrize("f", [0, 1, 2, 3, 7])
def test_full_forward(f):
    ja, params, ta = make(f)
    x = x_seq(N_CTX)
    ref, _ = ja.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(ta(torch.from_numpy(x)).detach().numpy(), ref,
                               **TOL)


def _jax_decoder(ja):
    return jax.jit(lambda p, c, x, t: ja.decode_step(p, c, x, t))


@pytest.mark.parametrize("f", [0, 1, 2, 3, 7])
def test_decode_four_blocks(f):
    """JAX decode_step, the port's decode_step and the port's ring-kernel
    plain version (c_attn -> ring_attn_decode_plain -> c_proj) in lockstep
    over every position of four blocks."""
    ja, params, ta = make(f)
    step = _jax_decoder(ja)
    jc = ja.init_cache(params, B, jnp.float32)
    tc = ta.init_cache(B, torch.float32, "cpu")
    kc = ta.init_cache(B, torch.float32, "cpu")
    xs = x_seq(N_CTX)
    with torch.no_grad():
        for t in range(N_CTX):
            x = xs[:, t:t + 1]
            ref, jc = step(params, jc, jnp.asarray(x), jnp.int32(t))
            out = ta.decode_step(tc, torch.from_numpy(x), t)
            np.testing.assert_allclose(out.numpy(), ref, err_msg=f"t={t}",
                                       **TOL)
            geom = ring_geometry(f, t, kc["k"].shape, BC, ta._prime_len)
            qkv = ta.c_attn(torch.from_numpy(x[:, 0]))
            o = ring_attn_decode_plain(qkv, kc["k"], kc["v"], geom, H, qkv)
            np.testing.assert_allclose(ta.c_proj(o).numpy(), ref[:, 0],
                                       err_msg=f"ring t={t}", **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), jc[key], **TOL)
        np.testing.assert_allclose(kc[key].numpy(), jc[key], **TOL)


def test_f3_first_block_attends_zero_ring():
    _, _, ta = make(3)
    cache = ta.init_cache(B, torch.float32, "cpu")
    xs = torch.from_numpy(x_seq(BC))
    with torch.no_grad():
        for t in range(BC):
            out = ta.decode_step(cache, xs[:, t:t + 1], t)
            # uniform weights over zero values: a == 0, out == c_proj bias
            torch.testing.assert_close(out[:, 0], ta.c_proj.b.expand(B, -1),
                                       rtol=0, atol=0)
            geom = ring_geometry(3, t, cache["k"].shape, BC)
            assert geom[2:] == (BC, BC)  # reads ring 1, all bc rows
    assert cache["k"][:, :BC].abs().sum() > 0   # ring 0 filled
    assert cache["k"][:, BC:].abs().sum() == 0  # ring 1 still zero


def test_f7_stops_writing_after_prime():
    _, _, ta = make(7)
    pl_ = ta._prime_len
    assert PRIME < pl_ < N_CTX
    cache = ta.init_cache(B, torch.float32, "cpu")
    xs = torch.from_numpy(x_seq(N_CTX))
    with torch.no_grad():
        for t in range(pl_):
            ta.decode_step(cache, xs[:, t:t + 1], t)
        frozen = {k: c.clone() for k, c in cache.items()}
        outs = [ta.decode_step(cache, xs[:, t:t + 1], t)
                for t in range(pl_, pl_ + 3)]
    for k in ("k", "v"):
        torch.testing.assert_close(cache[k], frozen[k], rtol=0, atol=0)
    assert ring_geometry(7, pl_, cache["k"].shape, BC, pl_) == \
        (pl_, -1, 0, pl_)
    assert ring_geometry(7, pl_ - 1, cache["k"].shape, BC, pl_) == \
        (pl_, pl_ - 1, 0, pl_)
    # after the prime the output no longer depends on the token's own k, v
    assert not torch.allclose(outs[0], outs[1])


def test_mask_fills_neg_not_inf():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, 5, A).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((5, 5), np.float32))
    mask[2] = 0.0  # a fully masked row: uniform weights under NEG fill
    ref = j_dense_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                       jnp.asarray(mask))[0]
    out = dense_attn(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), H, torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out[:, 2].numpy(), v.mean(axis=1), **TOL)


@pytest.mark.parametrize("f", [0, 1, 2, 3, 7])
def test_prefill_then_decode(f):
    """Two block-aligned chunks (2 blocks at t0=0, 1 block at t0=2bc) then
    token decode to the end of the context."""
    ja, params, ta = make(f)
    jstep = _jax_decoder(ja)
    jpre = jax.jit(lambda p, c, x, t0, nb: ja.prefill_chunk(p, c, x, t0, nb),
                   static_argnums=(4,))
    jc = ja.init_cache(params, B, jnp.float32)
    tc = ta.init_cache(B, torch.float32, "cpu")
    xs = x_seq(N_CTX, seed=5)
    with torch.no_grad():
        for t0, nb in ((0, 2), (2 * BC, 1)):
            x = xs[:, t0:t0 + nb * BC]
            ref, jc = jpre(params, jc, jnp.asarray(x), jnp.int32(t0), nb)
            out = ta.prefill_chunk(tc, torch.from_numpy(x), t0, nb)
            np.testing.assert_allclose(out.numpy(), ref, err_msg=f"t0={t0}",
                                       **TOL)
        for t in range(3 * BC, N_CTX):
            x = xs[:, t:t + 1]
            ref, jc = jstep(params, jc, jnp.asarray(x), jnp.int32(t))
            out = ta.decode_step(tc, torch.from_numpy(x), t)
            np.testing.assert_allclose(out.numpy(), ref, err_msg=f"t={t}",
                                       **TOL)
