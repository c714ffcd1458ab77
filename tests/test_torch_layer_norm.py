"""The port's LayerNorm (jukebox_tpu_torch/ops/layer_norm.py: the plain
versions of the forward and backward kernels, and the autograd function
that the models call) against jukebox_tpu's Pallas LayerNorm
(ops/pallas/layer_norm.py layer_norm_pallas, run in interpret mode as the
JAX package's own tests run it on the CPU), on the same numpy inputs.

fp32: the output within 1e-5 and the gradients (dx, dg, db of jax.vjp)
within 1e-4, absolute at unit-scale inputs: the two sum the row statistics
and the row-block partials in another order. bf16 inputs: the outputs, and
dx, within one bf16 step of the reference (both round an fp32 value that
differs in the last fp32 bits); dg and db are fp32 sums, 1e-4. The odd
shapes cross the Pallas kernel's row blocking (256 rows, halved until they
divide N)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops.pallas.layer_norm import layer_norm_pallas
from jukebox_tpu_torch.models.transformer import ResAttnBlock
from jukebox_tpu_torch.ops import core
from jukebox_tpu_torch.ops import layer_norm as tln

torch.set_num_threads(1)
SHAPES = [(37, 48), (512, 64), (6, 33)]


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = (2.0 * rs.randn(*shape) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, g, b, dy


def _jax_ref(x, g, b, dy, dtype):
    def f(x_, g_, b_):
        return layer_norm_pallas(x_, g_, b_, 1e-5, True)
    out, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(g),
                       jnp.asarray(b))
    dx, dg, db = vjp(jnp.asarray(dy, dtype))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, dx, dg,
                                                              db)]


def _bf16_step(ref):
    """One bf16 step at each |ref| (2^(e - 8) for |ref| = f 2^e, f in
    [0.5, 1))."""
    e = np.frexp(np.abs(ref))[1]
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fp32_matches_pallas(shape):
    x, g, b, dy = _inputs(shape, 0)
    ref = _jax_ref(x, g, b, dy, jnp.float32)
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = tln.layer_norm(xt, gt, bt)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), ref[0], rtol=0, atol=1e-5)
    for out, r in zip((xt.grad, gt.grad, bt.grad), ref[1:]):
        np.testing.assert_allclose(out.numpy(), r, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_matches_pallas(shape):
    x, g, b, dy = _inputs(shape, 1)
    ref = _jax_ref(x, g, b, dy, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y, mu, rstd = tln.layer_norm_fwd_plain(xt, torch.from_numpy(g),
                                           torch.from_numpy(b))
    dx, dg, db = tln.layer_norm_bwd_plain(
        xt, torch.from_numpy(g), mu, rstd,
        torch.from_numpy(dy).to(torch.bfloat16))
    assert y.dtype == dx.dtype == torch.bfloat16
    for out, r in ((y, ref[0]), (dx, ref[1])):
        err = np.abs(out.float().numpy() - r)
        assert (err <= _bf16_step(r)).all()
    for out, r in ((dg, ref[2]), (db, ref[3])):
        np.testing.assert_allclose(out.numpy(), r, rtol=0, atol=1e-4)


def test_plain_versions_are_the_wrappers_on_the_cpu():
    x, g, b, dy = (torch.from_numpy(a) for a in _inputs((20, 16), 2))
    fwd, ref = tln.layer_norm_fwd(x, g, b), tln.layer_norm_fwd_plain(x, g, b)
    assert all(torch.equal(a, r) for a, r in zip(fwd, ref))
    bwd = tln.layer_norm_bwd(x, g, fwd[1], fwd[2], dy)
    ref = tln.layer_norm_bwd_plain(x, g, fwd[1], fwd[2], dy)
    assert all(torch.equal(a, r) for a, r in zip(bwd, ref))
    assert tln.LAUNCHES == dict.fromkeys(tln.LAUNCHES, 0)  # CPU: no kernel


def test_module_and_block_thread_plain(monkeypatch):
    """core.LayerNorm runs the LayerNorm function over [B, T, W] (saving
    x, g, mu, rstd), and a transformer block's plain flag reaches both of
    its LayerNorms."""
    calls = []
    for name in ("layer_norm_fwd_plain", "layer_norm_fwd"):
        fn = getattr(tln, name)
        monkeypatch.setattr(tln, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    mod = core.LayerNorm(16, device="cpu")
    mod.init_(None)
    x = torch.randn(2, 5, 16, requires_grad=True)
    y = mod(x)
    # the wrapper, which takes its plain version for CPU tensors
    assert y.shape == x.shape
    assert calls == ["layer_norm_fwd", "layer_norm_fwd_plain"]
    y.sum().backward()
    assert x.grad.shape == x.shape
    blk = ResAttnBlock(16, 8, 2, 1, blocks=2, device="cpu")
    for m in blk.modules():
        if hasattr(m, "init_"):
            m.init_(torch.Generator().manual_seed(0))
    calls.clear()
    blk(torch.randn(1, 8, 16), plain=True)
    assert calls == ["layer_norm_fwd_plain"] * 2
