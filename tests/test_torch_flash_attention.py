"""The port's flash attention (jukebox_tpu_torch/ops/flash_attention.py) on
the CPU, where its wrappers run the plain versions, against the Pallas
kernels of jukebox_tpu/ops/pallas/flash_attention.py in interpret mode on
the same numpy inputs:

* the forward at the JAX kernel test's shapes (L not a multiple of the
  block, head widths 64, 128, 96 and 48): fp32 2e-5 (summation order only),
  bf16 2e-2 (both round the output to bf16 from fp32 sums taken in another
  order), the JAX test's tolerances;
* the gradients of sum(sin(out)) through the autograd Function's plain
  backward against jax.grad of the interpret kernel: 2e-4, the JAX test's;
* keep_mask equal, bit for bit, to _keep_mask;
* forward and gradients at dropout rate 0.1 with one seed: the same
  tolerances, since both sides drop the same weights;
* the f0 dispatch of FactoredAttention: flash exactly for a masked f0 layer
  of at least 2048 positions in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops.pallas import flash_attention as jfa
from jukebox_tpu_torch.models import attention as tattn
from jukebox_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, B, L, S, dtype):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, L, S).astype(np.float32) for _ in range(3)]
    tdt, jdt = _DT[dtype]
    return ([torch.tensor(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _jax_flash(q, k, v, H, rate=0.0, seed=None):
    return jfa.flash_dense_attn(q, k, v, H, bq=128, bk=128, interpret=True,
                                dropout_rate=rate, dropout_seed=seed)


@pytest.mark.parametrize("B,L,S,H,dtype", [
    (2, 256, 128, 2, "float32"),
    (1, 384, 256, 2, "float32"),   # L not a block multiple
    (2, 256, 96, 1, "bfloat16"),
    (1, 200, 96, 2, "bfloat16"),   # head width 48, ragged L
])
def test_forward_matches_jax(B, L, S, H, dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(0, B, L, S, dtype)
    ref = np.asarray(_jax_flash(jq, jk, jv, H), np.float32)
    out = tfa.flash_dense_attn(tq, tk, tv, H)
    assert out.dtype == tq.dtype and out.shape == (B, L, S)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_grads_match_jax(rate):
    B, L, S, H, seed = 1, 384, 128, 2, 77
    (tq, tk, tv), (jq, jk, jv) = _inputs(3, B, L, S, "float32")
    dseed = seed if rate else None

    def jax_loss(q, k, v):
        return jnp.sum(jnp.sin(_jax_flash(q, k, v, H, rate, dseed)))

    jout = _jax_flash(jq, jk, jv, H, rate, dseed)
    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_dense_attn(*ts, H, rate, dseed)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5)
    torch.sin(out).sum().backward()
    for t, r, name in zip(ts, ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("seed,bh,qi,j,bq,bk,rate", [
    (0, 0, 0, 0, 128, 128, 0.1),
    (12345, 3, 2, 1, 128, 64, 0.3),
    (2 ** 31 - 1, 7, 5, 9, 64, 256, 0.5),
    (987654321, 1, 40, 39, 256, 512, 0.05),
])
def test_keep_mask_equals_jax(seed, bh, qi, j, bq, bk, rate):
    ref = np.asarray(jfa._keep_mask(jnp.asarray(seed, jnp.int32), bh, qi, j,
                                    bq, bk, rate))
    q_pos = qi * bq + torch.arange(bq)[:, None]
    kv_pos = j * bk + torch.arange(bk)[None, :]
    out = tfa.keep_mask(seed, bh, q_pos, kv_pos, rate).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < out.mean() < 1


def test_plain_versions_are_the_function():
    """The plain forward is a dense masked softmax in fp32, and lse its
    logsumexp, at a ragged L (2e-6: fp32 summation order)."""
    (q, k, v), _ = _inputs(5, 1, 70, 32, "float32")
    qh, kh, vh = (x.reshape(1, 70, 2, 16).transpose(1, 2).reshape(2, 70, 16)
                  for x in (q, k, v))
    scale = 16 ** -0.5
    out, lse = tfa.flash_fwd(qh, kh, vh, scale)
    s = (qh @ kh.transpose(1, 2)) * scale
    s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), -1e9)
    np.testing.assert_allclose(out.numpy(), (s.softmax(-1) @ vh).numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), s.logsumexp(-1).numpy(),
                               atol=2e-6)


def test_agreement_passes_rounding_and_refuses_a_skipped_tile():
    """The check the kernels are held to on the card (`agreement`) passes
    the kernels' own rounding, p taken in bf16 for P.V as the forward
    kernel takes it, and refuses an output that skips one tile of 64 keys
    in the late rows (V zeroed there), as a faulty kernel would."""
    (q, k, v), _ = _inputs(6, 1, 1000, 512, "bfloat16")
    qh, kh, vh = (x.reshape(1, 1000, 2, 256).transpose(1, 2)
                  .reshape(2, 1000, 256).contiguous() for x in (q, k, v))
    scale = 256 ** -0.5
    ref, lse = tfa.flash_fwd_plain(qh, kh, vh, scale)
    qp, kp = tfa._positions(1000, "cpu")
    rounded = torch.empty_like(ref)
    for bh in range(2):
        p, _, l = tfa._probs(qh[bh], kh[bh], None, scale, qp, kp)
        rounded[bh] = ((p.to(torch.bfloat16).float() @ vh[bh].float()) / l
                       ).to(torch.bfloat16)
    assert 0.0 < tfa.agreement(rounded, ref) <= 0.5
    assert tfa.agreement(lse + 1e-6 * lse.abs(), lse) <= 0.5
    skipped = vh.clone()
    skipped[:, 704:768] = 0
    assert tfa.agreement(tfa.flash_fwd_plain(qh, kh, skipped, scale)[0],
                         ref) > 10.0
    assert tfa.agreement(lse + 1e-3, lse) > 1.0


def _attn(attn_func, blocks=None, mask=True):
    return tattn.FactoredAttention(16, 2048, 16, 2, attn_func, blocks,
                                   mask=mask, device="cpu")


@pytest.mark.parametrize("attn_func,L,dtype,mask,flash", [
    (0, 2048, torch.bfloat16, True, True),
    (0, 2048, torch.float32, True, False),
    (0, 2047, torch.bfloat16, True, False),
    (0, 2048, torch.bfloat16, False, False),
    (1, 2048, torch.bfloat16, True, False),
])
def test_flash_dispatch(monkeypatch, attn_func, L, dtype, mask, flash):
    calls = []

    def spy(q, k, v, n_head, rate, seed, plain, heads):
        calls.append((q.shape, rate, seed, plain, heads))
        return torch.zeros_like(q)
    monkeypatch.setattr(tattn, "flash_dense_attn", spy)
    m = _attn(attn_func, blocks=16 if attn_func else None, mask=mask)
    m.n_ctx = L
    assert m.uses_flash(L, dtype) == flash
    x = torch.randn(1, L, 16).to(dtype)
    out = m._pattern_full(x, x, x)
    assert out.shape == x.shape and out.dtype == dtype
    assert len(calls) == (1 if flash else 0)
    if flash:
        assert calls[0] == ((1, L, 16), 0.0, None, False, None)
