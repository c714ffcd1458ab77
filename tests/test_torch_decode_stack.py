"""The decode-step kernels' plain versions (ops/decode_stack.py), composed
into the port's stack decode step, against jukebox_tpu on the CPU:

* bf16 against the whole-stack Pallas megakernel (build_stack_decode,
  interpret mode), for an order-2 [1,2,3] stack and an order-12 stack whose
  48 layers include the flat f7 prime and f0 dense layers, token by token
  across block and prime boundaries after a one-block prefill. Tolerance
  0.04 * max(1, |ref|), the bound the JAX package holds its own megakernel
  to against its XLA bf16 path: both are bf16 decode paths that round at
  different points (the port keeps q in bf16 and casts the softmax weights
  to bf16 before the PV product, as dense_attn does; the megakernel keeps
  both in fp32).
* fp32 against the JAX XLA decode path (fed fp32 the plain versions compute
  the same fp32 arithmetic): tolerance 2e-5 abs + 2e-5 rel, summation
  order only.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.models.transformer import Transformer as JTransformer
from jukebox_tpu.ops.pallas.decode_stack import (_flatten_packed,
                                                 build_stack_decode,
                                                 pack_caches,
                                                 pack_decode_params)
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)
BF_TOL = 0.04


def pair(order, S, n_ctx, blocks, depth, H, prime_len=None, seed=0):
    kw = dict(n_ctx=n_ctx, n_head=H, n_depth=depth, attn_order=order,
              blocks=blocks, m_attn=0.25, m_mlp=1.0, mask=True,
              prime_len=prime_len)
    jt = JTransformer(n_in=S, **kw)
    params = jt.init(jax.random.key(seed))
    tt = Transformer(S, device="cpu", **kw)
    from_jax_params(tt, jax.tree_util.tree_map(np.asarray, params))
    return jt, params, tt


def _rel_err(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def test_bf16_stack_matches_megakernel_order2():
    S, n_ctx, blocks, depth, B, lane = 64, 16, 4, 6, 2, 8
    bc, G = n_ctx // blocks, depth // 3
    jt, params, tt = pair(2, S, n_ctx, blocks, depth, 1)
    dec = jt.prepare_decode_params(params)
    c_std = jt.init_cache_from_segments(dec, B, jnp.bfloat16)
    packed = _flatten_packed(pack_decode_params(dec[0], lane=lane))
    mk = jax.jit(build_stack_decode(S, S // 4, S, bc, blocks, G, B,
                                    lane=lane, interpret=True))
    c6 = pack_caches(c_std[0], bc, lane=lane)
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu")
    rng = np.random.RandomState(0)
    for t in range(n_ctx):
        x = (0.5 * rng.randn(B, 1, S)).astype(np.float32)
        ref, c6 = mk(packed, c6, jnp.asarray(x, jnp.bfloat16), jnp.int32(t))
        out = tt.decode_step(staged, caches, torch.from_numpy(x), t,
                             fp16=True, fp16_out=True)
        assert _rel_err(out.float(), ref.astype(jnp.float32)) < BF_TOL, t


@pytest.fixture(scope="module")
def order12():
    """Order 12 at depth 48: flat f7 prime layers (d = 15, 31), the f0
    dense layer (d = 47) and [1,2,3] scans; prime_len 20 -> _prime_len 24."""
    S, n_ctx, blocks, depth, B = 64, 64, 4, 48, 2
    jt, params, tt = pair(12, S, n_ctx, blocks, depth, 2, prime_len=20,
                          seed=3)
    funcs = [jt.attn_func(d) for d in range(depth)]
    assert funcs[15] == funcs[31] == 7 and funcs[47] == 0
    rng = np.random.RandomState(4)
    bc = n_ctx // blocks
    chunk = (0.5 * rng.randn(B, bc, S)).astype(np.float32)
    xs = (0.5 * rng.randn(n_ctx, B, 1, S)).astype(np.float32)
    return jt, params, tt, chunk, xs, (S, n_ctx, blocks, B, bc)


def test_bf16_stack_matches_megakernel_order12(order12):
    jt, params, tt, chunk, xs, (S, n_ctx, blocks, B, bc) = order12
    packed = jt.pack_stack_segments(jt.prepare_decode_params(params))
    jc = jt.init_cache_from_segments(packed, B, jnp.bfloat16)
    _, jc = jt.prefill_chunk(packed, jc, jnp.asarray(chunk, jnp.bfloat16),
                             jnp.int32(0), 1, fp16=True)
    jc = jt.pack_segment_caches(packed, jc)
    step = jax.jit(lambda c, x, t: jt.decode_step(packed, c, x, t, fp16=True,
                                                  fp16_out=True))
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu")
    with torch.no_grad():
        tt.prefill_chunk(caches, torch.from_numpy(chunk), 0, 1, fp16=True)
        for t in range(bc, n_ctx):
            ref, jc = step(jc, jnp.asarray(xs[t], jnp.bfloat16), jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), ref.astype(jnp.float32)) < BF_TOL, t


def test_fp32_stack_matches_xla_decode_order12(order12):
    jt, params, tt, chunk, xs, (S, n_ctx, blocks, B, bc) = order12
    dec = jt.prepare_decode_params(params)
    jc = jt.init_cache_from_segments(dec, B, jnp.float32)
    _, jc = jt.prefill_chunk(dec, jc, jnp.asarray(chunk), jnp.int32(0), 1)
    step = jax.jit(lambda c, x, t: jt.decode_step(dec, c, x, t))
    staged = tt.prepare_decode_params(torch.float32)
    caches = tt.init_cache(B, torch.float32, "cpu")
    with torch.no_grad():
        tt.prefill_chunk(caches, torch.from_numpy(chunk), 0, 1)
        for t in range(bc, n_ctx):
            ref, jc = step(jc, jnp.asarray(xs[t]), jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t)
            np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5,
                                       atol=2e-5, err_msg=f"t={t}")


def test_launch_counts_stay_zero_on_cpu(order12):
    """The plain versions run for CPU tensors and are not kernel launches."""
    *_, tt, chunk, xs, (S, n_ctx, blocks, B, bc) = order12
    ds.reset_launches()
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu")
    tt.decode_step(staged, caches, torch.from_numpy(xs[0]), 0, fp16=True)
    assert ds.LAUNCHES == dict.fromkeys(
        ("ln_gemv_bf16", "ln_gemv_int8", "gemv_bf16", "gemv_int8",
         "ring_attn_decode", "ring_attn_int8", "cross_attn_decode"), 0)
