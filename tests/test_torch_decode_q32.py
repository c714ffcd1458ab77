"""The decode step's attention arithmetic against jukebox_tpu's megakernel
(build_stack_decode, interpret mode) on the CPU: q read in fp32 (the
c_attn product plus bias before its bf16 rounding), fp32 softmax weights
times V, the head output rounded to bf16 once
(jukebox_tpu/ops/pallas/decode_stack.py:649-653, 766-799).

The megakernel is compiled without XLA's excess precision
(`xla_allow_excess_precision`, on by default, lets the CPU backend keep
fp32 where the kernel rounds to bf16, e.g. in `x + a + m`), so it rounds
exactly where its source says. The port's bf16 decode step (the plain
versions, composed by Transformer.decode_step) then gives the same bf16
outputs but where the two sum in another fp32 order (the megakernel's f0
layer runs an online softmax over chunks of rows): an attention output a
bf16 step apart, which c_proj spreads over a token's whole row.

* a stack in the priors' ring patterns with a dense f0 layer last (order
  9, [1, 2, 3, 0]), decoded from an empty context to 96 rows;
* the 5b_lyrics layout's f6 cross-attention (order 10 at depth 20, as
  tests/test_torch_5b_decode.py), every token of the context.

Readings on the CPU, fraction of output elements over all tokens that
differ from the megakernel's (largest error relative to max(1, |ref|)),
with the port's fp32 q and weights, and with q and the weights rounded
to bf16 (the port's arithmetic before it followed the megakernel):
  f0 stack  fp32 0.0381 (5.88e-03)   bf16 0.2803 (9.62e-03)
  f6 stack  fp32 0.0008 (6.65e-04)   bf16 0.6453 (2.13e-02)
Each case has its own bound on that fraction, from its own reading:
F0_MISMATCH 10% and F6_MISMATCH 1%. The bf16 arithmetic fails both; its
largest errors stay inside the 0.04 of tests/test_torch_decode_stack.py
(WORST_TOL, held here too), which is why that bound could not see it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jukebox_tpu.models.transformer import Transformer as JTransformer
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.utils.convert import from_jax_params
from test_torch_5b_decode import (B, N_CTX, MegakernelStack, _inputs,
                                  _perturbed, pair)

torch.set_num_threads(1)
F0_MISMATCH, F6_MISMATCH, WORST_TOL = 0.1, 0.01, 0.04
EXACT = {"xla_allow_excess_precision": False}


def exact(jitted):
    """jitted, compiled at its first call's shapes without XLA's excess
    precision."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options=EXACT))
        return compiled[0](*args)
    return call


def mismatch(outs, refs):
    """(fraction of elements that differ, largest error relative to
    max(1, |ref|))."""
    o, r = np.stack(outs), np.stack(refs)
    worst = max(np.abs(a - b).max() / max(1.0, np.abs(b).max())
                for a, b in zip(outs, refs))
    return (o != r).mean(), worst


def test_f0_stack_decode_matches_megakernel_exactly():
    S, H, n_ctx, blocks, depth, n_tok, batch = 128, 2, 128, 4, 4, 96, 2
    kw = dict(n_ctx=n_ctx, n_head=H, n_depth=depth, attn_order=9,
              blocks=blocks, m_attn=0.25, m_mlp=1.0, mask=True)
    jt = JTransformer(n_in=S, **kw)
    assert [jt.attn_func(d) for d in range(depth)] == [1, 2, 3, 0]
    params = _perturbed(jt.init(jax.random.key(0)), 0)
    tt = Transformer(S, device="cpu", **kw)
    from_jax_params(tt, params)
    packed = jt.pack_stack_segments(jt.prepare_decode_params(params))
    jc = jt.pack_segment_caches(
        packed, jt.init_cache_from_segments(packed, batch, jnp.bfloat16))
    step = exact(jax.jit(lambda c, x, t: jt.decode_step(
        packed, c, x, t, fp16=True, fp16_out=True)))
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(batch, torch.bfloat16, "cpu")
    xs = (0.5 * np.random.RandomState(1).randn(n_tok, batch, 1, S)
          ).astype(np.float32)
    outs, refs = [], []
    with torch.no_grad():
        for t in range(n_tok):
            ref, jc = step(jc, jnp.asarray(xs[t], jnp.bfloat16),
                           jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            refs.append(np.asarray(ref.astype(jnp.float32)))
            outs.append(out.float().numpy())
    frac, worst = mismatch(outs, refs)
    assert frac <= F0_MISMATCH and worst <= WORST_TOL, (frac, worst)


def test_f6_stack_decode_matches_megakernel_exactly():
    jt, params, tt = pair(10, 20, seed=1)
    assert jt.attn_func(18) == 6
    enc, _, xs = _inputs(2)
    enc_j = jnp.asarray(enc, jnp.bfloat16)
    mk = MegakernelStack(jt, params, jt.init_cache(
        params, B, jnp.bfloat16, encoder_kv=enc_j))
    for seg in mk.segs:
        seg[0] = exact(seg[0])
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged)
    outs, refs = [], []
    with torch.no_grad():
        for t in range(N_CTX):
            refs.append(mk.step(xs[t], t))
            outs.append(tt.decode_step(staged, caches,
                                       torch.from_numpy(xs[t]), t,
                                       fp16=True, fp16_out=True
                                       ).float().numpy())
    frac, worst = mismatch(outs, refs)
    assert frac <= F6_MISMATCH and worst <= WORST_TOL, (frac, worst)
