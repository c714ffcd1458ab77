"""The port's decode step (ops/decode_stack.py plain versions, composed by
Transformer.decode_step) against jukebox_tpu's whole-stack Pallas
megakernel (build_stack_decode, interpret mode) on the CPU, in every option
the 5b cascade and the int8 mode use: order-10 stacks whose f6 layers
cross-attend a read-only encoder cache, heads of width 6 (A 24, 4 heads:
not lane-aligned, the 5b top's hd 150 case), int8 weights and int8 ring
caches, and res_scale. Each segment of the JAX decode plan runs as one
megakernel segment (flat layers as single-layer segments), token by token
across block boundaries.

Tolerances, relative to max(1, |ref|):
* bf16: BF_TOL 0.04, as tests/test_torch_decode_stack.py: both are bf16
  paths that round at different points (the port keeps q in bf16 and casts
  the softmax weights to bf16 before the PV product; the megakernel keeps
  both in fp32).
* int8 weights and caches: INT8_TOL 0.05, the bound the JAX package holds
  its own int8 megakernel to against its XLA path. Both quantise the new
  k, v rows from the fp32 output of the c_attn product, and where a
  layer's input is the same they write the same int8 rows and scales bit
  for bit (tests/test_torch_int8_cache.py); deeper in the stack the bf16
  differences above reach a layer's input, so its fp32 row can differ by
  a bf16 step and its int8 row by one int8 step (1/127 of its absmax) in
  the elements near a rounding boundary, and every later token reads
  it.
* res_scale: BF_TOL against the megakernel and against the JAX XLA bf16
  decode step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.models.transformer import Transformer as JTransformer
from jukebox_tpu.ops.core import quantize_dense as jquantize_dense
from jukebox_tpu.ops.pallas.decode_stack import (_flatten_packed,
                                                 build_stack_decode,
                                                 pack_caches,
                                                 pack_decode_params)
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.utils.convert import from_jax_params

torch.set_num_threads(1)
BF_TOL = 0.04
INT8_TOL = 0.05
LANE = 8
S, H, N_CTX, BLOCKS, B, ENC = 96, 4, 32, 4, 2, 8
A = S // 4
BC = N_CTX // BLOCKS


def _perturbed(tree, seed):
    """Random values in every leaf (the init zeroes biases and the f6
    layers' c_proj, which would hide their contribution)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*np.shape(a)).astype(
            np.float32), tree)


def pair(order, depth, seed=0, res_scale=False, n_head=H, enc=ENC,
         prime_len=None):
    kw = dict(n_ctx=N_CTX, n_head=n_head, n_depth=depth, attn_order=order,
              blocks=BLOCKS, m_attn=0.25, m_mlp=1.0, mask=True,
              res_scale=res_scale, prime_len=prime_len)
    jt = JTransformer(n_in=S, encoder_dims=enc, **kw)
    params = _perturbed(jt.init(jax.random.key(seed)), seed)
    tt = Transformer(S, device="cpu", encoder_dims=enc, **kw)
    from_jax_params(tt, params)
    return jt, params, tt


def quantized_enc(params):
    """params with every f6 layer's c_enc_kv in its int8 form, as
    jukebox_tpu's int8 staging leaves it (quantize_dense_tree)."""
    blocks = []
    for p in params["blocks"]:
        attn = dict(p["attn"])
        if "c_enc_kv" in attn:
            attn["c_enc_kv"] = jquantize_dense(attn["c_enc_kv"])
        blocks.append(dict(p, attn=attn))
    return {"blocks": blocks}


class MegakernelStack:
    """Every segment of jt.decode_plan as one build_stack_decode segment
    (interpret mode): scans as they are, flat layers (the order-10 plan's
    flat f6) as single-layer segments. caches: the standard caches of
    jt.init_cache after any prefill, converted with pack_caches; with
    cache_quantized, int8 in the segments the JAX package packs
    (_stack_eligible, _flat_stack_func), as its int8 mode makes them: the
    flat f6, which it leaves to XLA, keeps bf16 caches."""

    def __init__(self, jt, params, caches, head_mode="auto", quantized=False,
                 cache_quantized=False):
        dec = jt.prepare_decode_params(params)
        self.segs = []
        for seg, p_seg, c_seg in zip(jt.decode_plan, dec, caches):
            if seg[0] == "flat":
                pat, G = (jt.attn_func(seg[1]),), 1
                p_seg = (jax.tree_util.tree_map(
                    lambda x: np.asarray(x)[None], p_seg),)
                c_seg = (jax.tree_util.tree_map(lambda x: x[None], c_seg),)
            else:
                pat, G = tuple(seg[1]), len(seg[2])
            packed = _flatten_packed(pack_decode_params(
                p_seg, lane=LANE, quantize=quantized, pat=pat))
            res_scale = jt.block_cfg(0).res_scale
            packs = (jt._flat_stack_func(seg[1]) is not None
                     if seg[0] == "flat" else jt._stack_eligible(seg))
            quant_cache = cache_quantized and packs
            mk = jax.jit(build_stack_decode(
                S, A, S, BC, BLOCKS, G, B, res_scale=res_scale, lane=LANE,
                quantized=quantized, pat=pat, n_head=jt.n_head,
                interpret=True, head_mode=head_mode,
                enc_rows=ENC if 6 in pat else 0,
                cache_quantized=quant_cache))
            c6 = pack_caches(tuple(c_seg), BC, pat=pat, lane=LANE,
                             quantize=quant_cache)
            self.segs.append([mk, packed, c6])

    def step(self, x, t):
        x = jnp.asarray(x, jnp.bfloat16)
        for s in self.segs:
            x, s[2] = s[0](s[1], s[2], x, jnp.int32(t))
        return np.asarray(x.astype(jnp.float32))


def _rel_err(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def _inputs(seed):
    rng = np.random.RandomState(seed)
    enc = (0.5 * rng.randn(B, ENC, S)).astype(np.float32)
    chunk = (0.5 * rng.randn(B, BC, S)).astype(np.float32)
    xs = (0.5 * rng.randn(N_CTX, B, 1, S)).astype(np.float32)
    return enc, chunk, xs


@pytest.mark.parametrize("head_mode", ["matmul", "auto"])
def test_bf16_f6_stack_matches_megakernel(head_mode):
    """Order 10 at depth 20: [1,2,3] x 6, the flat f6 at d = 18, one f1;
    a one-block prefill, then every token to the end of the context."""
    jt, params, tt = pair(10, 20, seed=1)
    assert jt.attn_func(18) == 6
    enc, chunk, xs = _inputs(2)
    enc_j = jnp.asarray(enc, jnp.bfloat16)
    dec = jt.prepare_decode_params(params)
    jc = jt.init_cache(params, B, jnp.bfloat16, encoder_kv=enc_j)
    _, jc = jt.prefill_chunk(dec, jc, jnp.asarray(chunk, jnp.bfloat16),
                             jnp.int32(0), 1, encoder_kv=enc_j, fp16=True)
    mk = MegakernelStack(jt, params, jc, head_mode)
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged)
    with torch.no_grad():
        tt.prefill_chunk(caches, torch.from_numpy(chunk), 0, 1, fp16=True)
        for t in range(BC, N_CTX):
            ref = mk.step(xs[t], t)
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), ref) < BF_TOL, t


@pytest.mark.parametrize("head_mode", ["matmul", "masked"])
def test_int8_f6_stack_matches_megakernel(head_mode):
    """quantized=True, cache_quantized=True from an empty context: every
    int8 ring row the later tokens read was quantised by the decode step
    itself, across four block boundaries; the flat f6 layer, which the
    JAX package does not pack, keeps its encoder rows in bf16, projected
    by its int8 c_enc_kv (the packed f6 layers' int8 encoder rows:
    tests/test_torch_int8_cache.py)."""
    jt, params, tt = pair(10, 20, seed=3)
    enc, _, xs = _inputs(4)
    enc_j = jnp.asarray(enc, jnp.bfloat16)
    jc = jt.init_cache(quantized_enc(params), B, jnp.bfloat16,
                       encoder_kv=enc_j)
    mk = MegakernelStack(jt, params, jc, head_mode, quantized=True,
                         cache_quantized=True)
    staged = tt.prepare_decode_params(torch.bfloat16, quantize="int8")
    assert staged[0]["qkv"]["w_q"].dtype == torch.int8
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged, int8=True)
    assert tt.packed == frozenset(range(20)) - {18}
    assert caches[18]["k"].dtype == torch.bfloat16 and "ks" not in caches[18]
    assert caches[19]["k"].dtype == torch.int8 and "ks" in caches[0]
    with torch.no_grad():
        for t in range(N_CTX):
            ref = mk.step(xs[t], t)
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), ref) < INT8_TOL, t


def test_int8_weights_bf16_caches_match_megakernel():
    """JUKEBOX_INT8_CACHE=0: int8 weights with bf16 ring caches."""
    jt, params, tt = pair(10, 20, seed=5)
    enc, _, xs = _inputs(6)
    enc_j = jnp.asarray(enc, jnp.bfloat16)
    jc = jt.init_cache(quantized_enc(params), B, jnp.bfloat16,
                       encoder_kv=enc_j)
    mk = MegakernelStack(jt, params, jc, quantized=True)
    staged = tt.prepare_decode_params(torch.bfloat16, quantize="int8")
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged)
    with torch.no_grad():
        for t in range(N_CTX):
            ref = mk.step(xs[t], t)
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), ref) < INT8_TOL, t


def test_res_scale_matches_megakernel_and_xla():
    """res_scale stacks (x + (a + m) / depth): the residual epilogue against
    build_stack_decode(res_scale=...) and the JAX XLA bf16 decode step."""
    jt, params, tt = pair(2, 6, seed=7, res_scale=True, n_head=1, enc=None)
    assert tt.res_scale == jt.block_cfg(0).res_scale == 1.0 / 6
    _, _, xs = _inputs(8)
    dec = jt.prepare_decode_params(params)
    jc = jt.init_cache(params, B, jnp.bfloat16)
    mk = MegakernelStack(jt, params, jc)
    xla = jax.jit(lambda c, x, t: jt.decode_step(dec, c, x, t, fp16=True,
                                                 fp16_out=True))
    staged = tt.prepare_decode_params(torch.bfloat16)
    caches = tt.init_cache(B, torch.bfloat16, "cpu")
    with torch.no_grad():
        for t in range(N_CTX):
            ref = mk.step(xs[t], t)
            ref_x, jc = xla(jc, jnp.asarray(xs[t], jnp.bfloat16),
                            jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), ref) < BF_TOL, t
            assert _rel_err(out.float(), ref_x.astype(jnp.float32)) \
                < BF_TOL, t


def test_fp32_f6_stack_matches_xla_decode():
    """fp32 staged plain versions (f6 included) against the JAX XLA fp32
    decode step: 2e-5 abs + 2e-5 rel, summation order only."""
    jt, params, tt = pair(10, 20, seed=9)
    enc, chunk, xs = _inputs(10)
    dec = jt.prepare_decode_params(params)
    jc = jt.init_cache(params, B, jnp.float32, encoder_kv=jnp.asarray(enc))
    _, jc = jt.prefill_chunk(dec, jc, jnp.asarray(chunk), jnp.int32(0), 1,
                             encoder_kv=jnp.asarray(enc))
    step = jax.jit(lambda c, x, t: jt.decode_step(dec, c, x, t))
    staged = tt.prepare_decode_params(torch.float32)
    caches = tt.init_cache(B, torch.float32, "cpu",
                           encoder_kv=torch.from_numpy(enc),
                           dec_params=staged)
    with torch.no_grad():
        tt.prefill_chunk(caches, torch.from_numpy(chunk), 0, 1)
        for t in range(BC, N_CTX):
            ref, jc = step(jc, jnp.asarray(xs[t]), jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t)
            np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5,
                                       atol=2e-5, err_msg=f"t={t}")


def test_layer_launches_and_cpu_counts():
    """The launch table of a layer (5 launches: the two LayerNorms are the
    prologues of the GEMVs that read them), and no launch counted on the
    CPU."""
    assert ds.layer_launches(6, True, True) == {
        "ln_gemv_int8": 2, "gemv_int8": 2, "cross_attn_decode": 1}
    assert ds.layer_launches(2, False, True) == {
        "ln_gemv_bf16": 2, "gemv_bf16": 2, "ring_attn_int8": 1}
    assert all(sum(ds.layer_launches(f, q, c).values()) == 5
               for f in (0, 1, 2, 3, 6, 7) for q in (False, True)
               for c in (False, True))
    _, _, tt = pair(10, 20, seed=11)
    enc, _, xs = _inputs(12)
    ds.reset_launches()
    staged = tt.prepare_decode_params(torch.bfloat16, quantize="int8")
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged, int8=True)
    with torch.no_grad():
        tt.decode_step(staged, caches, torch.from_numpy(xs[0]), 0, fp16=True)
    assert all(v == 0 for v in ds.LAUNCHES.values())
