"""The int8 ring caches of the port against jukebox_tpu's on the CPU: what
is written into them, row for row.

* The prefill (prefill_chunk against int8 caches) against jukebox_tpu's
  kernel-cache prefill (attention.py _prefill_chunk_kernel, the int8
  staging of make_models: packed int8 segments, quantize_dense_tree), for
  stacks whose patterns cover f1, f2, f3, f6 (order 6), f0 (order 9) and
  the f7 prime (order 12): two chunks, and after each chunk every layer's
  int8 rows and bf16 scales against the JAX caches. Each layer is fed the
  JAX stack's input to that layer, so a layer is held to its own
  arithmetic: its int8 values within one step of the JAX package's in at
  most ROW_SHARE of the elements, and its scales within one bf16 step.
  Both quantise the same rows (the chunk's k, v in bf16, absmax / 127
  floored at 1e-8, round(x / s)), but the two compute those rows' bf16
  products in different summation orders, so a row value can differ by
  one bf16 step and cross a rounding boundary of its int8 step. Then the
  window's decode steps from those caches against the megakernel (int8
  weights and caches, interpret mode): INT8_TOL of max(1, |ref|), as
  tests/test_torch_5b_decode.py.
* The decode step's new row: the first layer of an int8 stack, whose input
  is the same in both, writes int8 rows and scales equal to the
  megakernel's bit for bit at every token: both quantise the row from the
  fp32 output of its c_attn product (decode_stack.py:653-684), not from
  the bf16-rounded row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops.core import quantize_dense_tree
from test_torch_5b_decode import MegakernelStack, _rel_err, pair

torch.set_num_threads(1)
INT8_TOL = 0.05
ROW_SHARE = 0.01
S, N_CTX, BLOCKS, B, ENC, PRIME = 96, 32, 4, 2, 8, 8
A = S // 4
BC = N_CTX // BLOCKS


def std(c, f, scale=False):
    """A kernel-layout cache buffer of one group ([slots, Bp, Ap], f2
    [bc, blocks, Bp, Ap], f3 [2, bc, Bp, Ap]; scales [..., Bp, lanes] with
    the value in lane 0) in the port's layout [B, slots..., A] (or
    [B, slots...])."""
    c = np.asarray(c.astype(jnp.float32) if c.dtype == jnp.bfloat16 else c)
    if f == 2:
        c = c.transpose(2, 0, 1, 3)
    else:
        if f == 3:
            c = c.reshape(2 * BC, *c.shape[2:])
        c = c.transpose(1, 0, 2)
    c = c[:B]
    return c[..., 0] if scale else c[..., :A]


def jax_layers(jt, dec):
    """(layer, attn_func, group, position, packed group params) of every
    layer in the JAX decode plan's order; every segment is packed."""
    out = []
    for seg, p_seg in zip(jt.decode_plan, dec):
        assert "stack_packed" in p_seg, seg
        pat = jt._packed_pat(seg, p_seg)
        starts = seg[2] if seg[0] == "scan" else (seg[1],)
        for g, s0 in enumerate(starts):
            flat_g = [x[g] for x in p_seg["stack_packed"]]
            trees = jt._recon_group(flat_g, pat=pat)
            for j, f in enumerate(pat):
                out.append((s0 + j, f, g, j, trees[j]))
    return out


def compare_rows(out, ref, what):
    """int8 rows within one step in at most ROW_SHARE of the elements."""
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, (what, d.max())
    assert (d > 0).mean() <= ROW_SHARE, (what, (d > 0).mean())


@pytest.mark.parametrize("order,depth", [(6, 8), (9, 8), (12, 16)])
def test_int8_prefill_matches_jax_chunk_by_chunk(order, depth):
    jt, params, tt = pair(order, depth, seed=20 + order, prime_len=PRIME)
    rng = np.random.RandomState(order)
    enc = (0.5 * rng.randn(B, ENC, S)).astype(np.float32)
    x = (0.5 * rng.randn(B, N_CTX, S)).astype(np.float32)
    xs = (0.5 * rng.randn(N_CTX, B, 1, S)).astype(np.float32)
    enc_j = jnp.asarray(enc, jnp.bfloat16)
    # jukebox_tpu's int8 staging (make_models.py:505-522): packed int8
    # segments, then quantize_dense_tree (the kept f6 projections)
    dec = quantize_dense_tree(jt.pack_stack_segments(
        jt.prepare_decode_params(params), quantize=True))
    jc = jt.init_cache_from_segments(dec, B, jnp.bfloat16, encoder_kv=enc_j)
    assert jc[0][0].dtype == jnp.int8
    staged = tt.prepare_decode_params(torch.bfloat16, quantize="int8")
    caches = tt.init_cache(B, torch.bfloat16, "cpu",
                           encoder_kv=torch.from_numpy(enc).bfloat16(),
                           dec_params=staged, int8=True)
    layers = jax_layers(jt, dec)
    # the JAX caches as per-layer-position dicts, one list per segment
    seg_of = {}
    for si, seg in enumerate(jt.decode_plan):
        pat = jt._packed_pat(seg, dec[si])
        starts = seg[2] if seg[0] == "scan" else (seg[1],)
        for s0 in starts:
            for j in range(len(pat)):
                seg_of[s0 + j] = si
    jcs = [list(c) for c in jc]
    funcs = set()
    for ci in range(2):
        t0 = ci * BC
        h = jnp.asarray(x[:, t0:t0 + BC], jnp.bfloat16)
        for d, f, g, j, tree in layers:
            si = seg_of[d]
            cache = {key: jcs[si][4 * j + i]
                     for i, key in enumerate(("k", "v", "ks", "vs"))}
            x_in = torch.from_numpy(np.array(h.astype(jnp.float32))).to(
                torch.bfloat16)
            h, cache = jt.block_cfg_f(f).prefill_chunk(
                tree, cache, h, jnp.int32(t0), 1, encoder_kv=None,
                g=jnp.int32(g), kernel_cache=True)
            for i, key in enumerate(("k", "v", "ks", "vs")):
                jcs[si][4 * j + i] = cache[key]
            with torch.no_grad():
                tt.blocks[d].prefill_chunk(caches[d], x_in, t0, 1,
                                           staged[d])
            funcs.add(f)
            # the prime cache's garbage row, the f0 ring's chunk padding
            rows = caches[d]["k"].shape[1] if f in (0, 7) else None
            for key in ("k", "v"):
                ref = std(cache[key][g], f)
                ref_s = std(cache[key + "s"][g], f, scale=True)
                if rows is not None:
                    ref, ref_s = ref[:, :rows], ref_s[:, :rows]
                what = f"chunk {ci} layer {d} f{f} {key}"
                compare_rows(caches[d][key].numpy(), ref, what)
                out_s = caches[d][key + "s"].float().numpy()
                assert (np.abs(out_s - ref_s)
                        <= np.abs(ref_s) * 2.0 ** -7).all(), what
    assert funcs >= {1, 2, 3}
    # the window's decode steps from the prefilled caches
    jc = [tuple(c) for c in jcs]
    step = jax.jit(lambda c, x_, t: jt.decode_step(dec, c, x_, t, fp16=True,
                                                   fp16_out=True))
    with torch.no_grad():
        for t in range(2 * BC, 2 * BC + 6):
            ref, jc = step(jc, jnp.asarray(xs[t], jnp.bfloat16), jnp.int32(t))
            out = tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                                 fp16=True, fp16_out=True)
            assert _rel_err(out.float(), np.asarray(
                ref.astype(jnp.float32))) < INT8_TOL, t


def test_decode_row_is_quantised_from_fp32():
    """Order 2 at depth 3 (three flat layers, each a megakernel segment):
    layer 0's written k, v rows and scales at every token, from an empty
    context across four block boundaries."""
    jt, params, tt = pair(2, 3, seed=13)
    xs = (0.5 * np.random.RandomState(14).randn(N_CTX, B, 1, S)).astype(
        np.float32)
    jc = jt.init_cache(params, B, jnp.bfloat16)
    mk = MegakernelStack(jt, params, jc, quantized=True,
                         cache_quantized=True)
    staged = tt.prepare_decode_params(torch.bfloat16, quantize="int8")
    caches = tt.init_cache(B, torch.bfloat16, "cpu", dec_params=staged,
                           int8=True)
    with torch.no_grad():
        for t in range(N_CTX):
            mk.step(xs[t], t)
            tt.decode_step(staged, caches, torch.from_numpy(xs[t]), t,
                           fp16=True, fp16_out=True)
            seg, slot = mk.segs[0][2], t % BC
            for i, key in enumerate(("k", "v")):
                np.testing.assert_array_equal(
                    caches[0][key][:, slot].numpy(),
                    np.asarray(seg[i])[0, slot, :B, :A], err_msg=f"{t}")
                np.testing.assert_array_equal(
                    caches[0][key + "s"][:, slot].float().numpy(),
                    np.asarray(seg[2 + i].astype(jnp.float32))[0, slot, :B,
                                                               0],
                    err_msg=f"{t}")
