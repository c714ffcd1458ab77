"""Pre-LN residual transformer with per-depth factored-attention schedules
(counterpart of jukebox_tpu/models/transformer.py).

Three modes as in the JAX package: the full-context forward (the training
forward too: bf16 activations under fp16, per-layer dropout seeds,
checkpoint_res=1 recomputing each block in the backward, checkpoint_attn /
checkpoint_mlp each block's attention / MLP), one-token
`decode_step` and block-aligned `prefill_chunk`, threading per-layer ring
caches (a list with one {"k", "v"} dict per layer, updated in place).

Decoding in bf16 runs each layer through the decode-step kernels
(ops/decode_stack.py: LayerNorm, qkv GEMV, ring or cross attention, proj
GEMV + residual, LayerNorm, MLP GEMVs), the port of the JAX package's
whole-stack megakernel, with the weights staged once by
prepare_decode_params: bf16, or weight-only int8 (quantize="int8", the JAX
package's JUKEBOX_INT8_DECODE mode); the ring caches are bf16 or int8
(init_cache(int8=True): the prefill writes int8 rows, the decode step
quantises its new row from the fp32 c_attn output), int8 only on the
layers the JAX package packs into its megakernel (packed_layers; the
others, such as the summary pattern's, keep bf16 caches as its unpacked
segments do). The fp32 decode path (and every prefill) runs the layer modules
themselves, as the JAX package runs its fp32 decode and its prefill in XLA;
with int8 staged weights the prefill's products are the int8 dense.
f6 (cross-attention) layers read the lyric encoder's encoder_kv: the full
forward projects it per layer, init_cache once per window.
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from jukebox_tpu_torch.models.attention import FactoredAttention, StepIndex
from jukebox_tpu_torch.ops.bias_gelu import bias_quick_gelu
from jukebox_tpu_torch.ops.core import (Dense, LayerNorm, dense_any, dropout,
                                        fold_seed, quick_gelu, quantize_dense,
                                        quantize_dense_tree)
from jukebox_tpu_torch.parallel.dist import (all_reduce_, copy_to_group,
                                             reduce_from_group)
from jukebox_tpu_torch.parallel.shardings import decode_param_specs
from jukebox_tpu_torch.ops.decode_stack import (quantize_rows, ring_geometry,
                                                stack_layer_step)

# depth -> attn_func schedules (reference transformer.py:111-126)
ATTN_ORDERS = {
    0: lambda d: 0,
    1: lambda d: [1, 2][d % 2],
    2: lambda d: [1, 2, 3][d % 3],
    3: lambda d: [1, 4][d % 2],
    4: lambda d: [1, 5][d % 2],
    5: lambda d: [1, 4, 1, 1][d % 4],
    6: lambda d: [1, 2, 3, 6][d % 4],
    7: lambda d: [*[1, 2, 3] * 5, 6][d % 16],
    8: lambda d: [1, 2, 3, 1, 2, 3, 1, 2, 3, 6][d % 10],
    9: lambda d: [1, 2, 3, 0][d % 4],
    10: lambda d: [*[1, 2, 3] * 3, *[1, 2, 3, 1, 2, 3, 1, 2, 3, 6] * 7][d % 79],
    11: lambda d: ([6, 6, 0][d % 3] if d % 16 == 15 else [1, 2, 3][d % 3]),
    12: lambda d: ([7, 7, 0][d % 3] if d % 16 == 15 else [1, 2, 3][d % 3]),
}


# the attention patterns of the JAX package's decode megakernel
# (ops/pallas/decode_stack.py): a scan segment packs when its pattern uses
# these alone (transformer.py _stack_eligible), a flat layer when it is one
# of the second set (_flat_stack_func: a flat f6 would need the encoder
# projection plumbed through and stays in XLA)
STACK_FUNCS = frozenset((0, 1, 2, 3, 6, 7))
FLAT_STACK_FUNCS = frozenset((0, 1, 2, 3, 7))


def stack_eligible(seg, blocks, prime_len):
    """Whether the JAX package packs a ("scan", funcs, starts) segment of
    its decode plan into the megakernel (Transformer._stack_eligible):
    funcs within STACK_FUNCS, a block geometry, and a prime length where
    an f7 layer needs one. (Its remaining tests hold for every prior: the
    activation is quick_gelu, and n_state % n_head == 0.)"""
    return (seg[0] == "scan" and blocks is not None
            and set(seg[1]) <= STACK_FUNCS
            and (7 not in seg[1] or bool(prime_len)))


def flat_stack_func(f, blocks, prime_len):
    """The pattern of a ("flat", d) segment of attn_func f when the JAX
    package packs it as a one-layer megakernel segment, else None
    (Transformer._flat_stack_func)."""
    if (blocks is None or f not in FLAT_STACK_FUNCS
            or (f == 7 and not prime_len)):
        return None
    return f


def packed_layers(plan, funcs, blocks, prime_len):
    """The layers of a decode plan (Transformer.decode_plan) that the JAX
    package packs into its megakernel: those it decodes with int8 caches
    in its int8 mode. Every other layer keeps caches in the compute
    dtype."""
    out = set()
    for seg in plan:
        if seg[0] == "flat":
            if flat_stack_func(funcs[seg[1]], blocks, prime_len) is not None:
                out.add(seg[1])
        elif stack_eligible(seg, blocks, prime_len):
            out.update(s + j for s in seg[2] for j in range(len(seg[1])))
    return frozenset(out)


class MLP(nn.Module):
    def __init__(self, n_in, n_state, zero_out=False, init_scale=1.0,
                 resid_dropout=0.0, device=None):
        super().__init__()
        self.resid_dropout = resid_dropout
        self.c_fc = Dense(n_in, n_state, init_scale, device=device)
        self.c_proj = Dense(n_state, n_in, init_scale, zero_out, device=device)
        self.tp = None  # the "mp" group of a Megatron split

    def forward(self, x, seed=None, p=None, plain=False):
        """p: the layer's int8 staged decode params (prefill). Split over
        "mp", c_fc holds the rank's columns and c_proj its rows, whose
        partial products are summed over the group before the bias.
        c_fc's bias and quick_gelu are one kernel forward and one backward
        (ops/bias_gelu.py; plain=True: their plain versions). The int8
        prefill keeps the eager quick_gelu after dense_any, whose epilogue
        (the column scale, then the bias, each rounded to x's dtype, as the
        JAX package's dense) is not the kernel's."""
        x = copy_to_group(x, self.tp)
        if p is None:
            h = bias_quick_gelu(torch.matmul(x, self.c_fc.w.to(x.dtype)),
                                self.c_fc.b, plain)
        else:
            h = quick_gelu(dense_any(x, p["fc"]))
        if self.tp is None:
            y = self.c_proj(h) if p is None else dense_any(h, p["mlp"])
        else:
            y = (torch.matmul(h, self.c_proj.w.to(h.dtype)) if p is None
                 else dense_any(h, p["mlp"]))
            y = reduce_from_group(y, self.tp)
            y = y + self.c_proj.b.to(y.dtype)
        return y if p is not None else dropout(y, self.resid_dropout, seed)


class ResAttnBlock(nn.Module):
    def __init__(self, n_in, n_ctx, n_head, attn_func, blocks=None,
                 prime_len=None, m_attn=0.25, m_mlp=1.0, mask=False,
                 zero_out=False, init_scale=1.0, res_scale=1.0,
                 attn_dropout=0.0, resid_dropout=0.0, encoder_dims=None,
                 checkpoint_attn=0, checkpoint_mlp=0, spread=None,
                 device=None):
        super().__init__()
        self.res_scale = res_scale
        self.checkpoint_attn = checkpoint_attn
        self.checkpoint_mlp = checkpoint_mlp
        # f6 layers zero their c_proj at init (jukebox_tpu ResAttnBlock.attn)
        self.attn = FactoredAttention(
            n_in, n_ctx, int(m_attn * n_in), n_head, attn_func, blocks,
            prime_len, mask, zero_out or attn_func == 6, init_scale,
            attn_dropout, resid_dropout, encoder_dims, spread=spread,
            device=device)
        self.ln_0 = LayerNorm(n_in, device=device)
        self.mlp = MLP(n_in, int(m_mlp * n_in), zero_out, init_scale,
                       resid_dropout, device=device)
        self.ln_1 = LayerNorm(n_in, device=device)

    def _residual(self, x, a, m):
        if self.res_scale == 1.0:
            return x + a + m
        return x + self.res_scale * (a + m)

    def forward(self, x, seed=None, plain=False, encoder_kv=None,
                record=False):
        """(x, w): w the attention's recorded weights, or None. With
        checkpoint_attn (unless recording) and checkpoint_mlp and autograd
        on, the LayerNorm + attention and the LayerNorm + MLP are each
        recomputed in the backward pass, as jukebox_tpu wraps them in
        jax.checkpoint (transformer.py:123-131); their dropout masks are
        functions of their seeds, so the recompute draws the same ones."""
        s_attn, s_mlp = ((fold_seed(seed, 0), fold_seed(seed, 1))
                         if seed is not None else (None, None))
        grad = torch.is_grad_enabled()

        def attn(h):
            return self.attn(self.ln_0(h, plain), s_attn, plain, encoder_kv)

        def mlp(h):
            return self.mlp(self.ln_1(h, plain), s_mlp, plain=plain)
        if record:
            a, w = self.attn(self.ln_0(x, plain), s_attn, plain, encoder_kv,
                             True)
        elif self.checkpoint_attn and grad:
            a, w = checkpoint(attn, x, use_reentrant=False,
                              preserve_rng_state=False), None
        else:
            a, w = attn(x), None
        h = x + a
        m = (checkpoint(mlp, h, use_reentrant=False, preserve_rng_state=False)
             if self.checkpoint_mlp and grad else mlp(h))
        return self._residual(x, a, m), w

    def decode_step(self, cache, x, pos):
        a = self.attn.decode_step(cache, self.ln_0(x), pos)
        return self._residual(x, a, self.mlp(self.ln_1(x + a)))

    def prefill_chunk(self, cache, x, t0, n_blocks, p=None):
        a = self.attn.prefill_chunk(cache, self.ln_0(x), t0, n_blocks, p)
        return self._residual(x, a, self.mlp(self.ln_1(x + a), p=p))


class Transformer(nn.Module):
    def __init__(self, n_in, n_ctx, n_head, n_depth, attn_order=0,
                 blocks=None, prime_len=None, m_attn=0.25, m_mlp=1.0,
                 mask=False, zero_out=False, init_scale=1.0, res_scale=False,
                 attn_dropout=0.0, resid_dropout=0.0, checkpoint_res=0,
                 encoder_dims=None, checkpoint_attn=0, checkpoint_mlp=0,
                 spread=None, device=None):
        super().__init__()
        self.n_in, self.n_ctx, self.n_head = n_in, n_ctx, n_head
        self.tp = None  # the "mp" group of a Megatron split
        self.n_depth, self.attn_order = n_depth, attn_order
        self.prime_len, self.n_blocks = prime_len, blocks
        self.res_scale = (1.0 / n_depth) if res_scale else 1.0
        self.dropout = attn_dropout > 0 or resid_dropout > 0
        self.checkpoint_res = checkpoint_res
        self.blocks = nn.ModuleList([
            ResAttnBlock(n_in, n_ctx, n_head, self.attn_func(d), blocks,
                         prime_len, m_attn, m_mlp, mask, zero_out, init_scale,
                         self.res_scale, attn_dropout, resid_dropout,
                         encoder_dims, checkpoint_attn, checkpoint_mlp,
                         spread=spread, device=device)
            for d in range(n_depth)])
        self.layer_order = tuple(self._plan_order())

    def attn_func(self, d):
        return ATTN_ORDERS[self.attn_order](d)

    def step_index(self, t, device):
        """A StepIndex at position t (a host int) with this stack's block
        geometry, the f7 layers' prime length where it has any."""
        return self.blocks[0].attn.step_index(
            t, device, any(b.attn.attn_func == 7 for b in self.blocks))

    def forward(self, x, fp16=False, seed=None, plain=False,
                encoder_kv=None, record_layers=frozenset()):
        """Full-context forward, x [B, n_ctx, n_in] -> (fp32 x, ws), as
        jukebox_tpu's Transformer.apply (encoder_kv feeds the f6 layers):
        bf16 activations under fp16, layer d's dropouts seeded from
        fold_seed(seed, d) when seed is given (training), and with
        checkpoint_res == 1 and autograd on, each block recomputed in the
        backward pass (torch.utils.checkpoint, non-reentrant; the dropout
        masks are functions of their seeds, so the recompute draws the same
        ones). plain=True runs the plain versions of the flash layers, of
        the LayerNorms and of the MLPs' bias + quick_gelu. ws: the softmax
        weights of the layers in record_layers, in depth order (a recorded
        block is not recomputed)."""
        if fp16:
            x = x.to(torch.bfloat16)
        drop = seed is not None and self.dropout
        recompute = self.checkpoint_res == 1 and torch.is_grad_enabled()
        ws = []
        for d, block in enumerate(self.blocks):
            s = fold_seed(seed, d) if drop else None
            enc = encoder_kv if self.attn_func(d) == 6 else None
            record = d in record_layers
            if recompute and not record:
                x, _ = checkpoint(block, x, s, plain, enc, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, w = block(x, s, plain, enc, record)
                if record:
                    ws.append(w)
        return x.float(), ws

    # -- incremental decoding -------------------------------------------------

    @property
    def decode_plan(self):
        """The layer partition of jukebox_tpu's Transformer.decode_plan:
        ("flat", d) or ("scan", funcs, starts) segments, chosen by the same
        DP that minimises the number of traced layer bodies. The port runs
        the segments' layers in this order."""
        funcs = tuple(self.attn_func(d) for d in range(self.n_depth))
        n = self.n_depth
        cost = [0] * (n + 1)
        choice = [None] * (n + 1)
        for i in range(n - 1, -1, -1):
            best, pick = 1 + cost[i + 1], ("flat",)
            for L in range(1, (n - i) // 2 + 1):
                pat = funcs[i:i + L]
                r = 2
                while i + r * L <= n and funcs[i + (r - 1) * L: i + r * L] == pat:
                    c = L + cost[i + r * L]
                    if c < best:
                        best, pick = c, ("scan", L, r)
                    r += 1
            cost[i], choice[i] = best, pick
        segs, i = [], 0
        while i < n:
            pick = choice[i]
            if pick[0] == "flat":
                segs.append(("flat", i))
                i += 1
            else:
                _, L, r = pick
                segs.append(("scan", funcs[i:i + L],
                             tuple(i + g * L for g in range(r))))
                i += L * r
        return tuple(segs)

    @property
    def packed(self):
        """The layers the JAX package packs into its decode megakernel
        (packed_layers): in the int8 mode they alone get int8 caches."""
        return packed_layers(self.decode_plan,
                             [self.attn_func(d) for d in range(self.n_depth)],
                             self.n_blocks, self.prime_len)

    def _plan_order(self):
        for seg in self.decode_plan:
            if seg[0] == "flat":
                yield seg[1]
            else:
                for s in seg[2]:
                    yield from range(s, s + len(seg[1]))

    def prepare_decode_params(self, dtype=torch.bfloat16, quantize=None):
        """Staged decode form of the stack, per layer: fp32 LayerNorm
        parameters (the JAX package's packing keeps them fp32 too) and the
        dense dicts qkv (q alone in f6 layers), proj, fc and mlp, in the
        (in, out) layout: {"w", "b"} as contiguous `dtype` (bf16 for the
        kernels; fp32 runs the same composition through the plain versions
        on the CPU), or with quantize="int8" the weight-only int8 form
        {"w_q", "s", "b"} of quantize_dense (scales from the fp32 weights,
        the bias in `dtype`). f6 layers keep enc_kv, their encoder
        projection, which init_cache applies once per window: fp32, or int8
        like the rest (jukebox_tpu quantizes the kept enc_proj too). Split
        over "mp" (self.tp), each layer stages the rank's pieces, and the
        row-split products of decode_param_specs as _stage_row_split
        says."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown decode quantization {quantize!r}")

        def cast(t):
            return t.detach().to(dtype).contiguous()

        def f32(t):
            return t.detach().float().contiguous()

        def dense(m):
            # int8: quantize_dense_tree below reads the fp32 weights
            return {"w": m.w.detach() if quantize else cast(m.w),
                    "b": cast(m.b)}
        staged = []
        for blk in self.blocks:
            at, mlp = blk.attn, blk.mlp
            mods = dict(qkv=at.c_attn, proj=at.c_proj, fc=mlp.c_fc,
                        mlp=mlp.c_proj)
            p = dict(ln0_g=f32(blk.ln_0.g), ln0_b=f32(blk.ln_0.b),
                     qkv=dense(at.c_attn), proj=dense(at.c_proj),
                     ln1_g=f32(blk.ln_1.g), ln1_b=f32(blk.ln_1.b),
                     fc=dense(mlp.c_fc), mlp=dense(mlp.c_proj))
            if at.attn_func == 6:
                p["enc_kv"] = {"w": at.c_enc_kv.w.detach(),
                               "b": at.c_enc_kv.b.detach()}
            if self.tp is not None:
                self._stage_row_split(p, mods, quantize)
            staged.append(p)
        return quantize_dense_tree(staged) if quantize else staged

    def _stage_row_split(self, p, mods, quantize):
        """A layer's staged dict p split over "mp": each product that
        decode_param_specs splits by rows gets a zero bias and, beside it
        as "<key>_b", its module's bias in fp32, which stack_layer_step adds
        after the all-reduce; int8 quantizes it with the scales of the whole
        weight's columns (the group's largest |w|)."""
        for key, spec in decode_param_specs([p])[0].items():
            if not (isinstance(spec, dict) and spec["w"] == ("mp", None)):
                continue
            p[key + "_b"] = mods[key].b.detach().float().contiguous()
            p[key]["b"] = torch.zeros_like(p[key]["b"])
            if quantize:
                p[key] = quantize_dense(
                    p[key], lambda s: all_reduce_(s, self.tp, "max"))

    def init_cache(self, bs, dtype, device, encoder_kv=None, dec_params=None,
                   int8=False):
        """Per-layer caches: zero rings, the f6 layers' encoder K/V projected
        from encoder_kv (through dec_params' enc_kv when staged). int8=True
        makes int8 caches with zero row scales, the f6 K/V quantised by
        quantize_rows (pack_caches(quantize=True) of the JAX package), for
        the packed layers; the others keep `dtype`, as the JAX package's
        unpacked segments do."""
        caches = []
        packed = self.packed if int8 else ()
        for d, blk in enumerate(self.blocks):
            f = blk.attn.attn_func
            enc_kv = dec_params[d]["enc_kv"] if (
                f == 6 and dec_params is not None) else None
            int8_d = d in packed
            if int8_d and f != 6:
                shape = blk.attn.cache_shape(bs)
                c = {k: torch.zeros(shape, dtype=torch.int8, device=device)
                     for k in ("k", "v")}
                c.update({k: torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                         device=device) for k in ("ks", "vs")})
            else:
                c = blk.attn.init_cache(bs, dtype, device,
                                        encoder_kv if f == 6 else None,
                                        enc_kv)
                if int8_d:
                    c = self._quantize_cache(c)
            caches.append(c)
        return caches

    @staticmethod
    def _quantize_cache(c):
        (k, ks), (v, vs) = quantize_rows(c["k"]), quantize_rows(c["v"])
        return {"k": k, "v": v, "ks": ks, "vs": vs}

    def decode_step(self, dec_params, caches, x, t, fp16=False,
                    fp16_out=False, plain=False):
        """One token x [B, 1, n_in] at position t. With staged dec_params
        (prepare_decode_params) the layers run the decode-step kernels
        (plain=True: their plain versions) at the host int t; without, the
        layer modules, at t's positions on the device (t a host int, or a
        StepIndex)."""
        if fp16:
            x = x.to(torch.bfloat16)
        if dec_params is not None:
            B, _, S = x.shape
            h = x.reshape(B, S).contiguous()
            geoms = {6: None}
            for d in self.layer_order:
                attn = self.blocks[d].attn
                f = attn.attn_func
                if f not in geoms:
                    geoms[f] = ring_geometry(
                        f, t, caches[d]["k"].shape,
                        attn.block_ctx if attn.blocks else None,
                        attn._prime_len if f == 7 else None)
                h = stack_layer_step(dec_params[d], caches[d], h, geoms[f],
                                     attn.n_head, plain, self.res_scale,
                                     self.tp, attn.whole)
            x = h.reshape(B, 1, S)
        else:
            if not isinstance(t, StepIndex):
                t = self.step_index(t, x.device)
            pos = t.positions()
            for d in self.layer_order:
                x = self.blocks[d].decode_step(caches[d], x, pos)
        return x if fp16_out else x.float()

    def prefill_chunk(self, caches, x, t0, n_blocks, fp16=False,
                      dec_params=None):
        """Prefill the caches with a block-aligned chunk x [B, C, n_in] at
        t0; returns the chunk's output in the compute dtype. dec_params:
        the staged decode form; a layer staged int8 runs its products as
        the int8 dense (jukebox_tpu's _recon_group prefill of a packed
        layer, its int8 dense tree of another)."""
        if fp16:
            x = x.to(torch.bfloat16)
        for d in self.layer_order:
            p = (dec_params[d] if dec_params is not None
                 and "w_q" in dec_params[d]["qkv"] else None)
            x = self.blocks[d].prefill_chunk(caches[d], x, t0, n_blocks, p)
        return x
