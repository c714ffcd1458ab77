"""Pre-LN residual transformer with per-depth factored-attention schedules
(counterpart of jukebox_tpu/models/transformer.py).

Three modes as in the JAX package: the full-context forward (the training
forward too: bf16 activations under fp16, per-layer dropout seeds, and
checkpoint_res=1 recomputing each block in the backward), one-token
`decode_step` and block-aligned `prefill_chunk`, threading per-layer ring
caches (a list with one {"k", "v"} dict per layer, updated in place).

Decoding in bf16 runs each layer through the decode-step kernels
(ops/decode_stack.py: LayerNorm, qkv GEMV, ring attention, proj GEMV +
residual, LayerNorm, MLP GEMVs), the port of the JAX package's whole-stack
megakernel, with the weights staged once as bf16 by prepare_decode_params.
The fp32 decode path (and every prefill) runs the layer modules themselves,
as the JAX package runs its fp32 decode and its prefill in XLA.
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from jukebox_tpu_torch.models.attention import FactoredAttention
from jukebox_tpu_torch.ops.core import (Dense, LayerNorm, dropout, fold_seed,
                                        quick_gelu)
from jukebox_tpu_torch.ops.decode_stack import ring_geometry, stack_layer_step

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


class MLP(nn.Module):
    def __init__(self, n_in, n_state, zero_out=False, init_scale=1.0,
                 resid_dropout=0.0, device=None):
        super().__init__()
        self.resid_dropout = resid_dropout
        self.c_fc = Dense(n_in, n_state, init_scale, device=device)
        self.c_proj = Dense(n_state, n_in, init_scale, zero_out, device=device)

    def forward(self, x, seed=None):
        return dropout(self.c_proj(quick_gelu(self.c_fc(x))),
                       self.resid_dropout, seed)


class ResAttnBlock(nn.Module):
    def __init__(self, n_in, n_ctx, n_head, attn_func, blocks=None,
                 prime_len=None, m_attn=0.25, m_mlp=1.0, mask=False,
                 zero_out=False, init_scale=1.0, res_scale=1.0,
                 attn_dropout=0.0, resid_dropout=0.0, device=None):
        super().__init__()
        self.res_scale = res_scale
        self.attn = FactoredAttention(
            n_in, n_ctx, int(m_attn * n_in), n_head, attn_func, blocks,
            prime_len, mask, zero_out, init_scale, attn_dropout,
            resid_dropout, device=device)
        self.ln_0 = LayerNorm(n_in, device=device)
        self.mlp = MLP(n_in, int(m_mlp * n_in), zero_out, init_scale,
                       resid_dropout, device=device)
        self.ln_1 = LayerNorm(n_in, device=device)

    def _residual(self, x, a, m):
        if self.res_scale == 1.0:
            return x + a + m
        return x + self.res_scale * (a + m)

    def forward(self, x, seed=None, plain=False):
        s_attn, s_mlp = ((fold_seed(seed, 0), fold_seed(seed, 1))
                         if seed is not None else (None, None))
        a = self.attn(self.ln_0(x, plain), s_attn, plain)
        return self._residual(x, a, self.mlp(self.ln_1(x + a, plain), s_mlp))

    def decode_step(self, cache, x, t):
        a = self.attn.decode_step(cache, self.ln_0(x), t)
        return self._residual(x, a, self.mlp(self.ln_1(x + a)))

    def prefill_chunk(self, cache, x, t0, n_blocks):
        a = self.attn.prefill_chunk(cache, self.ln_0(x), t0, n_blocks)
        return self._residual(x, a, self.mlp(self.ln_1(x + a)))


class Transformer(nn.Module):
    def __init__(self, n_in, n_ctx, n_head, n_depth, attn_order=0,
                 blocks=None, prime_len=None, m_attn=0.25, m_mlp=1.0,
                 mask=False, zero_out=False, init_scale=1.0, res_scale=False,
                 attn_dropout=0.0, resid_dropout=0.0, checkpoint_res=0,
                 device=None):
        super().__init__()
        self.n_in, self.n_ctx, self.n_head = n_in, n_ctx, n_head
        self.n_depth, self.attn_order = n_depth, attn_order
        self.prime_len = prime_len
        self.res_scale = (1.0 / n_depth) if res_scale else 1.0
        self.dropout = attn_dropout > 0 or resid_dropout > 0
        self.checkpoint_res = checkpoint_res
        self.blocks = nn.ModuleList([
            ResAttnBlock(n_in, n_ctx, n_head, self.attn_func(d), blocks,
                         prime_len, m_attn, m_mlp, mask, zero_out, init_scale,
                         self.res_scale, attn_dropout, resid_dropout,
                         device=device)
            for d in range(n_depth)])
        self.layer_order = tuple(self._plan_order())

    def attn_func(self, d):
        return ATTN_ORDERS[self.attn_order](d)

    def forward(self, x, fp16=False, seed=None, plain=False):
        """Full-context forward, x [B, n_ctx, n_in] -> fp32, as
        jukebox_tpu's Transformer.apply: bf16
        activations under fp16, layer d's dropouts seeded from
        fold_seed(seed, d) when seed is given (training), and with
        checkpoint_res == 1 and autograd on, each block recomputed in the
        backward pass (torch.utils.checkpoint, non-reentrant; the dropout
        masks are functions of their seeds, so the recompute draws the same
        ones). plain=True runs the plain versions of the flash layers and of
        the LayerNorms."""
        if fp16:
            x = x.to(torch.bfloat16)
        drop = seed is not None and self.dropout
        recompute = self.checkpoint_res == 1 and torch.is_grad_enabled()
        for d, block in enumerate(self.blocks):
            s = fold_seed(seed, d) if drop else None
            if recompute:
                x = checkpoint(block, x, s, plain, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, s, plain)
        return x.float()

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

    def _plan_order(self):
        for seg in self.decode_plan:
            if seg[0] == "flat":
                yield seg[1]
            else:
                for s in seg[2]:
                    yield from range(s, s + len(seg[1]))

    def prepare_decode_params(self, dtype=torch.bfloat16):
        """Staged decode form of the stack: per layer, the weights the
        decode-step kernels stream, as contiguous `dtype` (bf16 for the
        kernels; fp32 runs the same composition through the plain versions
        on the CPU) in the (in, out) layout, with fp32 LayerNorm parameters
        (the JAX package's bf16 packing keeps LN fp32 too)."""
        if self.res_scale != 1.0:
            raise NotImplementedError("the decode kernels add x + a + m; "
                                      "res_scale stacks decode in fp32")

        def bf(t):
            return t.detach().to(dtype).contiguous()

        def f32(t):
            return t.detach().float().contiguous()
        staged = []
        for blk in self.blocks:
            at, mlp = blk.attn, blk.mlp
            staged.append(dict(
                ln0_g=f32(blk.ln_0.g), ln0_b=f32(blk.ln_0.b),
                w_qkv=bf(at.c_attn.w), b_qkv=bf(at.c_attn.b),
                w_proj=bf(at.c_proj.w), b_proj=bf(at.c_proj.b),
                ln1_g=f32(blk.ln_1.g), ln1_b=f32(blk.ln_1.b),
                w_fc=bf(mlp.c_fc.w), b_fc=bf(mlp.c_fc.b),
                w_mlp=bf(mlp.c_proj.w), b_mlp=bf(mlp.c_proj.b)))
        return staged

    def init_cache(self, bs, dtype, device):
        return [blk.attn.init_cache(bs, dtype, device) for blk in self.blocks]

    def decode_step(self, dec_params, caches, x, t, fp16=False,
                    fp16_out=False, plain=False):
        """One token x [B, 1, n_in] at position t. With staged dec_params
        (prepare_decode_params) the layers run the decode-step kernels
        (plain=True: their plain versions); without, the layer modules."""
        if fp16:
            x = x.to(torch.bfloat16)
        if dec_params is not None:
            B, _, S = x.shape
            h = x.reshape(B, S).contiguous()
            geoms = {}
            for d in self.layer_order:
                attn = self.blocks[d].attn
                f = attn.attn_func
                if f not in geoms:
                    geoms[f] = ring_geometry(
                        f, t, caches[d]["k"].shape,
                        attn.block_ctx if attn.blocks else None,
                        attn._prime_len if f == 7 else None)
                h = stack_layer_step(dec_params[d], caches[d], h, geoms[f],
                                     self.n_head, plain)
            x = h.reshape(B, 1, S)
        else:
            for d in self.layer_order:
                x = self.blocks[d].decode_step(caches[d], x, t)
        return x if fp16_out else x.float()

    def prefill_chunk(self, caches, x, t0, n_blocks, fp16=False):
        """Prefill the caches with a block-aligned chunk x [B, C, n_in] at
        t0; returns the chunk's output in the compute dtype."""
        if fp16:
            x = x.to(torch.bfloat16)
        for d in self.layer_order:
            x = self.blocks[d].prefill_chunk(caches[d], x, t0, n_blocks)
        return x
