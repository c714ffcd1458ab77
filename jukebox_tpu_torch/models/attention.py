"""Factored (sparse) attention of the PyTorch port (counterpart of
jukebox_tpu/models/attention.py), for the attention patterns of the
1b_lyrics, 5b and 5b_lyrics cascades:
    0 dense      attend to all previous positions
    1 row        attend within your block of the [blocks, block_ctx] grid
    2 column     attend to the same column of previous blocks
    3 prev-row   attend to the whole previous block
    4 summary    attend to the last position of each previous block
    5 summary-spread  attend to the last `spread` positions of each
                 previous block (the full-context forward only: the JAX
                 package does not sample it either)
    6 cross      attend to the lyric encoder's K/V (q-only c_attn, the
                 encoder projected by c_enc_kv)
    7 prime      attend to the first _prime_len positions (lyric prefix)

Three modes: the full-context forward (also the training forward, with
attention and residual dropout), one-token `decode_step` against a ring
cache, and block-aligned `prefill_chunk`. In the full-context forward a
masked dense (f0) layer of at least _FLASH_MIN_CTX positions in bf16 that
does not record its weights runs the flash kernels (ops/flash_attention.py),
under the JAX package's condition (attention.py:254) without its backend
test; every other pattern runs dense_attn, as the JAX package leaves them
to XLA. Any layer can record its softmax weights (the lyric alignment).
Caches keep the standard layout [B, slots, A] with the JAX package's
per-pattern retention:
    f0 [B, n_ctx, A]   f1 [B, bc, A]   f2 [B, bc, blocks, A]
    f3 [B, 2bc, A]     f4 [B, blocks + 1, A]   f7 [B, _prime_len, A]
and are updated in place (the JAX functions return new caches instead);
an f6 layer's cache is the encoder K/V [B, encoder_dims, A], projected once
per window by init_cache and only read. decode_step reads a step's
positions as device tensors (StepIndex.positions: the decode loop's host
int t, or a position a CUDA graph of the fp32 decode step advances on the
device, so that one capture replays at any t). prefill_chunk takes the layer's staged decode
params (Transformer.prepare_decode_params) when they are int8, and then
runs its products as the JAX package's int8 dense does. Against an int8
cache ({"k", "v"} int8 with {"ks", "vs"} row scales) prefill_chunk writes
each chunk's rows quantised (quantize_rows) and reads cache rows back
dequantised to the activation dtype, as the JAX package's kernel-cache
prefill does (attention.py _prefill_chunk_kernel): no bf16 copy of the
cache exists.
"""

import math

import torch
import torch.nn as nn

from jukebox_tpu_torch.ops.core import Dense, dense_any, dropout, fold_seed
from jukebox_tpu_torch.ops.decode_stack import quantize_rows
from jukebox_tpu_torch.ops.flash_attention import flash_dense_attn
from jukebox_tpu_torch.parallel.dist import (copy_to_group, gather_from_group,
                                             reduce_from_group,
                                             scatter_to_group)

NEG = -1e9
_FLASH_MIN_CTX = 2048


def split_heads(x, n_head):
    B, L, D = x.shape
    return x.reshape(B, L, n_head, D // n_head).transpose(1, 2)


def merge_heads(x):
    B, H, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, H * hd)


def causal_mask(q_l, kv_l, device):
    return torch.tril(torch.ones((q_l, kv_l), device=device))


def summary_mask(q_l, blocks, spread, device):
    """[q_l, blocks * spread]: query i attends the zero pad and the
    summaries of the blocks it has passed (jukebox_tpu attention.py
    _summary_mask)."""
    bc = q_l // blocks
    tril = torch.tril(torch.ones((q_l, q_l), device=device))
    m = tril.reshape(q_l, blocks, bc)[:, :-1, -spread:]
    m = torch.cat([torch.ones_like(m[:, :1]), m], dim=1)
    return m.reshape(q_l, blocks * spread)


class StepIndex:
    """The position of a token step as a device tensor t [1], advanced by
    one on the device (advance), and the cache positions every attention
    pattern derives from it (positions), which decode_step reads: the form
    in which a CUDA graph captured for one step replays for the next
    (models/autoregressive.py DecodeGraph). block_ctx, blocks and
    prime_len are the transformer's (None where it has no such layer)."""

    def __init__(self, t, device, block_ctx=None, blocks=None,
                 prime_len=None):
        self.t = torch.full((1,), int(t), dtype=torch.long, device=device)
        self.bc, self.blocks, self.prime_len = block_ctx, blocks, prime_len

    def advance(self):
        self.t.add_(1)

    def positions(self):
        """{"t", and where defined: "mod" (t % bc), "div" (t // bc), "f2"
        (the column cache's flat slot), "f3" (the ring slot written),
        "f3_prev" (the previous ring's first slot), "f4" (the summary row
        1 + t // bc), "f4_keep" (t % bc == bc - 1: the block's last token,
        whose k, v become its summary), "f4_hi" (the last summary row read,
        min((t + 1) // bc, blocks - 1)), "f7" (min(t, prime_len - 1)),
        "f7_keep" (t < prime_len)}, each a [1] tensor."""
        t = self.t
        out = {"t": t}
        if self.bc:
            bc = self.bc
            mod = torch.remainder(t, bc)
            div = torch.div(t, bc, rounding_mode="floor")
            out.update(mod=mod, div=div, f2=mod * self.blocks + div,
                       f3=torch.remainder(div, 2) * bc + mod,
                       f3_prev=torch.remainder(div - 1, 2) * bc,
                       f4=div + 1, f4_keep=mod == bc - 1,
                       f4_hi=torch.clamp(
                           torch.div(t + 1, bc, rounding_mode="floor"),
                           max=self.blocks - 1))
        if self.prime_len:
            out.update(f7=torch.clamp(t, max=self.prime_len - 1),
                       f7_keep=t < self.prime_len)
        return out


def dense_attn(q, k, v, n_head, mask=None, dropout_rate=0.0,
               dropout_seed=None, record=False, heads=None):
    """q, k, v [B, L, n_state]; mask None, "causal" or a float [Lq, Lkv]
    tensor (1 = attend). The reference's fused q*s @ k*s scale with
    s = hd^-1/4 in the activation dtype, fp32 scores and softmax, dropout of
    the softmax weights (training; heads: ops/core.py dropout's, for a rank
    holding some of the heads), and the weights cast to the activation
    dtype before the PV product. record=True returns (out, w): w the fp32
    softmax weights [B, H, Lq, Lkv], taken before the dropout."""
    hd = q.shape[-1] // n_head
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(hd)), dtype=q.dtype)
    qh = split_heads(q, n_head) * scale
    kh = split_heads(k, n_head) * scale
    vh = split_heads(v, n_head)
    w = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if isinstance(mask, str):
        lq, lk = w.shape[-2:]
        keep = torch.ones((lq, lk), dtype=torch.bool, device=w.device).tril()
        w = torch.where(keep, w, torch.full_like(w, NEG))
    elif mask is not None:
        w = w * mask + NEG * (1 - mask)
    w = torch.softmax(w, dim=-1)
    out = merge_heads(torch.matmul(
        dropout(w, dropout_rate, dropout_seed, heads).to(q.dtype), vh))
    return (out, w) if record else out


class FactoredAttention(nn.Module):
    def __init__(self, n_in, n_ctx, n_state, n_head, attn_func=0, blocks=None,
                 prime_len=None, mask=False, zero_out=False, init_scale=1.0,
                 attn_dropout=0.0, resid_dropout=0.0, encoder_dims=None,
                 spread=None, device=None):
        super().__init__()
        if attn_func not in range(8):
            raise NotImplementedError(f"attn_func {attn_func} is not ported")
        if attn_func == 5 and not spread:
            raise ValueError("the summary-spread pattern (5) needs spread")
        assert n_state % n_head == 0
        if blocks is not None:
            assert n_ctx % blocks == 0
        self.n_ctx, self.n_state, self.n_head = n_ctx, n_state, n_head
        self.attn_func, self.blocks, self.prime_len = attn_func, blocks, prime_len
        self.encoder_dims, self.spread = encoder_dims, spread
        self.mask = mask
        # the "mp" group of a Megatron split (parallel/placement.py), which
        # leaves this module n_head / mp heads of n_state / mp columns
        # (heads: its first head and the whole layer's, for the dropout
        # masks), or, where mp does not divide n_head, its columns of the
        # products and the attention whole (whole: q, k, v gathered, the
        # output's columns scattered back)
        self.tp, self.heads, self.whole = None, None, False
        self.attn_dropout, self.resid_dropout = attn_dropout, resid_dropout
        if attn_func == 6:
            self.c_attn = Dense(n_in, n_state, init_scale, device=device)
            self.c_enc_kv = Dense(n_in, n_state * 2, init_scale,
                                  device=device)
        else:
            self.c_attn = Dense(n_in, n_state * 3, init_scale, device=device)
        self.c_proj = Dense(n_state, n_in, init_scale, zero_out, device=device)

    @property
    def block_ctx(self):
        return self.n_ctx // self.blocks

    @property
    def _prime_len(self):
        """Block-aligned prime cache length (factored_attention.py:303-308)."""
        return (self.prime_len // self.blocks + 1) * self.blocks

    @staticmethod
    def _lin(mod, x, p):
        """mod(x), or the int8 dense of the staged dict p when given."""
        return mod(x) if p is None else dense_any(x, p)

    def _whole(self, y, parts):
        """y, the rank's columns of a split product of `parts` equal parts,
        gathered whole where the attention runs whole on every rank."""
        return gather_from_group(y, self.tp, parts) if self.whole else y

    def _qkv(self, x, encoder_kv=None, p=None):
        x = copy_to_group(x, self.tp)
        if self.attn_func == 6:
            q = self._whole(self._lin(self.c_attn, x, p), 1)
            enc = copy_to_group(encoder_kv.to(x.dtype), self.tp)
            k, v = self._whole(self.c_enc_kv(enc), 2).chunk(2, dim=2)
            return q, k, v
        return self._whole(self._lin(self.c_attn, x, p), 3).chunk(3, dim=2)

    def _out(self, a, p=None):
        """c_proj of the heads' output a (p: its int8 staged dict); split
        over "mp", the rows' partial products summed over the group before
        the bias (a staged dict's bias is then zero), each rank's rows
        reading its columns of a whole attention's output."""
        if self.tp is None:
            return self._lin(self.c_proj, a, p)
        if self.whole:
            a = scatter_to_group(a, self.tp)
        y = (torch.matmul(a, self.c_proj.w.to(a.dtype)) if p is None
             else dense_any(a, p))
        y = reduce_from_group(y, self.tp)
        return y + self.c_proj.b.to(y.dtype)

    # -- full-context forward -------------------------------------------------

    def forward(self, x, seed=None, plain=False, encoder_kv=None,
                record=False):
        """x [B, L, n_in] with L == n_ctx -> [B, L, n_in]; encoder_kv
        [B, encoder_dims, n_in] feeds the f6 layers. seed (an int) turns on
        the training dropouts; plain=True runs the flash layers' plain
        versions (the reference a kernel run is held against). record=True
        returns (out, w): w the fp32 softmax weights [B, H, Lq, Lkv], an f7
        layer's cut to music queries x lyric keys
        (factored_attention.py:101-105)."""
        q, k, v = self._qkv(x, encoder_kv)
        s_attn, s_resid = ((fold_seed(seed, 0), fold_seed(seed, 1))
                           if seed is not None else (None, None))
        a = self._pattern_full(q, k, v, s_attn, plain, record)
        if not record:
            return dropout(self._out(a), self.resid_dropout, s_resid)
        a, w = a
        if self.attn_func == 7:
            w = w[:, :, self.prime_len:, :self.prime_len]
        return dropout(self._out(a), self.resid_dropout, s_resid), w

    def uses_flash(self, L, dtype, record=False):
        """The f0 dispatch of jukebox_tpu's _pattern_full (attention.py:254)
        with the backend test dropped: flash_dense_attn runs its plain
        version on the CPU. A recorded layer runs dense_attn."""
        return (self.attn_func == 0 and self.mask and not record
                and L >= _FLASH_MIN_CTX and dtype == torch.bfloat16)

    def _pattern_full(self, q, k, v, seed=None, plain=False, record=False):
        """The pattern's attention [B, L, S]; record=True: (out, w), w the
        softmax weights."""
        f = self.attn_func
        B, L, S = v.shape
        rate = self.attn_dropout if seed is not None else 0.0

        def attn(q_, k_, v_, mask):
            out = dense_attn(q_, k_, v_, self.n_head, mask, rate, seed,
                             record, self.heads)
            return out if record else (out, None)

        def done(a, w):
            return (a, w) if record else a
        if f == 0:
            if self.uses_flash(L, q.dtype, record):
                return flash_dense_attn(q, k, v, self.n_head, rate, seed,
                                        plain, self.heads)
            return done(*attn(q, k, v, "causal" if self.mask else None))
        bc = self.block_ctx
        if f == 1:
            mask = causal_mask(bc, bc, q.device) if self.mask else None
            a, w = attn(q.reshape(-1, bc, S), k.reshape(-1, bc, S),
                        v.reshape(-1, bc, S), mask)
            return done(a.reshape(B, L, S), w)
        if f == 2:
            nb = L // bc
            mask = causal_mask(nb, nb, q.device) if self.mask else None

            def t_(x):
                return x.reshape(B, nb, bc, S).transpose(1, 2).reshape(
                    B * bc, nb, S)
            a, w = attn(t_(q), t_(k), t_(v), mask)
            return done(
                a.reshape(B, bc, nb, S).transpose(1, 2).reshape(B, L, S), w)
        if f == 3:
            nb = L // bc

            def shift(x):
                xb = x.reshape(B, nb, bc, S)
                return torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]],
                                 dim=1).reshape(B * nb, bc, S)
            a, w = attn(q.reshape(B * nb, bc, S), shift(k), shift(v), None)
            return done(a.reshape(B, L, S), w)
        if f in (4, 5):
            blocks = self.blocks
            spread = 1 if f == 4 else self.spread

            def summarize(x):
                xb = x.reshape(B, blocks, L // blocks, S)[:, :-1, -spread:]
                xb = torch.cat([torch.zeros_like(xb[:, :1]), xb], dim=1)
                return xb.reshape(B, blocks * spread, S)
            mask = (summary_mask(L, blocks, spread, q.device) if self.mask
                    else None)
            return done(*attn(q, summarize(k), summarize(v), mask))
        if f == 6:
            return done(*attn(q, k, v, None))
        pl_ = self._prime_len  # f == 7
        return done(*attn(q, k[:, :pl_], v[:, :pl_],
                          "causal" if self.mask else None))

    # -- ring caches ----------------------------------------------------------

    def cache_shape(self, bs):
        f, A = self.attn_func, self.n_state
        if f == 5:
            raise NotImplementedError(
                "attn_func 5: summary-spread sampling is not implemented "
                "(as in the JAX package and the reference, "
                "factored_attention.py:211)")
        if f == 0:
            return (bs, self.n_ctx, A)
        if f == 1:
            return (bs, self.block_ctx, A)
        if f == 2:
            return (bs, self.block_ctx, self.blocks, A)
        if f == 3:
            return (bs, 2 * self.block_ctx, A)
        if f == 4:  # the zero pad, then one summary a block
            return (bs, self.blocks + 1, A)
        if f == 6:
            return (bs, self.encoder_dims, A)
        return (bs, self._prime_len, A)

    def init_cache(self, bs, dtype, device, encoder_kv=None, enc_kv=None):
        """Zero ring caches; an f6 layer's holds encoder_kv projected by
        c_enc_kv (or by enc_kv, its staged decode form) in `dtype`."""
        if self.attn_func == 6:
            kv = (self.c_enc_kv(encoder_kv.to(dtype)) if enc_kv is None
                  else dense_any(encoder_kv.to(dtype), enc_kv))
            k, v = self._whole(kv, 2).chunk(2, dim=2)
            return {"k": k.contiguous(), "v": v.contiguous()}
        shape = self.cache_shape(bs)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def step_index(self, t, device, prime=False):
        """A StepIndex at position t (a host int) with this layer's block
        geometry, and its f7 prime length where prime."""
        return StepIndex(t, device, self.block_ctx if self.blocks else None,
                         self.blocks, self._prime_len if prime else None)

    def decode_step(self, cache, x, pos):
        """One token x [B, 1, n_in] at the step's positions pos (a
        StepIndex's positions: device tensors; or a host int t, whose
        positions it derives) -> [B, 1, n_in]. Writes the token's k, v into
        the ring cache in place and reads, per pattern:
          f0 dense  write t, read 0..t
          f1 row    write t % bc, read 0..t % bc
          f2 column write (t % bc, t // bc), read column t % bc, blocks
                    0..t // bc
          f3 prev   write ring (t // bc) % 2 slot t % bc, read the whole
                    previous ring ((t // bc) - 1) % 2 unmasked (in the
                    first block it is still the zero init, so every score
                    is 0 and the output 0)
          f4 summary write row 1 + t // bc at a block's last token (other
                    writes leave the row as it is), read row 0 (the zero
                    pad) .. min((t + 1) // bc, blocks - 1): at a block's
                    last token its own summary, the last block's never
          f6 cross  no write, read the encoder K/V
          f7 prime  write t while t < _prime_len (later writes leave the
                    row as it is), read 0..min(t, _prime_len - 1)
        Every slice is an index_copy_ / index_select at a device
        position."""
        f = self.attn_func
        if f == 6:
            q = self._whole(self.c_attn(x), 1)
            return self._out(dense_attn(q, cache["k"], cache["v"],
                                        self.n_head))
        if not isinstance(pos, dict):
            pos = self.step_index(pos, x.device, f == 7).positions()
        q, k, v = self._qkv(x)
        kc, vc = cache["k"], cache["v"]
        dev = x.device
        if f == 2:
            B, A = kc.shape[0], kc.shape[-1]
            for c, new in ((kc, k), (vc, v)):
                c.view(B, -1, A).index_copy_(1, pos["f2"], new)
            kc = kc.index_select(1, pos["mod"])[:, 0]
            vc = vc.index_select(1, pos["mod"])[:, 0]
            mask = (torch.arange(self.blocks, device=dev)
                    <= pos["div"]).float()[None]
        elif f in (4, 7):
            row, keep = pos[f"f{f}"], pos[f"f{f}_keep"]
            for c, new in ((kc, k), (vc, v)):
                # writes past the prime, or inside a block, leave the row
                # as it is
                c.index_copy_(1, row, torch.where(keep, new,
                                                  c.index_select(1, row)))
            hi = pos["f4_hi"] if f == 4 else row
            mask = (torch.arange(kc.shape[1], device=dev)
                    <= hi).float()[None]
        else:
            slot = {0: pos["t"], 1: pos["mod"], 3: pos["f3"]}[f]
            for c, new in ((kc, k), (vc, v)):
                c.index_copy_(1, slot, new)
            if f == 0:
                mask = (torch.arange(kc.shape[1], device=dev)
                        <= pos["t"]).float()[None]
            elif f == 1:
                mask = (torch.arange(self.block_ctx, device=dev)
                        <= pos["mod"]).float()[None]
            else:
                rows = pos["f3_prev"] + torch.arange(self.block_ctx,
                                                     device=dev)
                kc, vc = kc.index_select(1, rows), vc.index_select(1, rows)
                mask = None
        return self._out(dense_attn(q, kc, vc, self.n_head, mask))

    @staticmethod
    def _put(cache, idx, k, v):
        """cache[key][idx] = k, v in place; an int8 cache stores the rows
        quantised from their values in the activation dtype (absmax / 127
        floored at 1e-8, round(x / s)) and their bf16 scales."""
        if "ks" not in cache:
            cache["k"][idx] = k
            cache["v"][idx] = v
            return
        (cache["k"][idx], cache["ks"][idx]) = quantize_rows(k)
        (cache["v"][idx], cache["vs"][idx]) = quantize_rows(v)

    @staticmethod
    def _read(cache, key, idx, dtype):
        """cache[key][idx], dequantised to `dtype` when int8."""
        c = cache[key][idx]
        if "ks" not in cache:
            return c
        s = cache[key + "s"][idx]
        return (c.float() * s.float()[..., None]).to(dtype)

    def prefill_chunk(self, cache, x, t0, n_blocks, p=None):
        """Prefill a block-aligned chunk x [B, C, n_in] starting at t0 (a
        multiple of block_ctx; any C for f0/f6/f7) -> [B, C, n_in]. p: the
        layer's int8 staged decode params, whose products then replace the
        module's."""
        f = self.attn_func

        def proj(a):
            return self._out(a, None if p is None else p["proj"])
        qp = None if p is None else p["qkv"]
        everything = (slice(None),)

        def read(key, idx=everything):
            return self._read(cache, key, idx, x.dtype)
        if f == 6:
            q = self._whole(self._lin(self.c_attn, x, qp), 1)
            return proj(dense_attn(q, read("k"), read("v"), self.n_head))
        q, k, v = self._qkv(x, p=qp)
        B, C, S = v.shape
        dev = x.device
        if f == 0:
            self._put(cache, (slice(None), slice(t0, t0 + C)), k, v)
            L = cache["k"].shape[1]
            mask = (torch.arange(L, device=dev)[None, :]
                    <= (t0 + torch.arange(C, device=dev))[:, None]).float()
            a = dense_attn(q, read("k"), read("v"), self.n_head, mask)
            return proj(a)
        bc = self.block_ctx
        if f == 1:
            assert C == n_blocks * bc
            a = dense_attn(q.reshape(-1, bc, S), k.reshape(-1, bc, S),
                           v.reshape(-1, bc, S), self.n_head,
                           causal_mask(bc, bc, dev))
            self._put(cache, everything, k[:, -bc:], v[:, -bc:])
            return proj(a.reshape(B, C, S))
        if f == 2:
            assert C == n_blocks * bc
            b0 = t0 // bc
            cols = (slice(None), slice(None), slice(b0, b0 + n_blocks))
            self._put(cache, cols,
                      k.reshape(B, n_blocks, bc, S).transpose(1, 2),
                      v.reshape(B, n_blocks, bc, S).transpose(1, 2))
            qc = q.reshape(B, n_blocks, bc, S).transpose(1, 2)
            mask = (torch.arange(self.blocks, device=dev)[None, :]
                    <= (b0 + torch.arange(n_blocks, device=dev))[:, None]).float()
            a = dense_attn(qc.reshape(B * bc, n_blocks, S),
                           read("k").reshape(B * bc, self.blocks, S),
                           read("v").reshape(B * bc, self.blocks, S),
                           self.n_head, mask)
            a = a.reshape(B, bc, n_blocks, S).transpose(1, 2).reshape(B, C, S)
            return proj(a)
        if f == 3:
            assert C == n_blocks * bc
            b0 = t0 // bc
            prev = (b0 - 1) % 2
            kb, vb = k.reshape(B, n_blocks, bc, S), v.reshape(B, n_blocks, bc, S)
            ring = (slice(None), slice(prev * bc, (prev + 1) * bc))
            pk, pv = read("k", ring), read("v", ring)
            k_shift = torch.cat([pk[:, None], kb[:, :-1]], dim=1)
            v_shift = torch.cat([pv[:, None], vb[:, :-1]], dim=1)
            a = dense_attn(q.reshape(B * n_blocks, bc, S),
                           k_shift.reshape(B * n_blocks, bc, S),
                           v_shift.reshape(B * n_blocks, bc, S), self.n_head)
            # the double buffer keeps the chunk's last two blocks
            for back in range(min(n_blocks, 2)):
                ring = (b0 + n_blocks - 1 - back) % 2
                rows = (slice(None), slice(ring * bc, (ring + 1) * bc))
                self._put(cache, rows, kb[:, -1 - back], vb[:, -1 - back])
            return proj(a.reshape(B, C, S))
        if f == 4:
            assert C == n_blocks * bc
            b0 = t0 // bc
            # each chunk block's last token is its summary, at row 1 + block
            rows = (slice(None), slice(1 + b0, 1 + b0 + n_blocks))
            self._put(cache, rows, k.reshape(B, n_blocks, bc, S)[:, :, -1],
                      v.reshape(B, n_blocks, bc, S)[:, :, -1])
            hi = torch.clamp(
                torch.div(t0 + torch.arange(C, device=dev) + 1, bc,
                          rounding_mode="floor"), max=self.blocks - 1)
            mask = (torch.arange(self.blocks + 1, device=dev)[None, :]
                    <= hi[:, None]).float()
            return proj(dense_attn(q, read("k"), read("v"), self.n_head,
                                   mask))
        pl_ = self._prime_len  # f == 7
        pos = t0 + torch.arange(C, device=dev)
        n_in = max(0, min(C, pl_ - t0))  # chunk rows inside the prime cache
        if n_in:
            self._put(cache, (slice(None), slice(t0, t0 + n_in)),
                      k[:, :n_in], v[:, :n_in])
        mask = (torch.arange(pl_, device=dev)[None, :]
                <= torch.clamp(pos, max=pl_ - 1)[:, None]).float()
        a = dense_attn(q, read("k"), read("v"), self.n_head, mask)
        return proj(a)

