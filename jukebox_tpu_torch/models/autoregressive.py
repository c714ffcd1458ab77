"""Conditional autoregressive transformer over VQ codes (counterpart of
jukebox_tpu/models/autoregressive.py): the teacher-forced forward (also the
training forward, with embedding dropout and the split prime/gen loss), and
token decoding as a host loop over positions with ring caches and sampling
from an explicit torch.Generator.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.ops.core import Table, dropout, filter_logits, fold_seed

LN2 = float(np.log(2.0))


def cross_entropy_bpd(logits, targets):
    """Mean cross-entropy in bits per dim, in fp32."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1)) / LN2


class ConditionalAutoregressive2D(nn.Module):
    """The priors of the 1b_lyrics cascade, with x_emb shared as the output
    projection: y-conditioned (the start token is the label embedding) or,
    with y_cond=False, starting from a learnt start_token; x-conditioned by
    x_cond (the codes of the level above, or the top's timing signal),
    zeros when a caller passes none."""

    def __init__(self, input_shape, bins, width=128, depth=2, heads=1,
                 attn_order=0, blocks=None, m_attn=0.25, m_mlp=1.0,
                 zero_out=False, init_scale=1.0, res_scale=False,
                 prime_len=None, mask=True, attn_dropout=0.0,
                 resid_dropout=0.0, emb_dropout=0.0, checkpoint_res=0,
                 y_cond=True, device=None):
        super().__init__()
        self.input_shape, self.bins, self.width = tuple(input_shape), bins, width
        self.input_dims = int(np.prod(self.input_shape))
        self.blocks = blocks
        self.prime_len, self.emb_dropout = prime_len, emb_dropout
        self.y_cond, self.init_scale = y_cond, init_scale
        if not y_cond:
            self.start_token = nn.Parameter(
                torch.empty((1, width), device=device), requires_grad=False)
        self.x_emb = Table((bins, width), 0.02 * init_scale, device=device)
        self.pos_emb = Table((self.input_dims, width), 0.01 * init_scale,
                             name="pos_emb", device=device)
        self.transformer = Transformer(
            width, self.input_dims, heads, depth, attn_order, blocks,
            prime_len, m_attn, m_mlp, mask, zero_out, init_scale, res_scale,
            attn_dropout, resid_dropout, checkpoint_res, device=device)

    def init_(self, gen):
        if not self.y_cond:
            self.start_token.normal_(0.0, 0.01 * self.init_scale,
                                     generator=gen)

    def start_emb(self, y_cond, n):
        """[n, 1, width]: the label embedding, or the start token."""
        if self.y_cond:
            return y_cond.reshape(n, 1, self.width)
        return self.start_token[None].expand(n, 1, self.width)

    def default_x_cond(self, n):
        return torch.zeros((n, 1, self.width), device=self.x_emb.table.device)

    @property
    def block_ctx(self):
        return self.input_dims // self.blocks if self.blocks else None

    def _logits(self, h):
        return torch.matmul(h.float(), self.x_emb.table.float().t())

    # -- teacher-forced forward -------------------------------------------------

    def forward(self, x, x_cond, y_cond, fp16=False, get_sep_loss=False,
                seed=None, plain=False):
        """x [N, D] tokens -> (loss in bits per dim, logits [N, D, bins]);
        with get_sep_loss the loss is (prime_loss, gen_loss), split at
        prime_len. seed (an int) turns on the training dropouts; plain=True
        runs the flash layers' plain versions."""
        N, D = x.shape
        assert D == self.input_dims
        if x_cond is None:
            x_cond = self.default_x_cond(N)
        emb = self.x_emb.table[x]
        emb = torch.cat([self.start_emb(y_cond, N), emb[:, :-1]], dim=1)
        pos = self.pos_emb.table[None]
        t_seed = seed
        if seed is not None and self.emb_dropout > 0.0:
            # separate token and position dropout (autoregressive.py:147)
            emb = dropout(emb, self.emb_dropout, fold_seed(seed, 0))
            pos = dropout(pos.expand(N, -1, -1), self.emb_dropout,
                          fold_seed(seed, 1))
            t_seed = fold_seed(seed, 2)
        h = emb + pos + x_cond
        h = self.transformer(h, fp16=fp16, seed=t_seed, plain=plain) + x_cond
        logits = self._logits(h)
        if get_sep_loss:
            P = self.prime_len
            loss = (cross_entropy_bpd(logits[:, :P], x[:, :P]),
                    cross_entropy_bpd(logits[:, P:], x[:, P:]))
        else:
            loss = cross_entropy_bpd(logits, x)
        return loss, logits

    # -- incremental decoding pieces -----------------------------------------------

    def _emb_at(self, t, x_tok, x_cond, y_cond, n):
        """Input embedding at position t given the previous token x_tok
        [N, 1] (reference get_emb, autoregressive.py:177-197)."""
        if t == 0:
            emb = self.start_emb(y_cond, n)
        else:
            emb = self.x_emb.table[x_tok]
        cond = x_cond[:, t:t + 1] if x_cond.shape[1] > 1 else x_cond
        return emb + self.pos_emb.table[t:t + 1][None] + cond, cond

    def _decode_one(self, dec_params, caches, x_tok, t, x_cond, y_cond, fp16,
                    n):
        h, cond = self._emb_at(t, x_tok, x_cond, y_cond, n)
        h = self.transformer.decode_step(dec_params, caches, h, t, fp16=fp16)
        return self._logits(h + cond)

    @staticmethod
    def _sample_tok(logits, gen, temp, top_k, top_p):
        """logits [N, 1, bins] -> tokens [N, 1]; temp == 0 is argmax."""
        logits = logits.float()
        if temp == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = filter_logits(logits / temp, top_k=top_k, top_p=top_p)
        probs = torch.softmax(logits[:, 0], dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    @torch.no_grad()
    def sample_segment(self, caches, x_tok, t0, n_steps, gen, x_cond, y_cond,
                       fp16=False, temp=1.0, top_k=0, top_p=0.0,
                       dec_params=None):
        """Decode n_steps tokens from position t0; x_tok [N, 1] is the
        previous token (unused at t == 0). Returns (tokens [N, n_steps],
        x_tok)."""
        N = x_tok.shape[0]
        toks = []
        for t in range(t0, t0 + n_steps):
            logits = self._decode_one(dec_params, caches, x_tok, t, x_cond,
                                      y_cond, fp16, N)
            x_tok = self._sample_tok(logits, gen, temp, top_k, top_p)
            toks.append(x_tok)
        return torch.cat(toks, dim=1), x_tok

    def init_decode_caches(self, n_samples, device, fp16=False):
        dtype = torch.bfloat16 if fp16 else torch.float32
        return self.transformer.init_cache(n_samples, dtype, device)

    @torch.no_grad()
    def prefill(self, caches, x_prime, x_cond, y_cond, fp16=False,
                chunk_size=None, dec_params=None):
        """Fill the caches with positions [0, P) of x_prime [N, P]: whole
        block-aligned chunks through prefill_chunk, the tail token by token
        through decode_step. Returns the last token [N, 1]."""
        N, P = x_prime.shape
        dtype = torch.bfloat16 if fp16 else torch.float32
        emb_in = torch.cat([self.start_emb(y_cond, N).to(dtype),
                            self.x_emb.table[x_prime[:, :-1]].to(dtype)], dim=1)
        conds = (x_cond[:, :P] if x_cond.shape[1] > 1
                 else x_cond.expand(N, P, self.width))
        h_in = (emb_in + self.pos_emb.table[None, :P].to(dtype)
                + conds.to(dtype))
        bc = self.block_ctx
        n_chunk_blocks = max(1, (chunk_size or bc) // bc)
        chunk = n_chunk_blocks * bc
        n_chunks = P // chunk
        for i in range(n_chunks):
            self.transformer.prefill_chunk(
                caches, h_in[:, i * chunk:(i + 1) * chunk], i * chunk,
                n_chunk_blocks, fp16=fp16)
        for t in range(n_chunks * chunk, P):
            self.transformer.decode_step(dec_params, caches, h_in[:, t:t + 1],
                                         t, fp16=fp16)
        return x_prime[:, -1:].long()
