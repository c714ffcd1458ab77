"""Conditional autoregressive transformer over VQ codes (counterpart of
jukebox_tpu/models/autoregressive.py): the teacher-forced forward (also the
training forward, with embedding dropout and the split prime/gen loss), and
token decoding as a host loop over positions with ring caches and sampling
from an explicit torch.Generator. On the card the fp32 decode (the layer
modules, as the in-training sample runs it) replays one CUDA graph a token
(DecodeGraph), as the JAX package runs its fp32 decode jitted.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jukebox_tpu_torch.models.attention import StepIndex
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.core import Table, dropout, filter_logits, fold_seed
from jukebox_tpu_torch.utils import profiler

LN2 = float(np.log(2.0))


def cross_entropy_bpd(logits, targets):
    """Mean cross-entropy in bits per dim, in fp32."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1)) / LN2


class ConditionalAutoregressive2D(nn.Module):
    """The priors of the 1b_lyrics, 5b and 5b_lyrics cascades:
    y-conditioned (the start token is the label embedding) or, with
    y_cond=False, starting from a learnt start_token; x-conditioned by
    x_cond (the codes of the level above, or the top's timing signal),
    zeros when a caller passes none. x_emb is shared as the output
    projection, except with merged_decoder (the 5b priors): then x_out is
    its own and x_cond is not added after the transformer. only_encode
    (the 5b_lyrics lyric encoder) returns the activations instead of
    logits; encoder_dims > 0 gives the f6 layers an encoder_kv to read."""

    def __init__(self, input_shape, bins, width=128, depth=2, heads=1,
                 attn_order=0, blocks=None, m_attn=0.25, m_mlp=1.0,
                 zero_out=False, init_scale=1.0, res_scale=False,
                 prime_len=None, mask=True, attn_dropout=0.0,
                 resid_dropout=0.0, emb_dropout=0.0, checkpoint_res=0,
                 checkpoint_attn=0, checkpoint_mlp=0, y_cond=True,
                 encoder_dims=0, only_encode=False, merged_decoder=False,
                 spread=None, device=None):
        super().__init__()
        self.input_shape, self.bins, self.width = tuple(input_shape), bins, width
        self.input_dims = int(np.prod(self.input_shape))
        self.blocks = blocks
        self.prime_len, self.emb_dropout = prime_len, emb_dropout
        self.y_cond, self.init_scale = y_cond, init_scale
        self.only_encode = only_encode
        # merged 5b checkpoints depend on both (autoregressive.py:87-93)
        self.add_cond_after_transformer = not merged_decoder
        self.share_x_emb_x_out = not merged_decoder
        if not y_cond:
            self.start_token = nn.Parameter(
                torch.empty((1, width), device=device), requires_grad=False)
        self.x_emb = Table((bins, width), 0.02 * init_scale, device=device)
        self.pos_emb = Table((self.input_dims, width), 0.01 * init_scale,
                             name="pos_emb", device=device)
        self.transformer = Transformer(
            width, self.input_dims, heads, depth, attn_order, blocks,
            prime_len, m_attn, m_mlp, mask, zero_out, init_scale, res_scale,
            attn_dropout, resid_dropout, checkpoint_res,
            encoder_dims or None, checkpoint_attn=checkpoint_attn,
            checkpoint_mlp=checkpoint_mlp, spread=spread, device=device)
        if not only_encode and not self.share_x_emb_x_out:
            self.x_out = Table((width, bins), 0.0, name="w",
                               bound=1.0 / np.sqrt(width), device=device)

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
        w = (self.x_emb.table.t() if self.share_x_emb_x_out
             else self.x_out.table)
        return torch.matmul(h.float(), w.float())

    # -- teacher-forced forward -------------------------------------------------

    def forward(self, x, x_cond, y_cond, fp16=False, get_sep_loss=False,
                seed=None, plain=False, encoder_kv=None,
                record_layers=frozenset()):
        """x [N, D] tokens -> (loss in bits per dim, logits [N, D, bins]);
        with get_sep_loss the loss is (prime_loss, gen_loss), split at
        prime_len; only_encode returns the activations [N, D, width]
        alone. encoder_kv feeds the f6 layers. seed (an int) turns on the
        training dropouts; plain=True runs the flash layers' plain
        versions. With record_layers the recorded softmax weights ws
        follow: (loss, logits, ws), or (activations, ws) under
        only_encode."""
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
        h, ws = self.transformer(h, fp16=fp16, seed=t_seed, plain=plain,
                                 encoder_kv=encoder_kv,
                                 record_layers=record_layers)
        if self.add_cond_after_transformer:
            h = h + x_cond
        if self.only_encode:
            return (h, ws) if record_layers else h
        logits = self._logits(h)
        if get_sep_loss:
            P = self.prime_len
            loss = (cross_entropy_bpd(logits[:, :P], x[:, :P]),
                    cross_entropy_bpd(logits[:, P:], x[:, P:]))
        else:
            loss = cross_entropy_bpd(logits, x)
        return (loss, logits, ws) if record_layers else (loss, logits)

    # -- incremental decoding pieces -----------------------------------------------

    def _emb_at(self, t, x_tok, x_cond, y_cond, n):
        """Input embedding at position t given the previous token x_tok
        [N, 1] (reference get_emb, autoregressive.py:177-197); t a host
        int, or a StepIndex at t >= 1 (read on the device)."""
        on_device = isinstance(t, StepIndex)
        if not on_device and t == 0:
            emb = self.start_emb(y_cond, n)
        else:
            emb = self.x_emb.table[x_tok]

        def at(a, dim):
            return (a.index_select(dim, t.t) if on_device
                    else a.narrow(dim, t, 1))
        cond = at(x_cond, 1) if x_cond.shape[1] > 1 else x_cond
        return emb + at(self.pos_emb.table, 0)[None] + cond, cond

    def _decode_one(self, dec_params, caches, x_tok, t, x_cond, y_cond, fp16,
                    n):
        """Logits [N, 1, bins] at position t (a host int; a StepIndex for
        the layer modules alone) given the previous token x_tok."""
        h, cond = self._emb_at(t, x_tok, x_cond, y_cond, n)
        with profiler.fine("sample.layers"):
            h = self.transformer.decode_step(dec_params, caches, h, t,
                                             fp16=fp16)
        if self.add_cond_after_transformer:
            h = h + cond
        return self._logits(h)

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
        x_tok). The fp32 layer-module decode (no dec_params) runs its
        steps from t = max(t0, 1) through a DecodeGraph when
        DecodeGraph.wanted says so, op by op under a Megatron split (its
        all-reduces are not captured). Spans (utils/profiler.py): the
        coarse sample.segment (its calls count the loop's progress); per
        token the fine sample.step, around sample.layers (the layers'
        decode_step in _decode_one; a graph's replay runs them without the
        host and has none) and sample.tok (the token sampler); the
        embedding and logits are the step's self time."""
        N = x_tok.shape[0]
        toks = []
        graph = None
        with profiler.span("sample.segment", rows=N, steps=n_steps, t0=t0):
            for t in range(t0, t0 + n_steps):
                if (graph is None and t >= 1 and dec_params is None
                        and not fp16 and self.transformer.tp is None
                        and DecodeGraph.wanted(x_tok.device,
                                               t0 + n_steps - t)):
                    graph = DecodeGraph(self, caches, t, x_cond, y_cond, N)
                with profiler.fine("sample.step"):
                    if graph is not None:
                        logits = graph.step(x_tok)
                    else:
                        logits = self._decode_one(dec_params, caches, x_tok,
                                                  t, x_cond, y_cond, fp16, N)
                    with profiler.fine("sample.tok"):
                        x_tok = self._sample_tok(logits, gen, temp, top_k,
                                                 top_p)
                toks.append(x_tok)
            return torch.cat(toks, dim=1), x_tok

    def init_decode_caches(self, n_samples, device, fp16=False,
                           encoder_kv=None, dec_params=None, int8=False):
        dtype = torch.bfloat16 if fp16 else torch.float32
        return self.transformer.init_cache(n_samples, dtype, device,
                                           encoder_kv, dec_params, int8)

    @torch.no_grad()
    def prefill(self, caches, x_prime, x_cond, y_cond, fp16=False,
                chunk_size=None, dec_params=None):
        """Fill the caches with positions [0, P) of x_prime [N, P]: whole
        block-aligned chunks through prefill_chunk (into bf16, fp32 or int8
        caches: int8 ones take each chunk's rows quantised), the tail token
        by token through decode_step (the coarse span
        sample.prefill_tail). Returns the last token [N, 1]."""
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
                n_chunk_blocks, fp16=fp16, dec_params=dec_params)
        with profiler.span("sample.prefill_tail", tokens=P - n_chunks * chunk):
            for t in range(n_chunks * chunk, P):
                self.transformer.decode_step(dec_params, caches,
                                             h_in[:, t:t + 1], t, fp16=fp16)
        return x_prime[:, -1:].long()


# a DecodeGraph's captures and replays. A replay runs the kernel launches
# its capture recorded without calling their wrappers, so the wrappers'
# launch counts hold each capture's once and no replay; these count the
# replays apart.
GRAPHS = {"captures": 0, "replays": 0}


def reset_graph_counts():
    for k in GRAPHS:
        GRAPHS[k] = 0


class DecodeGraph:
    """The fp32 layer-module decode of one token (_decode_one at a
    StepIndex, which then advances) for a window whose caches stay put, as
    one CUDA graph replayed a token. The first step runs op by op on a side
    stream (the warm-up CUDA graphs need) and is a real step: its cache
    writes and logits stand; the capture after it runs nothing, and each
    replay runs the next position (the graph advances its own StepIndex).
    The card alone: wanted says when."""

    def __init__(self, model, caches, t, x_cond, y_cond, n):
        device = x_cond.device
        self.pos = model.transformer.step_index(t, device)
        self.tok = torch.zeros((n, 1), dtype=torch.long, device=device)
        self.args = model, caches, x_cond, y_cond, n
        self.graph = self.logits = None

    @staticmethod
    def wanted(device, n_steps):
        """A graph for n_steps >= 2 on the card; op by op on the CPU."""
        return n_steps >= 2 and torch.device(device).type == "cuda"

    def run(self):
        """The step op by op: logits [N, 1, bins] at self.pos given the
        previous token self.tok; then self.pos advances."""
        model, caches, x_cond, y_cond, n = self.args
        logits = model._decode_one(None, caches, self.tok, self.pos, x_cond,
                                   y_cond, False, n)
        self.pos.advance()
        return logits

    def step(self, x_tok):
        """Logits [N, 1, bins] of the next position given the previous
        token x_tok [N, 1]."""
        self.tok.copy_(x_tok)
        if self.graph is not None:
            self.graph.replay()
            _build.count(GRAPHS, "replays")
            return self.logits
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self.run()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self.run()
        _build.count(GRAPHS, "captures")
        return first
