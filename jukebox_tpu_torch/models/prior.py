"""Per-level prior over VQ codes (counterpart of jukebox_tpu/models/prior.py),
for the priors of the 1b_lyrics, 5b and 5b_lyrics cascades. Lyrics reach a
top prior one of two ways: the 1b_lyrics top merges the lyric and VQ
vocabularies and sequences into one stream (single_enc_dec); the 5b_lyrics
top runs a separate lyric encoder (prime_prior, an only_encode
autoregressive transformer) whose activations, projected and normalised
(prime_state_proj, prime_state_ln), are the encoder_kv its f6 layers
cross-attend. The upsamplers are conditioned on the codes of the level
above through a Conditioner. Host-side label bookkeeping (get_y /
get_z_conds) is numpy. z_forward is the training loss: the prime (lyric)
and gen (code) losses weighted by prime_loss_fraction and their share of
the stream.
"""

import numpy as np
import torch
import torch.nn as nn

from jukebox_tpu_torch.data.labels import EmptyLabeller, Labeller
from jukebox_tpu_torch.models.autoregressive import (
    ConditionalAutoregressive2D, cross_entropy_bpd)
from jukebox_tpu_torch.models.conditioners import Conditioner, LabelConditioner
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.vqvae import calculate_strides
from jukebox_tpu_torch.ops.core import Dense, LayerNorm, Table, fold_seed
from jukebox_tpu_torch.utils import profiler


class SimplePrior(nn.Module):
    def __init__(self, z_shapes, l_bins, level, downs_t, strides_t,
                 prior_kwargs, x_cond_kwargs, y_cond_kwargs, prime_kwargs,
                 labels=True, labels_v3=False, single_enc_dec=False,
                 merged_decoder=False, copy_input=False, device=None):
        super().__init__()
        prior_kwargs = dict(prior_kwargs)
        prime_kwargs = dict(prime_kwargs)
        use_tokens = prime_kwargs.pop("use_tokens")
        self.n_tokens = prime_kwargs.pop("n_tokens")
        self.prime_loss_fraction = prime_kwargs.pop("prime_loss_fraction",
                                                    0.0)
        self.prime_prior = None
        # copy_input: the lyric stream is the window's first n_tokens codes
        # (jukebox_tpu prior.py:62-64, :282-283)
        self.copy_input = copy_input
        if copy_input:
            prime_kwargs["bins"] = l_bins
        self.z_shapes, self.levels = z_shapes, len(z_shapes)
        self.z_shape, self.level, self.l_bins = z_shapes[level], level, l_bins
        self.x_cond = level != self.levels - 1
        self.cond_level = level + 1
        self.y_cond = labels
        self.single_enc_dec = single_enc_dec

        if self.x_cond:
            xk = dict(x_cond_kwargs)
            self.conditioner_blocks = nn.ModuleList([Conditioner(
                z_shapes[self.cond_level], l_bins, downs_t[self.cond_level],
                strides_t[self.cond_level], xk.pop("out_width"),
                xk.pop("init_scale"), BlockCfg(**xk), device=device)])
        if self.y_cond:
            self.y_emb = LabelConditioner(
                n_time=self.z_shape[0], include_time_signal=not self.x_cond,
                device=device, **y_cond_kwargs)

        if single_enc_dec:
            self.prior_shapes = [(self.n_tokens,), prior_kwargs.pop("input_shape")]
            self.prior_bins = [prime_kwargs["bins"], prior_kwargs.pop("bins")]
            self.prior_dims = [int(np.prod(s)) for s in self.prior_shapes]
            self.prior_bins_shift = np.cumsum([0, *self.prior_bins])[:-1]
            self.prior_width = prior_kwargs["width"]
            self.prime_loss_dims, self.gen_loss_dims = self.prior_dims
            self.prior = ConditionalAutoregressive2D(
                input_shape=(sum(self.prior_dims),), bins=sum(self.prior_bins),
                prime_len=self.prime_loss_dims, y_cond=True, device=device,
                **prior_kwargs)
        else:
            self.prime_loss_dims = 0
            if use_tokens and self.n_tokens:
                # the lyric encoder (prior.py:119-137)
                self.prime_loss_dims = self.n_tokens
                width = prior_kwargs["width"]
                self.prime_prior = ConditionalAutoregressive2D(
                    input_shape=(self.n_tokens,), y_cond=False,
                    only_encode=True, device=device, **prime_kwargs)
                self.prime_state_proj = Dense(
                    prime_kwargs["width"], width, prime_kwargs["init_scale"],
                    device=device)
                self.prime_state_ln = LayerNorm(width, device=device)
                self.prime_x_out = Table(
                    (width, prime_kwargs["bins"]),
                    0.02 * prior_kwargs["init_scale"], name="w",
                    device=device)
            self.gen_loss_dims = int(np.prod(self.z_shape))
            self.prior = ConditionalAutoregressive2D(
                y_cond=self.y_cond, encoder_dims=self.prime_loss_dims,
                merged_decoder=merged_decoder, device=device, **prior_kwargs)
        self.total_loss_dims = self.prime_loss_dims + self.gen_loss_dims

        self.n_ctx = self.gen_loss_dims
        self.downsamples = calculate_strides(strides_t, downs_t)
        self.cond_downsample = (self.downsamples[level + 1]
                                if level != self.levels - 1 else None)
        self.raw_to_tokens = int(np.prod(self.downsamples[:level + 1]))
        self.sample_length = self.n_ctx * self.raw_to_tokens
        self.labeller = (Labeller(y_cond_kwargs["max_bow_genre_size"],
                                  self.n_tokens, self.sample_length,
                                  v3=labels_v3)
                         if labels else EmptyLabeller())
        # the lyric alignment's taps (make_prior sets them from hps)
        self.alignment_layer = self.alignment_head = None

    # -- host-side label / window math ------------------------------------------

    def get_y(self, labels, start, get_indices=False):
        """The window's labels at `start`; with get_indices also each
        sample's lyric source indices (-1: padding), None without lyrics."""
        if not self.y_cond:
            return (None, None) if get_indices else None
        y = np.array(labels["y"], dtype=np.int64, copy=True)
        y[:, 2] = int(self.sample_length)
        y[:, 1:2] = y[:, 1:2] + int(start * self.raw_to_tokens)
        indices = self.labeller.set_y_lyric_tokens(y, labels)
        return (y, indices) if get_indices else y

    def get_z_conds(self, zs, start, end):
        if self.level != self.levels - 1:
            assert start % self.cond_downsample == end % self.cond_downsample == 0
            z_cond = zs[self.level + 1][:, start // self.cond_downsample:
                                        end // self.cond_downsample]
            assert z_cond.shape[1] == self.n_ctx // self.cond_downsample
            return [z_cond]
        return None

    # -- merged-stream token shifting (single_enc_dec) -----------------------------

    def prior_preprocess(self, xs, conds):
        N = xs[0].shape[0]
        out_x = [(x + int(self.prior_bins_shift[i])).reshape(N, -1)
                 for i, x in enumerate(xs)]
        out_c = []
        for i, cond in enumerate(conds):
            if cond is None:
                cond = torch.zeros((N, self.prior_dims[i], self.prior_width),
                                   device=xs[0].device)
            out_c.append(cond)
        return torch.cat(out_x, dim=1), torch.cat(out_c, dim=1)

    def prior_postprocess(self, z):
        x = z[:, self.prior_dims[0]:] - int(self.prior_bins_shift[1])
        return x.clamp(min=0)

    # -- conditioning ---------------------------------------------------------------

    def get_cond(self, z_conds, y):
        """Split y into labels | lyrics and build (x_cond, y_cond, prime);
        without labels y is None and so are y_cond and prime, and a top
        prior's x_cond (prior.py:234-244)."""
        y_labels, prime = None, None
        if y is not None:
            n_labels = y.shape[1] - self.n_tokens
            y_labels, prime = y[:, :n_labels], y[:, n_labels:]
        y_cond, y_pos = self.y_emb(y_labels) if self.y_cond else (None, None)
        x_cond = (self.conditioner_blocks[0](z_conds[0]) if self.x_cond
                  else y_pos)
        return x_cond, y_cond, prime

    # -- the lyric encoder (separate encoder-decoder, prior.py:249-269) -------

    def get_encoder_kv(self, prime, fp16=False, seed=None, plain=False):
        """Lyric tokens prime [N, n_tokens] -> encoder_kv [N, n_tokens,
        width] (bf16 under fp16), or None without a lyric encoder."""
        if self.prime_prior is None:
            return None
        acts = self.prime_prior(prime, None, None, fp16=fp16, seed=seed,
                                plain=plain)
        encoder_kv = self.prime_state_ln(self.prime_state_proj(acts), plain)
        return encoder_kv.to(torch.bfloat16) if fp16 else encoder_kv

    def get_prime_loss(self, encoder_kv, prime_t):
        """The lyric encoder's own loss in bits per dim: encoder_kv through
        prime_x_out against the lyric tokens."""
        logits = torch.matmul(encoder_kv.float(),
                              self.prime_x_out.table.float())
        return cross_entropy_bpd(logits, prime_t)

    def encoder_kv_from_y(self, y, fp16=False):
        """The lyric encoder alone on the lyric tokens at the end of y
        (the coarse span sample.encoder)."""
        with profiler.span("sample.encoder"):
            return self.get_encoder_kv(y[:, y.shape[1] - self.n_tokens:],
                                       fp16)

    def forward(self, z, z_conds, y):
        """Teacher-forced forward of the codes z [N, n_ctx] -> logits
        [N, n_ctx (+ lyric tokens), bins]."""
        x_cond, y_cond, prime = self.get_cond(z_conds, y)
        if self.single_enc_dec:
            z, x_cond = self.prior_preprocess([prime, z], [None, x_cond])
            return self.prior(z, x_cond, y_cond)[1]
        encoder_kv = (self.get_encoder_kv(prime) if prime is not None
                      else None)
        return self.prior(z, x_cond, y_cond, encoder_kv=encoder_kv)[1]

    def z_forward(self, z, z_conds=None, y=None, fp16=False, seed=None,
                  plain=False, get_attn_weights=frozenset(), get_preds=False):
        """Training loss of codes z [N, n_ctx] (prior.py:271): returns
        (loss, metrics) with metrics bpd, prime_loss, gen_loss (detached),
        and with get_preds the logits [N, tokens, bins] as preds (the lyric
        tokens' too in a single_enc_dec prior).
        seed (an int) turns on the training dropouts; plain=True runs the
        flash layers and LayerNorms' plain versions. With get_attn_weights
        (a set of the prior's layers) it returns their recorded softmax
        weights instead, in depth order (prior.py:312-344)."""
        record = frozenset(get_attn_weights)
        x_cond, y_cond, prime = self.get_cond(z_conds, y)
        if self.copy_input:
            prime = z[:, :self.n_tokens]
        if self.single_enc_dec:
            z_all, x_cond = self.prior_preprocess([prime, z], [None, x_cond])
            (prime_loss, gen_loss), preds, *ws = self.prior(
                z_all, x_cond, y_cond, fp16=fp16, get_sep_loss=True,
                seed=seed, plain=plain, record_layers=record)
        else:
            encoder_kv = None
            if self.prime_prior is not None and prime is not None:
                encoder_kv = self.get_encoder_kv(
                    prime, fp16, None if seed is None else fold_seed(seed, 1),
                    plain)
            gen_loss, preds, *ws = self.prior(z, x_cond, y_cond, fp16=fp16,
                                          seed=seed, plain=plain,
                                          encoder_kv=encoder_kv,
                                          record_layers=record)
            prime_loss = (self.get_prime_loss(encoder_kv, prime)
                          if encoder_kv is not None
                          else torch.zeros((), device=gen_loss.device))
        if record:
            return ws[0]
        loss = (self.prime_loss_fraction * prime_loss * self.prime_loss_dims
                / self.total_loss_dims) \
            + (gen_loss * self.gen_loss_dims / self.total_loss_dims)
        metrics = dict(bpd=gen_loss.detach(), prime_loss=prime_loss.detach(),
                       gen_loss=gen_loss.detach())
        if get_preds:
            metrics["preds"] = preds.detach()
        return loss, metrics

    # -- segmented sampling ---------------------------------------------------------

    @torch.no_grad()
    @profiler.timed("sample.init")
    def sample_init(self, n_samples, z=None, z_conds=None, y=None, fp16=False,
                    chunk_size=None, dec_params=None, encoder_kv=None,
                    int8=False):
        """Conditioning, the lyric encoder's encoder_kv (once per window,
        unless given), fresh caches (the f6 layers' projected from
        encoder_kv) and the context prefill. int8: the caches are int8 from
        the start, the prefill writing its rows quantised. Returns
        (caches, x_tok, x_cond, y_cond); sampling starts at
        sample_prefix_len(z). Coarse spans (utils/profiler.py): sample.init
        around sample.cond, sample.encoder (where the lyric encoder runs
        here), sample.caches and sample.prefill (around the prefill's
        sample.prefill_tail)."""
        no_past_context = z is None or z.shape[1] == 0
        device = self.prior.x_emb.table.device
        with profiler.span("sample.cond"):
            x_cond, y_cond, prime = self.get_cond(z_conds, y)
            if x_cond is None:
                x_cond = self.prior.default_x_cond(n_samples)
            if self.single_enc_dec:
                xs = [prime] if no_past_context else [prime, z]
                prefill_tokens, x_cond = self.prior_preprocess(
                    xs, [None, x_cond])
        if not self.single_enc_dec:
            if prime is not None and encoder_kv is None:
                with profiler.span("sample.encoder"):
                    encoder_kv = self.get_encoder_kv(prime, fp16)
            prefill_tokens = None if no_past_context else z
        if fp16:
            x_cond = x_cond.to(torch.bfloat16)
            if encoder_kv is not None:
                encoder_kv = encoder_kv.to(torch.bfloat16)
        prefill = prefill_tokens is not None and prefill_tokens.shape[1] > 0
        with profiler.span("sample.caches"):
            caches = self.prior.init_decode_caches(
                n_samples, device, fp16=fp16, encoder_kv=encoder_kv,
                dec_params=dec_params, int8=int8)
        if prefill:
            with profiler.span("sample.prefill",
                               tokens=int(prefill_tokens.shape[1])):
                x_tok = self.prior.prefill(caches, prefill_tokens.long(),
                                           x_cond, y_cond, fp16=fp16,
                                           chunk_size=chunk_size,
                                           dec_params=dec_params)
        else:
            x_tok = torch.zeros((n_samples, 1), dtype=torch.long,
                                device=device)
        return caches, x_tok, x_cond, y_cond

    def sample_prefix_len(self, z=None):
        z_len = 0 if z is None else z.shape[1]
        return self.n_tokens + z_len if self.single_enc_dec else z_len

    def sample_segment(self, caches, x_tok, t0, n_steps, gen, x_cond, y_cond,
                       fp16=False, temp=1.0, top_k=0, top_p=0.0,
                       dec_params=None):
        return self.prior.sample_segment(
            caches, x_tok, t0, n_steps, gen, x_cond, y_cond, fp16=fp16,
            temp=temp, top_k=top_k, top_p=top_p, dec_params=dec_params)

    def sample_finish(self, toks, z=None):
        """The window's tokens: context + decoded tokens, in the VQ vocab."""
        has_z = z is not None and z.shape[1] > 0
        if self.single_enc_dec:
            parts = [(z + int(self.prior_bins_shift[1])).to(toks.dtype)] \
                if has_z else []
            pad = torch.zeros((toks.shape[0], self.prime_loss_dims),
                              dtype=toks.dtype, device=toks.device)
            return self.prior_postprocess(torch.cat([pad, *parts, toks], dim=1))
        parts = [z.to(toks.dtype)] if has_z else []
        return torch.cat([*parts, toks], dim=1)
