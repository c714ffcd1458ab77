"""Per-level prior over VQ codes (counterpart of jukebox_tpu/models/prior.py),
for the priors of the 1b_lyrics cascade: the top prior, which merges the
lyric and VQ vocabularies and sequences into one stream (single_enc_dec),
and the upsamplers, conditioned on the codes of the level above through a
Conditioner. Host-side label bookkeeping (get_y / get_z_conds) is numpy.
z_forward is the training loss: the prime (lyric) and gen (code) losses
weighted by prime_loss_fraction and their share of the stream.
"""

import numpy as np
import torch
import torch.nn as nn

from jukebox_tpu_torch.data.labels import Labeller
from jukebox_tpu_torch.models.autoregressive import ConditionalAutoregressive2D
from jukebox_tpu_torch.models.conditioners import Conditioner, LabelConditioner
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.vqvae import calculate_strides


class SimplePrior(nn.Module):
    def __init__(self, z_shapes, l_bins, level, downs_t, strides_t,
                 prior_kwargs, x_cond_kwargs, y_cond_kwargs, prime_kwargs,
                 labels_v3=False, single_enc_dec=False, device=None):
        super().__init__()
        prior_kwargs = dict(prior_kwargs)
        self.n_tokens = prime_kwargs["n_tokens"]
        self.prime_loss_fraction = prime_kwargs.get("prime_loss_fraction", 0.0)
        if prime_kwargs["use_tokens"] and not single_enc_dec:
            raise NotImplementedError("separate lyric encoders are not ported")
        self.z_shapes, self.levels = z_shapes, len(z_shapes)
        self.z_shape, self.level, self.l_bins = z_shapes[level], level, l_bins
        self.x_cond = level != self.levels - 1
        self.cond_level = level + 1
        self.single_enc_dec = single_enc_dec

        if self.x_cond:
            xk = dict(x_cond_kwargs)
            self.conditioner_blocks = nn.ModuleList([Conditioner(
                z_shapes[self.cond_level], l_bins, downs_t[self.cond_level],
                strides_t[self.cond_level], xk.pop("out_width"),
                xk.pop("init_scale"), BlockCfg(**xk), device=device)])
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
                prime_len=self.prime_loss_dims, device=device, **prior_kwargs)
        else:
            self.prime_loss_dims = 0
            self.gen_loss_dims = int(np.prod(self.z_shape))
            self.prior = ConditionalAutoregressive2D(device=device,
                                                     **prior_kwargs)
        self.total_loss_dims = self.prime_loss_dims + self.gen_loss_dims

        self.n_ctx = self.gen_loss_dims
        self.downsamples = calculate_strides(strides_t, downs_t)
        self.cond_downsample = (self.downsamples[level + 1]
                                if level != self.levels - 1 else None)
        self.raw_to_tokens = int(np.prod(self.downsamples[:level + 1]))
        self.sample_length = self.n_ctx * self.raw_to_tokens
        self.labeller = Labeller(self.y_emb.max_bow_genre_size, self.n_tokens,
                                 self.sample_length, v3=labels_v3)

    # -- host-side label / window math ------------------------------------------

    def get_y(self, labels, start):
        y = np.array(labels["y"], dtype=np.int64, copy=True)
        y[:, 2] = int(self.sample_length)
        y[:, 1:2] = y[:, 1:2] + int(start * self.raw_to_tokens)
        self.labeller.set_y_lyric_tokens(y, labels)
        return y

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
        """Split y into labels | lyrics and build (x_cond, y_cond, prime)."""
        n_labels = y.shape[1] - self.n_tokens
        y_labels, prime = y[:, :n_labels], y[:, n_labels:]
        y_cond, y_pos = self.y_emb(y_labels)
        x_cond = (self.conditioner_blocks[0](z_conds[0]) if self.x_cond
                  else y_pos)
        return x_cond, y_cond, prime

    def forward(self, z, z_conds, y):
        """Teacher-forced forward of the codes z [N, n_ctx] -> logits
        [N, n_ctx (+ lyric tokens), bins]."""
        x_cond, y_cond, prime = self.get_cond(z_conds, y)
        if self.single_enc_dec:
            z, x_cond = self.prior_preprocess([prime, z], [None, x_cond])
        return self.prior(z, x_cond, y_cond)[1]

    def z_forward(self, z, z_conds=None, y=None, fp16=False, seed=None,
                  plain=False):
        """Training loss of codes z [N, n_ctx] (prior.py:271): returns
        (loss, metrics) with metrics bpd, prime_loss, gen_loss (detached).
        seed (an int) turns on the training dropouts; plain=True runs the
        flash layers' plain versions."""
        x_cond, y_cond, prime = self.get_cond(z_conds, y)
        if self.single_enc_dec:
            z_all, x_cond = self.prior_preprocess([prime, z], [None, x_cond])
            (prime_loss, gen_loss), _ = self.prior(
                z_all, x_cond, y_cond, fp16=fp16, get_sep_loss=True,
                seed=seed, plain=plain)
        else:
            gen_loss, _ = self.prior(z, x_cond, y_cond, fp16=fp16,
                                     seed=seed, plain=plain)
            prime_loss = torch.zeros((), device=gen_loss.device)
        loss = (self.prime_loss_fraction * prime_loss * self.prime_loss_dims
                / self.total_loss_dims) \
            + (gen_loss * self.gen_loss_dims / self.total_loss_dims)
        metrics = dict(bpd=gen_loss.detach(), prime_loss=prime_loss.detach(),
                       gen_loss=gen_loss.detach())
        return loss, metrics

    # -- segmented sampling ---------------------------------------------------------

    @torch.no_grad()
    def sample_init(self, n_samples, z=None, z_conds=None, y=None, fp16=False,
                    chunk_size=None, dec_params=None):
        """Conditioning, fresh caches and the context prefill. Returns
        (caches, x_tok, x_cond, y_cond); sampling starts at
        sample_prefix_len(z)."""
        no_past_context = z is None or z.shape[1] == 0
        x_cond, y_cond, prime = self.get_cond(z_conds, y)
        if self.single_enc_dec:
            xs = [prime] if no_past_context else [prime, z]
            prefill_tokens, x_cond = self.prior_preprocess(xs, [None, x_cond])
        else:
            prefill_tokens = None if no_past_context else z
        if fp16:
            x_cond = x_cond.to(torch.bfloat16)
        caches = self.prior.init_decode_caches(n_samples, y.device, fp16=fp16)
        if prefill_tokens is not None and prefill_tokens.shape[1] > 0:
            x_tok = self.prior.prefill(caches, prefill_tokens.long(), x_cond,
                                       y_cond, fp16=fp16,
                                       chunk_size=chunk_size,
                                       dec_params=dec_params)
        else:
            x_tok = torch.zeros((n_samples, 1), dtype=torch.long,
                                device=y.device)
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
