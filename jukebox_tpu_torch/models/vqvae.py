"""VQ-VAE of the PyTorch port (counterpart of jukebox_tpu/models/vqvae.py):
`encode` and `decode` (the prior's training encodes audio through it and
sampling decodes codes) and the training forward: every level's encoder,
the codebooks (updated in place when training), every level's decoder, and
the loss mix of reconstruction (l1 / l2 / linf / lmix, normalised by the
dataset's bandwidth), spectral, multispectral and commit losses.
"""

import numpy as np
import torch
import torch.nn as nn

from jukebox_tpu_torch.models.bottleneck import Bottleneck, NoBottleneck
from jukebox_tpu_torch.models.encdec import BlockCfg, Decoder, Encoder
from jukebox_tpu_torch.ops.stft import (multispectral_loss,
                                        spectral_convergence, spectral_loss)


def calculate_strides(strides, downs):
    return [stride ** down for stride, down in zip(strides, downs)]


def _loss_fn(loss_fn, x_target, x_pred, hps):
    """Reconstruction loss normalised by the dataset's bandwidth."""
    if loss_fn == "l1":
        return torch.mean(torch.abs(x_pred - x_target)) / hps.bandwidth["l1"]
    if loss_fn == "l2":
        return torch.mean(torch.square(x_pred - x_target)) \
            / hps.bandwidth["l2"]
    if loss_fn == "linf":
        residual = torch.square(x_pred - x_target).reshape(
            x_target.shape[0], -1)
        values = torch.topk(residual, min(hps.linf_k, residual.shape[-1]),
                            dim=-1).values
        return torch.mean(values) / hps.bandwidth["l2"]
    if loss_fn == "lmix":
        loss = 0.0
        if hps.lmix_l1:
            loss += hps.lmix_l1 * _loss_fn("l1", x_target, x_pred, hps)
        if hps.lmix_l2:
            loss += hps.lmix_l2 * _loss_fn("l2", x_target, x_pred, hps)
        if hps.lmix_linf:
            loss += hps.lmix_linf * _loss_fn("linf", x_target, x_pred, hps)
        return loss
    raise ValueError(f"Unknown loss_fn {loss_fn}")


def average_metrics(_metrics):
    """The mean of each key over a list of per-level metric dicts."""
    metrics = {}
    for _metric in _metrics:
        for key, val in _metric.items():
            metrics.setdefault(key, []).append(val)
    return {key: sum(vals) / len(vals) for key, vals in metrics.items()}


class VQVAE(nn.Module):
    def __init__(self, input_shape, levels, downs_t, strides_t, emb_width,
                 l_bins, multipliers=None, block=BlockCfg(), device=None,
                 mu=0.99, commit=0.02, spectral=0.0, multispectral=1.0,
                 use_bottleneck=True):
        super().__init__()
        self.input_shape, self.levels = tuple(input_shape), levels
        self.downs_t, self.strides_t = tuple(downs_t), tuple(strides_t)
        self.l_bins = l_bins
        self.commit, self.spectral = commit, spectral
        self.multispectral = multispectral
        self.bottleneck = (Bottleneck(l_bins, emb_width, levels, mu,
                                      device=device) if use_bottleneck
                           else NoBottleneck(levels))
        if multipliers is not None and len(multipliers) != levels:
            raise ValueError(f"{len(multipliers)} multipliers for {levels} "
                             f"levels")
        self.decoders = nn.ModuleList()
        self.encoders = nn.ModuleList()
        cfgs = []
        for level in range(levels):
            m = 1 if multipliers is None else multipliers[level]
            cfgs.append(BlockCfg(
                width=block.width * m, depth=block.depth * m,
                m_conv=block.m_conv,
                dilation_growth_rate=block.dilation_growth_rate,
                dilation_cycle=block.dilation_cycle, zero_out=block.zero_out,
                res_scale=block.res_scale,
                reverse_decoder_dilation=block.reverse_decoder_dilation))
        # decoders first: their random draws come before the encoders'
        for level, cfg in enumerate(cfgs):
            self.decoders.append(Decoder(
                self.input_shape[-1], emb_width, level + 1,
                self.downs_t[:level + 1], self.strides_t[:level + 1], cfg,
                device=device))
        for level, cfg in enumerate(cfgs):
            self.encoders.append(Encoder(
                self.input_shape[-1], emb_width, level + 1,
                self.downs_t[:level + 1], self.strides_t[:level + 1], cfg,
                device=device))

    @property
    def sample_length(self):
        return self.input_shape[0]

    @property
    def downsamples(self):
        return calculate_strides(self.strides_t, self.downs_t)

    @property
    def hop_lengths(self):
        return np.cumprod(self.downsamples)

    @property
    def z_shapes(self):
        return [(self.input_shape[0] // int(self.hop_lengths[level]),)
                for level in range(self.levels)]

    @torch.no_grad()
    def encode(self, x, start_level=0, end_level=None, bs_chunks=1):
        """Audio x [N, T, C] -> codes of levels [start_level, end_level)
        (vqvae.py:145), in bs_chunks batch chunks. Only those levels'
        encoders run; jukebox_tpu runs every level's and keeps these."""
        end_level = self.levels if end_level is None else end_level
        outs = []
        for idx in np.array_split(np.arange(x.shape[0]), bs_chunks):
            xc = x[torch.as_tensor(idx, device=x.device)]
            xs = [self.encoders[level](xc)
                  for level in range(start_level, end_level)]
            outs.append(self.bottleneck.encode(xs, start_level))
        return [torch.cat(zs, dim=0) for zs in zip(*outs)]

    @torch.no_grad()
    def decode(self, zs, start_level=0, end_level=None, bs_chunks=1):
        """Codes of levels [start_level, end_level) -> audio [N, T, C],
        decoded from the deepest given level only (vqvae.py:101-113), in
        bs_chunks batch chunks."""
        end_level = self.levels if end_level is None else end_level
        assert len(zs) == end_level - start_level
        outs = []
        for idx in np.array_split(np.arange(zs[0].shape[0]), bs_chunks):
            idx = torch.as_tensor(idx, device=zs[0].device)
            xq = self.bottleneck.decode([z[idx] for z in zs], start_level,
                                        end_level)
            outs.append(self.decoders[start_level](xq[0]))
        return torch.cat(outs, dim=0)

    def forward(self, x, hps, loss_fn="l1", train=False, gen=None):
        """The training forward of audio x [N, T, 1]: (x_out, loss,
        metrics), x_out level 0's reconstruction. With train the codebooks
        update in place (gen: the torch.Generator of their random draws).
        metrics hold each level's losses and, detached, the level-0
        spectral convergence, its l1 / l2 / linf losses, the commit loss and
        the codebook metrics averaged over the levels (training only)."""
        metrics = {}
        x_in = x.float()
        xs = [self.encoders[level](x_in) for level in range(self.levels)]
        zs, xs_quantised, commit_losses, quantiser_metrics = \
            self.bottleneck(xs, update_k=train, gen=gen)
        x_outs = [self.decoders[level](xs_quantised[level])
                  for level in range(self.levels)]

        def _spectral_loss(x_target, x_out):
            if hps.use_nonrelative_specloss:
                sl = (spectral_loss(x_target, x_out, hps)
                      / hps.bandwidth["spec"])
            else:
                sl = spectral_convergence(x_target, x_out, hps)
            return torch.mean(sl)

        def _multispectral_loss(x_target, x_out):
            return torch.mean(multispectral_loss(x_target, x_out, hps)
                              / hps.bandwidth["spec"])

        zero = torch.zeros((), device=x_in.device)
        recons_loss, spec_loss, multispec_loss = zero, zero, zero
        x_target = x_in
        for level in reversed(range(self.levels)):
            x_out = x_outs[level]
            this_recons_loss = _loss_fn(loss_fn, x_target, x_out, hps)
            this_spec_loss = _spectral_loss(x_target, x_out)
            this_multispec_loss = _multispectral_loss(x_target, x_out)
            metrics[f"recons_loss_l{level + 1}"] = this_recons_loss
            metrics[f"spectral_loss_l{level + 1}"] = this_spec_loss
            metrics[f"multispectral_loss_l{level + 1}"] = this_multispec_loss
            recons_loss = recons_loss + this_recons_loss
            spec_loss = spec_loss + this_spec_loss
            multispec_loss = multispec_loss + this_multispec_loss

        commit_loss = sum(commit_losses)
        loss = (recons_loss + self.spectral * spec_loss
                + self.multispectral * multispec_loss
                + self.commit * commit_loss)

        x_out = x_outs[0]
        with torch.no_grad():
            metrics.update(dict(
                recons_loss=recons_loss, spectral_loss=spec_loss,
                multispectral_loss=multispec_loss,
                spectral_convergence=torch.mean(
                    spectral_convergence(x_target, x_out, hps)),
                l2_loss=_loss_fn("l2", x_target, x_out, hps),
                l1_loss=_loss_fn("l1", x_target, x_out, hps),
                linf_loss=_loss_fn("linf", x_target, x_out, hps),
                commit_loss=commit_loss,
                **average_metrics(quantiser_metrics)))
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        return x_out, loss, metrics
