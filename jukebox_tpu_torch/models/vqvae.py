"""VQ-VAE of the PyTorch port (counterpart of jukebox_tpu/models/vqvae.py
`encode` and `decode`), frozen: the prior's training encodes audio through
it and sampling decodes codes. VQ-VAE training is not ported yet.
"""

import numpy as np
import torch
import torch.nn as nn

from jukebox_tpu_torch.models.bottleneck import Bottleneck
from jukebox_tpu_torch.models.encdec import BlockCfg, Decoder, Encoder


def calculate_strides(strides, downs):
    return [stride ** down for stride, down in zip(strides, downs)]


class VQVAE(nn.Module):
    def __init__(self, input_shape, levels, downs_t, strides_t, emb_width,
                 l_bins, multipliers=None, block=BlockCfg(), device=None):
        super().__init__()
        self.input_shape, self.levels = tuple(input_shape), levels
        self.downs_t, self.strides_t = tuple(downs_t), tuple(strides_t)
        self.l_bins = l_bins
        self.bottleneck = Bottleneck(l_bins, emb_width, levels, device=device)
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
