"""VQ-VAE encoder and decoder conv stacks of the PyTorch port (counterpart
of jukebox_tpu/models/encdec.py). Activations are channel-first [N, C, T]
inside; Encoder.forward and Decoder.forward take and return the JAX layout
[N, T, C].
"""

from dataclasses import dataclass
from typing import Optional

import torch.nn as nn

from jukebox_tpu_torch.models.resnet import Resnet1D
from jukebox_tpu_torch.ops.core import Conv1d, ConvTranspose1d


@dataclass(frozen=True)
class BlockCfg:
    """Shared conv-block hyperparameters (reference block_kwargs)."""
    width: int = 128
    depth: int = 3
    m_conv: float = 1.0
    dilation_growth_rate: int = 1
    dilation_cycle: Optional[int] = None
    zero_out: bool = False
    res_scale: bool = False
    reverse_decoder_dilation: bool = False


class EncoderConvBlock(nn.Module):
    """down_t x [strided Conv1d(2 * stride, pad stride // 2) -> Resnet1D],
    then Conv1d(3) to the embedding width."""

    def __init__(self, input_emb_width, output_emb_width, down_t, stride_t,
                 block: BlockCfg, device=None):
        super().__init__()
        self.down_t, self.stride_t = down_t, stride_t
        b = block
        self.downs = nn.ModuleList(
            nn.ModuleDict({
                "conv_down": Conv1d(input_emb_width if i == 0 else b.width,
                                    b.width, stride_t * 2, device=device),
                "resnet": Resnet1D(b.width, b.depth, b.m_conv,
                                   b.dilation_growth_rate, b.dilation_cycle,
                                   b.zero_out, b.res_scale, device=device)})
            for i in range(down_t))
        self.proj = (Conv1d(b.width, output_emb_width, 3, device=device)
                     if down_t > 0 else None)

    def forward(self, x):
        """[N, C, T] -> [N, C', T / stride_t ** down_t]."""
        if self.down_t == 0:
            return x
        for down in self.downs:
            x = down["conv_down"](x, self.stride_t, self.stride_t // 2)
            x = down["resnet"](x)
        return self.proj(x, padding=1)


class Encoder(nn.Module):
    """Multi-level strided encoder; forward returns the deepest level's
    latent (the one jukebox_tpu's VQVAE.encode keeps per level)."""

    def __init__(self, input_emb_width, output_emb_width, levels, downs_t,
                 strides_t, block: BlockCfg, device=None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            EncoderConvBlock(input_emb_width if l == 0 else output_emb_width,
                             output_emb_width, downs_t[l], strides_t[l],
                             block, device=device)
            for l in range(levels))

    def forward(self, x):
        """x [N, T, input_emb_width] -> [N, T / hop, output_emb_width]."""
        x = x.transpose(1, 2)
        for blk in self.level_blocks:
            x = blk(x)
        return x.transpose(1, 2)


class DecoderConvBlock(nn.Module):
    def __init__(self, input_emb_width, output_emb_width, down_t, stride_t,
                 block: BlockCfg, device=None):
        super().__init__()
        self.down_t, self.stride_t = down_t, stride_t
        b = block
        self.proj = Conv1d(output_emb_width, b.width, 3, device=device)
        self.ups = nn.ModuleList(
            nn.ModuleDict({
                "resnet": Resnet1D(b.width, b.depth, b.m_conv,
                                   b.dilation_growth_rate, b.dilation_cycle,
                                   b.zero_out, b.res_scale,
                                   b.reverse_decoder_dilation, device=device),
                "conv_up": ConvTranspose1d(
                    b.width, input_emb_width if i == down_t - 1 else b.width,
                    stride_t * 2, device=device)})
            for i in range(down_t))

    def forward(self, x):
        """[N, C, T] -> [N, C', T * stride_t ** down_t]."""
        x = self.proj(x, padding=1)
        for up in self.ups:
            x = up["resnet"](x)
            x = up["conv_up"](x, self.stride_t, self.stride_t // 2)
        return x


class Decoder(nn.Module):
    """Multi-level decoder decoding from its deepest level only (the
    sampling path: all_levels=False in the JAX Decoder.apply)."""

    def __init__(self, input_emb_width, output_emb_width, levels, downs_t,
                 strides_t, block: BlockCfg, device=None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            DecoderConvBlock(output_emb_width, output_emb_width, downs_t[l],
                             strides_t[l], block, device=device)
            for l in range(levels))
        self.out = Conv1d(output_emb_width, input_emb_width, 3, device=device)

    def forward(self, x):
        """x [N, T, emb_width] -> audio [N, T * hop, input_emb_width]."""
        x = x.transpose(1, 2)
        for blk in reversed(self.level_blocks):
            x = blk(x)
        return self.out(x, padding=1).transpose(1, 2)
