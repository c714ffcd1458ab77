"""Codebooks of the PyTorch port (counterpart of
jukebox_tpu/models/bottleneck.py): nearest-code quantisation (`encode`) and
lookup (`decode`) against a frozen codebook; the EMA k-means update of
VQ-VAE training is not ported yet."""

import torch
import torch.nn as nn


class BottleneckBlock(nn.Module):
    """One level's codebook k [l_bins, emb_width]."""

    def __init__(self, k_bins, emb_width, device=None):
        super().__init__()
        self.k = nn.Parameter(torch.empty((k_bins, emb_width), device=device),
                              requires_grad=False)

    def init_(self, gen):
        # the JAX codebook starts at zero and is fitted by training; a random
        # model draws it so that decoded audio is not constant
        self.k.normal_(0.0, 1.0, generator=gen)

    def quantise(self, x):
        """Nearest code by L2 distance, x [NT, w] fp32 -> (codes [NT], fit)."""
        k = self.k
        distance = ((x * x).sum(dim=-1, keepdim=True)
                    - 2 * torch.matmul(x, k.t())
                    + (k * k).sum(dim=-1)[None, :])
        min_d, x_l = torch.min(distance, dim=-1)
        return x_l, min_d.mean()

    def encode(self, x):
        """x [N, T, w] -> codes [N, T] (the 2 * w sum input of the JAX
        _preprocess is not taken: no caller of the port passes it)."""
        N, T, w = x.shape
        if w != self.k.shape[1]:
            raise ValueError(f"expected width {self.k.shape[1]}, got {w}")
        x_l, _ = self.quantise(x.reshape(-1, w).float())
        return x_l.reshape(N, T)

    def dequantise(self, x_l):
        return self.k[x_l]

    def decode(self, x_l):
        """codes [N, T] -> [N, T, emb_width]."""
        return self.dequantise(x_l)


class Bottleneck(nn.Module):
    def __init__(self, l_bins, emb_width, levels, device=None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            BottleneckBlock(l_bins, emb_width, device=device)
            for _ in range(levels))

    def encode(self, xs, start_level=0):
        """Latents of levels start_level.. -> their codes."""
        return [blk.encode(x) for blk, x in
                zip(self.level_blocks[start_level:], xs)]

    def decode(self, zs, start_level=0, end_level=None):
        end_level = len(self.level_blocks) if end_level is None else end_level
        return [blk.decode(z) for blk, z in
                zip(self.level_blocks[start_level:end_level], zs)]
