"""Codebooks of the PyTorch port (counterpart of
jukebox_tpu/models/bottleneck.py): nearest-code quantisation, lookup, and
the EMA k-means update of VQ-VAE training with dead-code restarts.

Each level's state lives in buffers of its BottleneckBlock, in the JAX
state's layout: k and k_sum [k_bins, emb_width], k_elem [k_bins], init (a
bool: the codebook has been seeded) and threshold. They are state, not
parameters: no gradient and no optimizer touches them; a training forward
updates them in place. The random draws of the first-batch init and the
restarts come from a torch.Generator, so they are not jax.random's; what
they mean is the same: every drawn code is a row of the batch, plus noise
of std 0.01 / sqrt(emb_width) when the batch has fewer rows than codes.

The per-code sums and counts are one-hot products (chunked), not a
scatter-add: on the card a scatter-add sums fp32 through atomics in an
order that changes from run to run, while a GEMM gives the same bits on
every run, so the codebook's statistics repeat exactly for the same
inputs. Only these sums are made deterministic: the rest of a training
step (cuDNN's convolution gradients among them) may not be.

Data parallel (group: the "dp" group of parallel/dist.py), every rank
keeps the same codebook, as the JAX package's replicated state does: the
segment sums are summed over the group, and the first-batch init and the
restarts draw from the group's whole batch (gathered in rank order) with
one generator seed on every rank.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from jukebox_tpu_torch.parallel.dist import all_gather_cat, all_reduce_

# rows of one chunk of the distance and one-hot products: at most 2**26
# fp32 elements (256 MiB) a chunk
CHUNK_ELEMS = 1 << 26


def _chunks(n_rows, k_bins):
    step = max(1, CHUNK_ELEMS // k_bins)
    return [(i, min(n_rows, i + step)) for i in range(0, n_rows, step)]


class BottleneckBlock(nn.Module):
    """One level's codebook and its EMA statistics."""

    def __init__(self, k_bins, emb_width, mu=0.99, threshold=1.0,
                 device=None):
        super().__init__()
        self.k_bins, self.emb_width, self.mu = k_bins, emb_width, mu
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("k", torch.zeros((k_bins, emb_width), **f32))
        self.register_buffer("k_sum", torch.zeros((k_bins, emb_width), **f32))
        self.register_buffer("k_elem", torch.zeros((k_bins,), **f32))
        self.register_buffer("init", torch.zeros((), dtype=torch.bool,
                                                 device=device))
        self.register_buffer("threshold", torch.tensor(float(threshold),
                                                       **f32))
        self.group = None  # the "dp" group of data-parallel training

    def init_(self, gen):
        # a model for sampling draws its codebook so that decoded audio is
        # not constant; training starts from reset_state (JAX's init_state)
        self.k.normal_(0.0, 1.0, generator=gen)

    @torch.no_grad()
    def reset_state(self, threshold=1.0):
        """JAX's init_state: a zero codebook, not seeded yet."""
        for b in (self.k, self.k_sum, self.k_elem):
            b.zero_()
        self.init.fill_(False)
        self.threshold.fill_(threshold)

    @torch.no_grad()
    def restore_state(self, k, num_tokens=None, threshold=1.0):
        """Seed the EMA statistics from codebook k for fine-tuning: k_elem
        num_tokens / k_bins for every code (1 without num_tokens), k_sum
        k times that, init set."""
        k = torch.as_tensor(k, dtype=torch.float32, device=self.k.device)
        expected = torch.tensor(1.0 if num_tokens is None
                                else num_tokens / self.k_bins,
                                dtype=torch.float32, device=self.k.device)
        self.k.copy_(k)
        self.k_sum.copy_(k * expected)
        self.k_elem.copy_(torch.ones_like(self.k_elem) * expected)
        self.init.fill_(True)
        self.threshold.fill_(threshold)

    def _rand_candidates(self, x, gen):
        """k_bins rows drawn from x [NT, w] without replacement; x is tiled
        and jittered first when it has fewer rows than codes."""
        n = x.shape[0]
        if n < self.k_bins:
            n_repeats = (self.k_bins + n - 1) // n
            std = 0.01 / math.sqrt(self.emb_width)
            x = x.repeat(n_repeats, 1)
            x = x + std * torch.randn(x.shape, generator=gen,
                                      device=gen.device).to(x.device)
        idx = torch.randperm(x.shape[0], generator=gen, device=gen.device)
        return x[idx[:self.k_bins].to(x.device)]

    @torch.no_grad()
    def quantise(self, x):
        """Nearest code by L2 distance, |x|^2 - 2 x.k + |k|^2 in fp32, in
        row chunks: x [NT, w] -> (codes [NT], fit = mean least distance)."""
        k = self.k
        k2 = (k * k).sum(dim=-1)[None, :]
        codes, fit = [], torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        for lo, hi in _chunks(x.shape[0], self.k_bins):
            xc = x[lo:hi]
            d = (xc * xc).sum(dim=-1, keepdim=True) - 2 * (xc @ k.t()) + k2
            min_d, x_l = torch.min(d, dim=-1)
            codes.append(x_l)
            fit = fit + min_d.sum()
        return torch.cat(codes), fit / x.shape[0]

    def dequantise(self, x_l):
        return self.k[x_l]

    def _segment_sum(self, x, x_l):
        """Per-code sums of the rows of x [NT, w] by code x_l and per-code
        counts, from one-hot products in row chunks (the same bits on every
        run): ([k_bins, w], [k_bins]) fp32."""
        out = torch.zeros((self.k_bins, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        count = torch.zeros((self.k_bins,), dtype=torch.float32,
                            device=x.device)
        for lo, hi in _chunks(x.shape[0], self.k_bins):
            one_hot = F.one_hot(x_l[lo:hi], self.k_bins).to(torch.float32)
            out += one_hot.t() @ x[lo:hi]
            count += one_hot.sum(0)
        return all_reduce_(out, self.group), all_reduce_(count, self.group)

    def _prenorm(self, x):
        return torch.linalg.vector_norm(x - x.mean()) / math.sqrt(
            x.shape[0] * x.shape[1])

    def _preprocess(self, x):
        """[N, T, C] -> ([NT, w] fp32, prenorm); C = 2 * emb_width adds its
        halves (the sum input of the JAX _preprocess)."""
        x = x.reshape(-1, x.shape[-1]).float()
        if x.shape[-1] == self.emb_width:
            with torch.no_grad():
                prenorm = self._prenorm(x)
        elif x.shape[-1] == 2 * self.emb_width:
            x1, x2 = x[..., :self.emb_width], x[..., self.emb_width:]
            with torch.no_grad():
                prenorm = self._prenorm(x1) + self._prenorm(x2)
            x = x1 + x2
        else:
            raise ValueError(f"Expected {x.shape[-1]} to be (1 or 2) * "
                             f"{self.emb_width}")
        return x, prenorm

    @torch.no_grad()
    def _init_k(self, x, gen):
        """Seed the codebook from the batch (the first training batch)."""
        k = self._rand_candidates(all_gather_cat(x, self.group), gen)
        self.k.copy_(k)
        self.k_sum.copy_(k)
        self.k_elem.fill_(1.0)
        self.init.fill_(True)

    @torch.no_grad()
    def _update_k(self, x, x_l, gen):
        """The EMA update of k_sum and k_elem by this batch's assignment;
        codes whose k_elem falls under threshold restart at random rows of
        the batch. Returns the update's metrics."""
        mu = self.mu
        _k_sum, _k_elem = self._segment_sum(x, x_l)
        _k_rand = self._rand_candidates(all_gather_cat(x, self.group), gen)
        old_k = self.k.clone()
        k_sum = mu * self.k_sum + (1.0 - mu) * _k_sum
        k_elem = mu * self.k_elem + (1.0 - mu) * _k_elem
        usage = (k_elem[:, None] >= self.threshold).to(torch.float32)
        k = usage * (k_sum / k_elem[:, None]) + (1 - usage) * _k_rand
        _k_prob = _k_elem / torch.sum(_k_elem)
        metrics = dict(
            entropy=-torch.sum(_k_prob * torch.log(_k_prob + 1e-8)),
            used_curr=torch.sum(_k_elem >= self.threshold),
            usage=torch.sum(usage),
            dk=torch.linalg.vector_norm(k - old_k)
            / math.sqrt(self.k_bins * self.emb_width))
        self.k.copy_(k)
        self.k_sum.copy_(k_sum)
        self.k_elem.copy_(k_elem)
        return metrics

    def encode(self, x):
        """x [N, T, w] (or [N, T, 2w]) -> codes [N, T]."""
        N, T = x.shape[0], x.shape[1]
        flat, _ = self._preprocess(x)
        x_l, _ = self.quantise(flat)
        return x_l.reshape(N, T)

    def decode(self, x_l):
        """codes [N, T] -> [N, T, emb_width]."""
        return self.dequantise(x_l)

    def forward(self, x, update_k=False, gen=None):
        """The training / eval forward of x [N, T, C]: (codes [N, T],
        straight-through quantised x [N, T, w], commit loss, metrics). With
        update_k the state is updated in place (seeded first from this
        batch when init is unset), drawing from the torch.Generator gen."""
        N, T = x.shape[0], x.shape[1]
        flat, prenorm = self._preprocess(x)
        if update_k and not bool(self.init):
            self._init_k(flat.detach(), gen)
        x_l, fit = self.quantise(flat.detach())
        x_d = self.dequantise(x_l)
        update_metrics = (self._update_k(flat.detach(), x_l, gen)
                          if update_k else {})
        commit_loss = torch.sum(torch.square(x_d - flat)) / flat.numel()
        x_d = flat + (x_d - flat).detach()  # straight-through
        metrics = dict(fit=fit, pn=prenorm, **update_metrics)
        return (x_l.reshape(N, T), x_d.reshape(N, T, self.emb_width),
                commit_loss, metrics)


class Bottleneck(nn.Module):
    """A BottleneckBlock per level."""

    def __init__(self, l_bins, emb_width, levels, mu=0.99, device=None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            BottleneckBlock(l_bins, emb_width, mu, device=device)
            for _ in range(levels))

    def encode(self, xs, start_level=0):
        """Latents of levels start_level.. -> their codes."""
        return [blk.encode(x) for blk, x in
                zip(self.level_blocks[start_level:], xs)]

    def decode(self, zs, start_level=0, end_level=None):
        end_level = len(self.level_blocks) if end_level is None else end_level
        return [blk.decode(z) for blk, z in
                zip(self.level_blocks[start_level:end_level], zs)]

    def reset_state(self):
        for blk in self.level_blocks:
            blk.reset_state()

    def forward(self, xs, update_k=False, gen=None):
        """(codes, quantised latents, commit losses, metrics) of every
        level; metrics only with update_k. Without update_k the quantised
        latents carry no gradient to the encoders."""
        zs, xs_q, commit_losses, metrics = [], [], [], []
        for blk, x in zip(self.level_blocks, xs):
            z, x_q, commit, metric = blk(x, update_k=update_k, gen=gen)
            if not update_k:
                x_q = x_q.detach()
            zs.append(z)
            xs_q.append(x_q)
            commit_losses.append(commit)
            if update_k:
                metrics.append(metric)
        return zs, xs_q, commit_losses, metrics


class NoBottleneck(nn.Module):
    """The identity bottleneck of use_bottleneck=False: no codebook, no
    state."""

    def __init__(self, levels):
        super().__init__()
        self.levels = levels
        self.level_blocks = []

    def encode(self, xs, start_level=0):
        return xs

    def decode(self, zs, start_level=0, end_level=None):
        return zs

    def reset_state(self):
        pass

    def forward(self, xs, update_k=False, gen=None):
        zero = torch.zeros((), device=xs[0].device)
        commit_losses = [zero] * self.levels
        metrics = [dict(entropy=zero, usage=zero, used_curr=zero, pn=zero,
                        dk=zero) for _ in range(self.levels)] \
            if update_k else []
        return xs, xs, commit_losses, metrics
