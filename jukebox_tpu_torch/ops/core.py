"""Core numeric building blocks of the PyTorch port (counterpart of
jukebox_tpu/ops/core.py).

Layouts: activations of the transformer are feature-last [N, T, C] and
dense weights are (n_in, n_out), as in the JAX package, so a dense layer is
`x @ w + b`. Convolutions run in PyTorch's channel-first idiom: activations
[N, C, T], Conv1d weights (out, in, k), ConvTranspose1d weights
(in, out, k); utils/convert.py moves the JAX (k, in, out) weights across.
LayerNorm and softmax accumulate in fp32 and cast back to the input dtype.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(x, w, b):
    """y = x @ w + b in x's dtype (the weights are cast to it, like the
    JAX dense)."""
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def layer_norm(x, g, b, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * g + b).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def conv1d(x, w, b, stride=1, padding=0, dilation=1):
    """x [N, C_in, T], w (out, in, k) -> [N, C_out, T']."""
    return F.conv1d(x, w.to(x.dtype), b.to(x.dtype), stride=stride,
                    padding=padding, dilation=dilation)


def conv_transpose1d(x, w, b, stride, padding):
    """x [N, C_in, T], w (in, out, k); out_len = (T-1)*stride - 2*padding + k."""
    return F.conv_transpose1d(x, w.to(x.dtype), b.to(x.dtype), stride=stride,
                              padding=padding)


def fold_seed(seed, *keys):
    """A derived int seed in [0, 2**31) of (seed, *keys), all non-negative
    ints: the port's counterpart of splitting a jax.random key. Per-step,
    per-layer and per-use dropout seeds are folded from the step's seed."""
    state = np.random.SeedSequence([int(seed), *map(int, keys)])
    return int(state.generate_state(1)[0]) & 0x7FFFFFFF


def dropout(x, rate, seed):
    """Inverted dropout (zero w.p. rate, scale the rest by 1 / (1 - rate));
    identity when rate == 0 or seed is None (eval and decode paths pass no
    seed). The mask comes from a torch.Generator seeded here from the int
    `seed`, so a block recomputed under activation checkpointing draws the
    same mask. It is not jax.random's mask: the two agree in distribution."""
    if rate == 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def filter_logits(logits, top_k=0, top_p=0.0, filter_value=-1e10):
    """Top-k, then nucleus filtering over the last axis (both may be set),
    as jukebox_tpu.ops.core.filter_logits."""
    if top_k > 0:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, filter_value), logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1),
                                 dim=-1)
        remove = cum_probs > top_p
        # keep the first token above the threshold
        remove = torch.cat([torch.zeros_like(remove[..., :1]),
                            remove[..., :-1]], dim=-1)
        n_keep = (~remove).sum(dim=-1, keepdim=True)
        thresh = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < thresh,
                             torch.full_like(logits, filter_value), logits)
    return logits


# ---------------------------------------------------------------------------
# Parameter-holding leaf modules. Their parameter names follow the JAX
# param trees (w, b, g, weight, ...) so utils/convert.py maps leaves by path.
# Each has `init_(gen)`, the random init of its JAX counterpart drawn from a
# torch.Generator (models are built on their device and drawn in place).
# ---------------------------------------------------------------------------

def _param(shape, device):
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


class Dense(nn.Module):
    def __init__(self, n_in, n_out, init_scale=1.0, zero_out=False,
                 device=None):
        super().__init__()
        self.init_scale, self.zero_out = init_scale, zero_out
        self.w = _param((n_in, n_out), device)
        self.b = _param((n_out,), device)

    def init_(self, gen):
        if self.zero_out:
            self.w.zero_()
        else:
            self.w.normal_(0.0, 0.02 * self.init_scale, generator=gen)
        self.b.zero_()

    def forward(self, x):
        return dense(x, self.w, self.b)


class LayerNorm(nn.Module):
    def __init__(self, width, device=None):
        super().__init__()
        self.g = _param((width,), device)
        self.b = _param((width,), device)

    def init_(self, gen):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x):
        return layer_norm(x, self.g, self.b)


class Conv1d(nn.Module):
    """Weights (out, in, k), JAX conv1d_init's kaiming-uniform bound."""

    def __init__(self, n_in, n_out, kernel, zero_out=False, device=None):
        super().__init__()
        self.zero_out = zero_out
        self.bound = 1.0 / math.sqrt(n_in * kernel)
        self.w = _param((n_out, n_in, kernel), device)
        self.b = _param((n_out,), device)

    def init_(self, gen):
        if self.zero_out:
            self.w.zero_()
            self.b.zero_()
        else:
            self.w.uniform_(-self.bound, self.bound, generator=gen)
            self.b.uniform_(-self.bound, self.bound, generator=gen)

    def forward(self, x, stride=1, padding=0, dilation=1):
        return conv1d(x, self.w, self.b, stride, padding, dilation)


class ConvTranspose1d(nn.Module):
    """Weights (in, out, k); torch's fan for ConvTranspose1d is out * k."""

    def __init__(self, n_in, n_out, kernel, device=None):
        super().__init__()
        self.bound = 1.0 / math.sqrt(n_out * kernel)
        self.w = _param((n_in, n_out, kernel), device)
        self.b = _param((n_out,), device)

    def init_(self, gen):
        self.w.uniform_(-self.bound, self.bound, generator=gen)
        self.b.uniform_(-self.bound, self.bound, generator=gen)

    def forward(self, x, stride, padding):
        return conv_transpose1d(x, self.w, self.b, stride, padding)


class Table(nn.Module):
    """One named normal-initialised table, e.g. an embedding {"weight"}."""

    def __init__(self, shape, std, name="weight", device=None):
        super().__init__()
        self.std, self.name = std, name
        self.register_parameter(name, _param(shape, device))

    def init_(self, gen):
        getattr(self, self.name).normal_(0.0, self.std, generator=gen)

    @property
    def table(self):
        return getattr(self, self.name)


@torch.no_grad()
def init_weights(module, seed, device=None):
    """Draw every parameter of `module` from one generator seeded `seed`,
    on the parameters' device."""
    device = device or next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return module
