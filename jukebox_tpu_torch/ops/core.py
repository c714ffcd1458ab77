"""Core numeric building blocks of the PyTorch port (counterpart of
jukebox_tpu/ops/core.py).

Layouts: activations of the transformer are feature-last [N, T, C] and
dense weights are (n_in, n_out), as in the JAX package, so a dense layer is
`x @ w + b`. Convolutions run in PyTorch's channel-first idiom: activations
[N, C, T], Conv1d weights (out, in, k), ConvTranspose1d weights
(in, out, k); utils/convert.py moves the JAX (k, in, out) weights across.
LayerNorm and softmax accumulate in fp32 and cast back to the input dtype;
LayerNorm runs the kernels of ops/layer_norm.py on the card.
"""

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jukebox_tpu_torch.ops import layer_norm as _ln


def dense(x, w, b):
    """y = x @ w + b in x's dtype (the weights are cast to it, like the
    JAX dense)."""
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def dense_any(x, p):
    """dense of a param dict: {"w", "b"}, or the weight-only int8 form
    {"w_q", "s", "b"} of quantize_dense, computed as the JAX package's
    dense computes it (ops/core.py:43-60): the product with the int8
    weights cast to x's dtype, then the per-column scale and the bias, each
    in x's dtype."""
    if "w_q" in p:
        y = torch.matmul(x, p["w_q"].to(x.dtype))
        return y * p["s"].to(x.dtype) + p["b"].to(x.dtype)
    return dense(x, p["w"], p["b"])


def quantize_dense(p, reduce=None):
    """Weight-only int8 form of a dense param dict {"w", "b"} (w [..., in,
    out]): per-output-column absmax over the input axis / 127, floored at
    1e-12, w_q = clip(round(w / s), -127, 127) as int8, s fp32 [..., out].
    reduce: optional in-place reduction of the column absmax (the largest
    over the ranks that hold a row-split weight's other rows).
    Every step is one correctly rounded fp32 operation (the divisors are
    tensors: a host-scalar divisor turns into a product with its reciprocal
    on the card), so the result is bit-identical to jukebox_tpu's numpy
    quantize_dense on the CPU and on the card. b passes through."""
    w = p["w"].detach().float()
    s = torch.amax(w.abs(), dim=-2, keepdim=True)
    if reduce is not None:
        s = reduce(s.contiguous())
    s = torch.clamp_min(s / torch.full_like(s, 127.0), 1e-12)
    w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"w_q": w_q, "s": s.squeeze(-2).contiguous(), "b": p["b"]}


def quantize_dense_tree(tree):
    """quantize_dense of every dense dict ({"w", "b"} with a matrix w) in a
    tree of dicts and lists; LayerNorm and other leaves pass through."""
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"} and tree["w"].ndim >= 2:
            return quantize_dense(tree)
        return {k: quantize_dense_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_dense_tree(v) for v in tree)
    return tree


def layer_norm(x, g, b, eps=1e-5, plain=False):
    """LayerNorm of the last axis in x's dtype, fp32 statistics: the
    LayerNorm kernels on the card (plain=True: their plain versions)."""
    return _ln.layer_norm(x, g, b, eps, plain)


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


# ---------------------------------------------------------------------------
# dropout: a counter-based keep mask over the global batch
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def keep_threshold(rate):
    """uint32 threshold: a value is kept when its hash is >= it."""
    return min(int(rate * 4294967296.0), _M32)


def _mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor a in [0, 2**32) and an int c,
    without leaving int64's range."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def keep_mask(seed, bh, q_pos, kv_pos, rate):
    """Bool keep mask at positions q_pos, kv_pos of row bh (int tensors or
    ints that broadcast; in the flash kernels a head row b * n_head + h):
    the murmur3 finaliser of jukebox_tpu's flash _keep_mask over (seed, bh,
    q_pos, kv_pos), in uint32 arithmetic carried in int64."""
    bh = torch.as_tensor(bh, dtype=torch.long, device=q_pos.device)
    s = (int(seed) + _mul32(bh, 0xC2B2AE3D)) & _M32
    h = (_mul32(q_pos.long(), 0x9E3779B1) ^ _mul32(kv_pos.long(), 0x85EBCA77)
         ^ s)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= keep_threshold(rate)


# the global batch rows of this thread's batch rows (a data-parallel
# rank's), or None: all of them, in order (dropout_rows)
_ROWS = threading.local()


@contextlib.contextmanager
def dropout_rows(rows):
    """Within (on this thread): the batch a dropout sees is the rows
    `rows` (ints) of the step's global batch, so that a data-parallel rank
    holding them draws the masks one process draws for them (rows None:
    the whole batch)."""
    prev = getattr(_ROWS, "rows", None)
    _ROWS.rows = None if rows is None else [int(r) for r in rows]
    try:
        yield
    finally:
        _ROWS.rows = prev


def global_rows(R, device=None):
    """The global indices [R] of the local rows 0..R-1 of a batch-major
    leading axis (R a multiple of the local batch) under dropout_rows."""
    rows = getattr(_ROWS, "rows", None)
    if rows is None:
        return torch.arange(R, device=device)
    m = R // len(rows)
    return (torch.tensor(rows, device=device)[:, None] * m
            + torch.arange(m, device=device)).reshape(-1)


def dropout(x, rate, seed, heads=None):
    """Inverted dropout (zero w.p. rate, scale the rest by 1 / (1 - rate));
    identity when rate == 0 or seed is None (eval and decode paths pass no
    seed). The mask is a function of the int `seed` and each element's
    place in the global batch, so a block recomputed under activation
    checkpointing draws the same mask and the ranks of a placed step draw
    their rows of one process's: x viewed as [R, M, N] (R the product of
    its leading axes, batch-major; M = 1 for a 2-d x), element (r, i, j) is
    kept where keep_mask(seed, global_rows(R)[r], i, j) holds. heads=(h0,
    H) for attention weights [B, h, Lq, Lkv] of a rank that holds heads
    h0 .. h0 + h - 1 of H: its row r is then global_rows(B)[b] * H + h0 +
    head. It is not jax.random's mask: the two agree in distribution."""
    if rate == 0.0 or seed is None:
        return x
    dev = x.device
    R, M, N = (x.shape[0], 1, x.shape[1]) if x.dim() == 2 else (
        math.prod(x.shape[:-2]), x.shape[-2], x.shape[-1])
    if heads is None:
        rows = global_rows(R, dev)
    else:
        B, h = x.shape[:2]
        h0, H = heads
        rows = (global_rows(B, dev)[:, None] * H + h0
                + torch.arange(h, device=dev)).reshape(-1)
    keep = keep_mask(seed, rows[:, None, None],
                     torch.arange(M, device=dev)[:, None],
                     torch.arange(N, device=dev)[None, :], rate)
    return torch.where(keep.view(x.shape), x / (1.0 - rate),
                       torch.zeros_like(x)).to(x.dtype)


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

    def forward(self, x, plain=False):
        return layer_norm(x, self.g, self.b, plain=plain)


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
    """One named table, e.g. an embedding {"weight"}: normal with std, or
    uniform in [-bound, bound) when bound is given (an unshared x_out)."""

    def __init__(self, shape, std, name="weight", bound=None, device=None):
        super().__init__()
        self.std, self.name, self.bound = std, name, bound
        self.register_parameter(name, _param(shape, device))

    def init_(self, gen):
        if self.bound is not None:
            getattr(self, self.name).uniform_(-self.bound, self.bound,
                                              generator=gen)
        else:
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
