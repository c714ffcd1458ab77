"""LayerNorm of the port: wrappers, plain versions, autograd and launch
counts.

Replaces the Pallas kernels of jukebox_tpu/ops/pallas/layer_norm.py
(`layer_norm_pallas`: _fwd / _fwd_kernel and _bwd_rule / _bwd_kernel).
Two CUDA kernels (csrc/layer_norm.cu) compute, on rows x [N, D] in fp32,
bf16 or fp16 with fp32 g, b [D]:

    layer_norm_fwd (x, g, b)            -> y (x's dtype), mu, rstd [N] fp32
    layer_norm_bwd (x, g, mu, rstd, dy) -> dx (x's dtype), dg, db [D] fp32

with fp32 statistics (mean, then the variance of the centred row; eps
1e-5), dx = (g dy - xhat c1 - c2) rstd for c1 = mean(xhat g dy) and
c2 = mean(g dy), and dg, db summed over rows: the kernel writes one partial
row per block of ROWS_PER_BLOCK rows and the wrapper sums the partials with
torch.sum, as the JAX wrapper sums its kernel's partials.

Each wrapper takes the plain PyTorch version for tensors on the CPU (what
the CPU tests run) and, for CUDA tensors, checks them, launches its kernel
on the current stream, raises if the launch failed, and adds one to
LAUNCHES[name]; there is no fallback from a CUDA tensor to the plain
version. `layer_norm(..., plain=True)` runs the plain versions on any
device: the reference a kernel run is held against.
"""

import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.decode_stack import _check, _require, _stream

LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}
# per LayerNorm of a transformer block and train step under
# checkpoint_res=1: the forward runs again in the backward's recompute
LAUNCHES_PER_STEP = {"layer_norm_fwd": 2, "layer_norm_bwd": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROWS_PER_BLOCK = 32
MAX_WIDTH = 12288  # the backward keeps 4 rows of fp32 in shared memory
EPS = 1e-5
# A kernel's output x agrees with its plain version r when every element
# has |x - r| <= AGREE_ULPS eps(dtype) |r| + AGREE_ATOL rms(r): both round
# an fp32 value to the output dtype and may land AGREE_ULPS steps apart
# (eps the dtype's machine epsilon, one step of a value in [1, 2)), and the
# fp32 values differ by the order of the row sums (mean, variance, c1, c2;
# dg and db sum over the rows), an absolute error of the tensor's scale.
AGREE_ULPS, AGREE_ATOL = 2.0, 1e-4


def agreement(x, ref):
    """The worst |x - ref| over its bound (AGREE_ULPS, AGREE_ATOL) across
    all elements: x agrees with ref when this is <= 1."""
    r = ref.float()
    rms = r.pow(2).mean().sqrt().item()
    bound = (AGREE_ULPS * torch.finfo(ref.dtype).eps * r.abs()
             + AGREE_ATOL * max(rms, 1e-30))
    return ((x.float() - r).abs() / bound).max().item()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions: fp32 arithmetic, rounded to x's dtype at the end
# ---------------------------------------------------------------------------

def layer_norm_fwd_plain(x, g, b, eps=EPS):
    xf = x.float()
    mu = xf.mean(dim=-1)
    xc = xf - mu[:, None]
    rstd = torch.rsqrt(xc.square().mean(dim=-1) + eps)
    return (xc * rstd[:, None] * g + b).to(x.dtype), mu, rstd


def layer_norm_bwd_plain(x, g, mu, rstd, dy):
    dyf = dy.float()
    xhat = (x.float() - mu[:, None]) * rstd[:, None]
    wdy = dyf * g
    c1 = (xhat * wdy).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd[:, None]).to(x.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _require_rows(x, name, dtype=None, shape=None):
    """x [N, D] contiguous on the card in a kernel dtype (element loads:
    no alignment beyond the element's). Returns (N, D)."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like the others")
    if x.dim() != 2 or x.dtype not in DTYPES or (dtype and x.dtype != dtype):
        raise TypeError(f"{name} must be [N, D] fp32, bf16 or fp16"
                        f"{f' ({dtype})' if dtype else ''}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    N, D = x.shape
    if not (1 <= N and 1 <= D <= MAX_WIDTH):
        raise ValueError(f"the LayerNorm kernels take 1 <= D <= {MAX_WIDTH} "
                         f"and N >= 1, got [{N}, {D}]")
    return N, D


def layer_norm_fwd(x, g, b, eps=EPS):
    """x [N, D] -> (y [N, D] in x's dtype, mu [N], rstd [N] fp32)."""
    if not x.is_cuda:
        return layer_norm_fwd_plain(x, g, b, eps)
    N, D = _require_rows(x, "x")
    _require(g, "g", torch.float32, (D,))
    _require(b, "b", torch.float32, (D,))
    y = torch.empty_like(x)
    mu = torch.empty((N,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _check(_build.lib("layer_norm").jk_layer_norm_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), N, D, eps, DTYPES[x.dtype], _stream()),
        "layer_norm_fwd")
    LAUNCHES["layer_norm_fwd"] += 1
    return y, mu, rstd


def layer_norm_bwd(x, g, mu, rstd, dy):
    """(dx [N, D] in x's dtype, dg [D], db [D] fp32) of the forward."""
    if not x.is_cuda:
        return layer_norm_bwd_plain(x, g, mu, rstd, dy)
    N, D = _require_rows(x, "x")
    _require_rows(dy, "dy", x.dtype, (N, D))
    _require(g, "g", torch.float32, (D,))
    _require(mu, "mu", torch.float32, (N,))
    _require(rstd, "rstd", torch.float32, (N,))
    blocks = -(-N // ROWS_PER_BLOCK)
    dx = torch.empty_like(x)
    dg_part = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    db_part = torch.empty_like(dg_part)
    _check(_build.lib("layer_norm").jk_layer_norm_bwd(
        x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(),
        N, D, ROWS_PER_BLOCK, DTYPES[x.dtype], _stream()), "layer_norm_bwd")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg_part.sum(dim=0), db_part.sum(dim=0)


# ---------------------------------------------------------------------------
# autograd and the public function
# ---------------------------------------------------------------------------

class LayerNormFn(torch.autograd.Function):
    """x [..., D] -> LayerNorm(x); saves x, g, mu and rstd (the JAX
    _fwd_rule's residuals) and runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, g, b, eps, plain):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        fwd = layer_norm_fwd_plain if plain else layer_norm_fwd
        y, mu, rstd = fwd(x2, g, b, eps)
        ctx.save_for_backward(x2, g, mu, rstd)
        ctx.plain = plain
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, g, mu, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd_plain if ctx.plain else layer_norm_bwd
        dx, dg, db = bwd(x2, g, mu, rstd, dy.reshape(x2.shape).contiguous())
        return dx.reshape(dy.shape), dg, db, None, None


def layer_norm(x, g, b, eps=EPS, plain=False):
    """LayerNorm over the last axis of x [..., D] with fp32 g, b [D], in x's
    dtype with fp32 statistics (jukebox_tpu.ops.pallas.layer_norm
    .layer_norm_pallas), differentiable. plain=True runs the plain
    versions."""
    if x.shape[-1] == 0 or x.numel() == 0:
        return x.clone()
    return LayerNormFn.apply(x, g, b, eps, plain)
