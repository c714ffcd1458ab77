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
c2 = mean(g dy), and dg, db summed over rows: each of the backward's
bwd_blocks(N) blocks writes one partial row of each over its share of the
rows and the wrapper sums the partials with torch.sum, as the JAX wrapper
sums its kernel's partials.

Each wrapper takes the plain PyTorch version for tensors on the CPU (what
the CPU tests run) and, for CUDA tensors, checks them, launches its kernel
on the current stream, raises if the launch failed, and adds one to
LAUNCHES[name]; there is no fallback from a CUDA tensor to the plain
version. `layer_norm(..., plain=True)` runs the plain versions on any
device: the reference a kernel run is held against.
"""

import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.decode_stack import (H100_SMS, _check, _require,
                                                _stream, sm_count)

LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}
# per LayerNorm of a transformer block and train step under
# checkpoint_res=1: the forward runs again in the backward's recompute
LAUNCHES_PER_STEP = {"layer_norm_fwd": 2, "layer_norm_bwd": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The kernels' grids (each block 256 threads at the training widths): the
# forward a block per group of rows it loads at once, the backward
# BWD_BLOCKS_PER_SM blocks per SM, each taking an even share of the rows
# and writing one partial row of dg and db (scripts/chip_gemv_ln_probe.py
# times the forward at 1-8 blocks per SM and a block per 2, 4 or 8 rows,
# the backward at 1-4 blocks per SM).
BWD_BLOCKS_PER_SM = 2
GROUP_ROWS = 4  # rows a block loads before reducing any, at CV 1 vectors
MAX_WIDTH = 12288  # the widest row: 768 threads of 16 elements
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

def fwd_blocks(N, rows):
    """Blocks of a layer_norm_fwd launch over N rows, `rows` a group
    (row_layout): block b takes the rows N b // blocks .. N (b + 1) //
    blocks - 1, at most one group."""
    return -(-N // rows)


def bwd_blocks(N, sms=H100_SMS):
    """Blocks of a layer_norm_bwd launch over N rows, each taking its rows
    as fwd_blocks's do, in groups, and writing one partial row of dg and
    one of db."""
    return min(N, BWD_BLOCKS_PER_SM * sms)


def row_layout(D, itemsize, vec):
    """(VEC, CV, threads, rows) of both kernels over rows of D elements:
    thread t of a block owns the vectors t, t + threads, ... (CV of them) of
    VEC elements each, and a block loads `rows` rows before reducing any
    (GROUP_ROWS at one vector a thread, else 1). vec: 16-byte vectors
    (VEC = 16 // itemsize) at the fewest CV for which a row takes at most
    256 threads, else the most (2; fp32 4 past 512 vectors); else single
    elements, 16 a thread. threads is the row's share rounded up to whole
    warps."""
    if vec:
        VEC = 16 // itemsize
        nvec = D // VEC
        CV = 1 if nvec <= 256 else 4 if VEC == 4 and nvec > 512 else 2
    else:
        VEC, CV = 1, 16
    per_row = -(-(D // VEC) // CV)
    rows = GROUP_ROWS if CV == 1 and VEC > 1 else 1
    return VEC, CV, -(-per_row // 32) * 32, rows


def _vec(D, x, *others):
    """Whether rows of x (and the others, same layout) take 16-byte
    vectors: D * itemsize % 16 == 0 and every pointer 16-byte aligned."""
    return (D * x.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def _require_rows(x, name, dtype=None, shape=None):
    """x [N, D] contiguous on the card in a kernel dtype (any alignment:
    the kernels read 16 bytes a lane where the width and pointers allow,
    else elements). Returns (N, D)."""
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
    vec = _vec(D, x, y)
    _, cv, _, rows = row_layout(D, x.element_size(), vec)
    _check(_build.lib("layer_norm").jk_layer_norm_fwd(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), N, D, eps, fwd_blocks(N, rows), int(vec), cv,
        DTYPES[x.dtype], _stream()), "layer_norm_fwd")
    _build.count(LAUNCHES, "layer_norm_fwd")
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
    blocks = bwd_blocks(N, sm_count(x.device))
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, D), dtype=torch.float32, device=x.device)
    vec = _vec(D, x, dy, dx)
    cv = row_layout(D, x.element_size(), vec)[1]
    _check(_build.lib("layer_norm").jk_layer_norm_bwd(
        x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), part.data_ptr(), N, D, blocks,
        int(vec), cv, DTYPES[x.dtype], _stream()), "layer_norm_bwd")
    _build.count(LAUNCHES, "layer_norm_bwd")
    dgb = part.sum(dim=0)
    return dx, dgb[0], dgb[1]


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
