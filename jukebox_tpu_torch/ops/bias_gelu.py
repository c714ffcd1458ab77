"""The transformer MLP's c_fc bias add and quick_gelu as one kernel pair:
wrappers, plain versions, autograd and launch counts.

Replaces no Pallas kernel (the JAX package leaves dense's bias add and
quick_gelu to XLA's fusion). Two CUDA kernels (csrc/bias_gelu.cu) compute,
on rows y [N, D] (the product x @ w, before its bias) in fp32, bf16 or fp16
with an fp32 bias b [D]:

    bias_gelu_fwd (y, b)     -> o (y's dtype)
    bias_gelu_bwd (y, b, do) -> dpre (y's dtype), db [D] fp32

with s = y + b, o = s / (1 + exp(-1.702 s)) and, for sg = 1 / (1 +
exp(-1.702 s)), dpre = do (sg + 1.702 s sg (1 - sg)), all in fp32 and
rounded once; db sums dpre over the rows before it is rounded: each of the
backward's row blocks writes one partial row and the wrapper sums the
partials with torch.sum, as ops/layer_norm.py does its dg and db.

Each wrapper takes the plain PyTorch version for tensors on the CPU and,
for CUDA tensors, checks them, launches its kernel on the current stream,
raises if the launch failed, and adds one to LAUNCHES[name]; there is no
fallback from a CUDA tensor to the plain version.
`bias_quick_gelu(..., plain=True)` runs the plain versions on any device:
the reference a kernel run is held against, with ops/layer_norm.py
`agreement`: the two round the same fp32 expression to the output dtype
and may land its steps apart where the card's expf and division differ
from PyTorch's in the last fp32 bits, and db sums the rows in another
order, an absolute error of the tensor's scale.
"""

import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.decode_stack import _check, _stream, sm_count
from jukebox_tpu_torch.ops.layer_norm import DTYPES, _vec

LAUNCHES = {"bias_gelu_fwd": 0, "bias_gelu_bwd": 0}
# per MLP of a transformer block and train step under checkpoint_res=1:
# the forward runs again in the backward's recompute
LAUNCHES_PER_STEP = {"bias_gelu_fwd": 2, "bias_gelu_bwd": 1}
ALPHA = 1.702
# The kernels' grids: a block of up to MAX_THREADS lanes spans one column
# tile of its rows; the forward a row block per FWD_ROWS rows (the rows a
# thread loads at once, csrc/bias_gelu.cu kRows; many waves), the backward
# BWD_BLOCKS_PER_SM row blocks per SM over all the column tiles (one wave,
# kBwdBlocksPerSm), each writing one partial row of db
# (scripts/chip_bias_gelu_probe.py times 4-64 rows a forward block and 1-8
# backward blocks per SM).
MAX_THREADS = 256
FWD_ROWS = 4
BWD_BLOCKS_PER_SM = 2


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions: the kernels' fp32 arithmetic, rounded to y's dtype
# ---------------------------------------------------------------------------

def bias_gelu_fwd_plain(y, b):
    s = y.float() + b.float()
    return (s / (1.0 + torch.exp(-ALPHA * s))).to(y.dtype)


def bias_gelu_bwd_plain(y, b, do):
    t = ALPHA * (y.float() + b.float())
    sg = 1.0 / (1.0 + torch.exp(-t))
    d = do.float() * (sg + t * sg * (1.0 - sg))
    return d.to(y.dtype), d.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def layout(D, itemsize, vec):
    """(VEC, threads, tiles) of both kernels over rows of D elements: VEC
    elements a lane (16 bytes where vec, else 1), a block of the row's
    lanes rounded up to whole warps, at most MAX_THREADS, and the column
    tiles of that many lanes that cover the row."""
    VEC = 16 // itemsize if vec else 1
    lanes = -(-D // VEC)
    threads = min(MAX_THREADS, -(-lanes // 32) * 32)
    return VEC, threads, -(-lanes // threads)


def fwd_blocks(N):
    """Row blocks of a bias_gelu_fwd launch over N rows: block x takes the
    rows N x // blocks .. N (x + 1) // blocks - 1."""
    return -(-N // FWD_ROWS)


def bwd_blocks(N, tiles, sms):
    """Row blocks of a bias_gelu_bwd launch over N rows in `tiles` column
    tiles, taking their rows as fwd_blocks's do: BWD_BLOCKS_PER_SM blocks
    per SM in all, at least one, at most one a row."""
    return max(1, min(N, BWD_BLOCKS_PER_SM * sms // tiles))


def _require_rows(t, name, dtype=None, shape=None):
    """t [N, D] contiguous on the card in a kernel dtype, N, D >= 1 (any
    alignment: the kernels read 16 bytes a lane where the width and the
    pointers allow, else elements). Returns (N, D)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor like the others")
    if t.dim() != 2 or t.dtype not in DTYPES or (dtype and t.dtype != dtype):
        raise TypeError(f"{name} must be [N, D] fp32, bf16 or fp16"
                        f"{f' ({dtype})' if dtype else ''}, got "
                        f"{tuple(t.shape)} {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name} must not be empty, got {tuple(t.shape)}")
    return t.shape


def _require_bias(b, D):
    if not (b.is_cuda and b.dtype == torch.float32 and b.dim() == 1
            and b.shape[0] == D and b.is_contiguous()):
        raise TypeError(f"b must be a contiguous fp32 [{D}] CUDA tensor, got "
                        f"{tuple(b.shape)} {b.dtype} on {b.device}")


def bias_gelu_fwd(y, b):
    """y [N, D], b [D] fp32 -> o [N, D] in y's dtype."""
    if not y.is_cuda:
        return bias_gelu_fwd_plain(y, b)
    N, D = _require_rows(y, "y")
    _require_bias(b, D)
    o = torch.empty_like(y)
    vec = _vec(D, y, o, b)
    _, threads, _ = layout(D, y.element_size(), vec)
    _check(_build.lib("bias_gelu").jk_bias_gelu_fwd(
        y.data_ptr(), b.data_ptr(), o.data_ptr(), N, D, fwd_blocks(N),
        int(vec), threads, DTYPES[y.dtype], _stream()), "bias_gelu_fwd")
    _build.count(LAUNCHES, "bias_gelu_fwd")
    return o


def bias_gelu_bwd(y, b, do):
    """(dpre [N, D] in y's dtype, db [D] fp32) of the forward at y, b for
    the output gradient do."""
    if not y.is_cuda:
        return bias_gelu_bwd_plain(y, b, do)
    N, D = _require_rows(y, "y")
    _require_rows(do, "do", y.dtype, (N, D))
    _require_bias(b, D)
    dpre = torch.empty_like(y)
    vec = _vec(D, y, do, dpre, b)
    _, threads, tiles = layout(D, y.element_size(), vec)
    blocks = bwd_blocks(N, tiles, sm_count(y.device))
    part = torch.empty((blocks, D), dtype=torch.float32, device=y.device)
    _check(_build.lib("bias_gelu").jk_bias_gelu_bwd(
        y.data_ptr(), b.data_ptr(), do.data_ptr(), dpre.data_ptr(),
        part.data_ptr(), N, D, blocks, int(vec), threads, DTYPES[y.dtype],
        _stream()), "bias_gelu_bwd")
    _build.count(LAUNCHES, "bias_gelu_bwd")
    return dpre, part.sum(dim=0)


# ---------------------------------------------------------------------------
# autograd and the public function
# ---------------------------------------------------------------------------

class BiasGeluFn(torch.autograd.Function):
    """y [..., D], b [D] -> quick_gelu(y + b); saves y (before the bias)
    and b, and runs the backward kernel."""

    @staticmethod
    def forward(ctx, y, b, plain):
        shape = y.shape
        y2 = y.reshape(-1, shape[-1]).contiguous()
        b32 = b.float().contiguous()
        fwd = bias_gelu_fwd_plain if plain else bias_gelu_fwd
        ctx.save_for_backward(y2, b32)
        ctx.plain, ctx.b_dtype = plain, b.dtype
        return fwd(y2, b32).reshape(shape)

    @staticmethod
    def backward(ctx, do):
        y2, b32 = ctx.saved_tensors
        bwd = bias_gelu_bwd_plain if ctx.plain else bias_gelu_bwd
        dpre, db = bwd(y2, b32, do.reshape(y2.shape).contiguous())
        return dpre.reshape(do.shape), db.to(ctx.b_dtype), None


def bias_quick_gelu(y, b, plain=False):
    """quick_gelu(y + b) over the last axis of y [..., D] with b [D], in
    y's dtype, computed in fp32 and rounded once, differentiable.
    plain=True runs the plain versions."""
    if y.numel() == 0:
        return y + b.to(y.dtype)
    return BiasGeluFn.apply(y, b, plain)
