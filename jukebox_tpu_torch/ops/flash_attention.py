"""Causal flash attention of the port: wrappers, plain versions, keep mask,
autograd and launch counts.

Replaces the Pallas kernels of jukebox_tpu/ops/pallas/flash_attention.py
(`flash_dense_attn`: _fwd_kernel, _dq_kernel, _dkv_kernel), which the JAX
package runs for the long dense (f0) layers of a prior's teacher-forced
forward and its gradient. Here three CUDA kernels (csrc/flash_attention.cu)
compute the same function on heads [BH, L, hd] bf16:

    flash_fwd  (q, k, v)                 -> out, lse [BH, L] fp32
    flash_dq   (q, k, v, g, lse, dd)     -> dq
    flash_dkv  (q, k, v, g, lse, dd)     -> dk, dv

with dd = sum(g * out) in fp32 computed between the passes by plain torch
ops, as the JAX wrapper computes it outside its kernels. Scores are
(q_fp32 / sqrt(hd)) . k_fp32, set to NEG = -1e9 where q_pos < kv_pos; the
softmax denominator sums the undropped weights and the weights that multiply
V are dropped by `keep_mask` (the murmur3 hash of the Pallas `_keep_mask`,
bit for bit) and scaled by 1 / (1 - rate).

On the card each kernel runs one block per work item of a host schedule
(fwd_schedule, dq_schedule, dkv_schedule: longest first, the longest
tiles split in two halves that the kernel merges in a fixed order), kept
per shape with its workspace.

Each wrapper takes the plain PyTorch version for tensors on the CPU (what
the CPU tests run) and, for CUDA tensors, checks them, launches its kernel
on the current stream, raises if the launch failed, and adds one to
LAUNCHES[name]; there is no fallback from a CUDA tensor to the plain
version. `flash_dense_attn(..., plain=True)` runs the plain versions on any
device: the reference a kernel run is held against.
"""

import math

import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.core import (_M32, global_rows, keep_mask,
                                        keep_threshold)
from jukebox_tpu_torch.ops.decode_stack import (_check, _require, _stream,
                                                sm_count, workspace)

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# launches per f0 layer and train step under checkpoint_res=1: the forward
# runs once in the forward pass and once in the backward's recompute
LAUNCHES_PER_STEP = {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
NEG = -1e9
MAX_HEAD_DIM = 256
BF16 = torch.bfloat16
# A kernel's heads x [BH, L, hd] agree with its plain version r when every
# element has |x - r| <= AGREE_RTOL |r| + AGREE_ATOL s, s the RMS of r's row
# (one position of one head), floored at ROW_FLOOR x the RMS of all of r
# (dq's first row is exactly 0). AGREE_RTOL, two bf16 steps: both round
# their fp32 results to bf16 and can land a step apart. AGREE_ATOL: the
# kernels round p (and scale * ds) to bf16 for their second products where
# the plain versions keep fp32, an error of ~2^-9 of each term, which sums
# to a few thousandths of the row's RMS. The row scale keeps the bound as
# tight in the late rows, which average thousands of keys and are small, as
# in the first. lse [BH, L]: LSE_TOL of max(1, |r|), fp32 statistics summed
# in another order.
AGREE_RTOL, AGREE_ATOL, ROW_FLOOR, LSE_TOL = 2.0 ** -6, 2.0 ** -5, 1e-2, 1e-5


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def agreement(x, ref):
    """The worst |x - ref| over its bound (see AGREE_RTOL) across all
    elements: x agrees with ref when this is <= 1."""
    r = ref.float()
    err = (x.float() - r).abs()
    if r.dim() == 2:  # lse
        bound = LSE_TOL * r.abs().clamp(min=1.0)
    else:
        row = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
        row = row.clamp(min=ROW_FLOOR * r.pow(2).mean().sqrt().item())
        bound = AGREE_RTOL * r.abs() + AGREE_ATOL * row
    return (err / bound).max().item()


# ---------------------------------------------------------------------------
# plain versions: dense masked attention in fp32, one head row at a time
# ---------------------------------------------------------------------------

def _positions(L, device):
    pos = torch.arange(L, device=device)
    return pos[:, None], pos[None, :]


def _probs(q, k, lse_or_none, scale, qp, kp):
    """Masked fp32 scores of one head row and their softmax: with lse
    given, p = exp(s - lse); else (p unnormalised by the row max, m, l)."""
    s = torch.matmul(q.float() * scale, k.float().t())
    s = torch.where(qp >= kp, s, torch.full_like(s, NEG))
    if lse_or_none is not None:
        return torch.exp(s - lse_or_none[:, None])
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return p, m, p.sum(dim=-1, keepdim=True)


def _drop(x, seed, bh, qp, kp, rate):
    if rate <= 0.0:
        return x
    keep = keep_mask(seed, bh, qp, kp, rate)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def flash_fwd_plain(qh, kh, vh, scale, rate=0.0, seed=0):
    BH, L, _ = qh.shape
    qp, kp = _positions(L, qh.device)
    out = torch.empty_like(qh)
    lse = torch.empty((BH, L), dtype=torch.float32, device=qh.device)
    for bh in range(BH):
        p, m, l = _probs(qh[bh], kh[bh], None, scale, qp, kp)
        p = _drop(p, seed, bh, qp, kp, rate)
        out[bh] = (torch.matmul(p, vh[bh].float()) / l).to(qh.dtype)
        lse[bh] = (m + torch.log(l))[:, 0]
    return out, lse


def _ds(qh, kh, vh, g, lse, dd, scale, rate, seed, bh, qp, kp):
    p = _probs(qh[bh], kh[bh], lse[bh], scale, qp, kp)
    dp = _drop(torch.matmul(g[bh].float(), vh[bh].float().t()), seed, bh, qp,
               kp, rate)
    return p, p * (dp - dd[bh][:, None])


def flash_dq_plain(qh, kh, vh, g, lse, dd, scale, rate=0.0, seed=0):
    qp, kp = _positions(qh.shape[1], qh.device)
    dq = torch.empty_like(qh)
    for bh in range(qh.shape[0]):
        _, ds = _ds(qh, kh, vh, g, lse, dd, scale, rate, seed, bh, qp, kp)
        dq[bh] = (scale * torch.matmul(ds, kh[bh].float())).to(qh.dtype)
    return dq


def flash_dkv_plain(qh, kh, vh, g, lse, dd, scale, rate=0.0, seed=0):
    qp, kp = _positions(qh.shape[1], qh.device)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    for bh in range(qh.shape[0]):
        p, ds = _ds(qh, kh, vh, g, lse, dd, scale, rate, seed, bh, qp, kp)
        p = _drop(p, seed, bh, qp, kp, rate)
        dv[bh] = torch.matmul(p.t(), g[bh].float()).to(vh.dtype)
        dk[bh] = (scale * torch.matmul(ds.t(), qh[bh].float())).to(kh.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _require_heads(tensors, BH, L, hd):
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head widths that are a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    for name, t in tensors.items():
        _require(t, name, BF16, (BH, L, hd))


def _dropout_args(rate, seed):
    """(on, seed as uint32, threshold, 1 / (1 - rate)) of the C entry points."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & _M32, keep_threshold(rate), 1.0 / (1.0 - rate)


# rows of the tiles: forward (q, K/V), dq (q, K/V), dk/dv (K/V, q)
FWD_Q, FWD_KV = 128, 64
DQ_Q, DQ_KV = 64, 64  # flash_attention.cu kDqQ, kDqKV
DKV_KV, DKV_Q = 64, 64


def _longest_first(BH, ranges, sms):
    """Work items of a causal pass whose tile t of each head row reads the
    tiles ranges[t] = (first, end) of the other side: (head row, tile,
    first, end, pair), longest first. Under the causal mask the last tiles
    would bound the launch, so a tile longer than `cut` is split in two
    halves, whose blocks merge their partial sums (pair -1: whole). cut is
    the larger of half the longest tile and the average work per SM, so a
    launch with work enough for every SM is not split. Returns (items,
    number of pairs)."""
    lengths = [end - first for first, end in ranges]
    cut = max(-(-max(lengths) // 2), -(-BH * sum(lengths) // sms))
    items, pairs = [], 0
    for t, (first, end) in enumerate(ranges):
        n = end - first
        for bh in range(BH):
            if n > cut:
                mid = first + n // 2
                items += [(bh, t, first, mid, pairs),
                          (bh, t, mid, end, pairs)]
                pairs += 1
            else:
                items.append((bh, t, first, end, -1))
    items.sort(key=lambda it: it[2] - it[3])  # stable: longest first
    return items, pairs


def _q_ranges(L, bq, bkv):
    """(0, end) K/V tiles of bkv rows read by each q tile of bq rows."""
    return [(0, min(t * bq + bq - 1, L - 1) // bkv + 1)
            for t in range(-(-L // bq))]


def fwd_schedule(BH, L, sms=132):
    """The forward's work items: per q tile of FWD_Q rows, its K/V tiles
    of FWD_KV rows (_longest_first)."""
    return _longest_first(BH, _q_ranges(L, FWD_Q, FWD_KV), sms)


def dq_schedule(BH, L, sms=132):
    """dq's work items: per q tile of DQ_Q rows, its K/V tiles of DQ_KV
    rows (_longest_first)."""
    return _longest_first(BH, _q_ranges(L, DQ_Q, DQ_KV), sms)


def dkv_schedule(BH, L, sms=132):
    """dk/dv's work items: per K/V tile of DKV_KV rows, the q tiles of
    DKV_Q rows on and below the diagonal (_longest_first)."""
    nq = -(-L // DKV_Q)
    return _longest_first(BH, [(t * DKV_KV // DKV_Q, nq)
                               for t in range(-(-L // DKV_KV))], sms)


SCHEDULES = {"flash_fwd": fwd_schedule, "flash_dq": dq_schedule,
             "flash_dkv": dkv_schedule}
_PLANS = {}  # (kernel, device, BH, L) -> (items int32 tensor, pairs)


def _plan(name, device, BH, L, pair_floats):
    """A kernel's work items on the card, kept per shape, and the halves'
    workspace (ops/decode_stack.py workspace) at pair_floats a pair."""
    key = (name, device, BH, L)
    if key not in _PLANS:
        items, pairs = SCHEDULES[name](BH, L, sm_count(device))
        _PLANS[key] = (torch.tensor(items, dtype=torch.int32,
                                    device=device), pairs)
    items, pairs = _PLANS[key]
    ws, cnt = workspace(name, device, pairs * pair_floats, pairs)
    return items, ws, cnt


def flash_fwd(qh, kh, vh, scale, rate=0.0, seed=0):
    """heads [BH, L, hd] bf16 -> (out [BH, L, hd] bf16, lse [BH, L] fp32)."""
    if not qh.is_cuda:
        return flash_fwd_plain(qh, kh, vh, scale, rate, seed)
    BH, L, hd = qh.shape
    _require_heads({"q": qh, "k": kh, "v": vh}, BH, L, hd)
    lib = _build.lib("flash_attention")
    items, ws, cnt = _plan("flash_fwd", qh.device, BH, L,
                           lib.jk_flash_fwd_pair_floats(hd))
    out = torch.empty_like(qh)
    lse = torch.empty((BH, L), dtype=torch.float32, device=qh.device)
    _check(lib.jk_flash_fwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        lse.data_ptr(), items.data_ptr(), items.shape[0], ws.data_ptr(),
        cnt.data_ptr(), BH, L, hd, scale, *_dropout_args(rate, seed),
        _stream()), "flash_fwd")
    _build.count(LAUNCHES, "flash_fwd")
    return out, lse


def _require_rows(lse, dd, BH, L):
    _require(lse, "lse", torch.float32, (BH, L))
    _require(dd, "dd", torch.float32, (BH, L))


def _bwd_args(name, qh, kh, vh, g, lse, dd):
    """Checks of a backward kernel's inputs; its library, work items,
    workspace and counters."""
    BH, L, hd = qh.shape
    _require_heads({"q": qh, "k": kh, "v": vh, "g": g}, BH, L, hd)
    _require_rows(lse, dd, BH, L)
    lib = _build.lib("flash_attention")
    items, ws, cnt = _plan(name, qh.device, BH, L,
                           lib.jk_flash_bwd_pair_floats(hd))
    return lib, (items.data_ptr(), items.shape[0], ws.data_ptr(),
                 cnt.data_ptr(), BH, L, hd)


def flash_dq(qh, kh, vh, g, lse, dd, scale, rate=0.0, seed=0):
    """dq [BH, L, hd] bf16 of the flash forward, given its lse and dd."""
    if not qh.is_cuda:
        return flash_dq_plain(qh, kh, vh, g, lse, dd, scale, rate, seed)
    lib, plan = _bwd_args("flash_dq", qh, kh, vh, g, lse, dd)
    dq = torch.empty_like(qh)
    _check(lib.jk_flash_dq(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), *plan, scale,
        *_dropout_args(rate, seed), _stream()), "flash_dq")
    _build.count(LAUNCHES, "flash_dq")
    return dq


def flash_dkv(qh, kh, vh, g, lse, dd, scale, rate=0.0, seed=0):
    """(dk, dv) [BH, L, hd] bf16 of the flash forward."""
    if not qh.is_cuda:
        return flash_dkv_plain(qh, kh, vh, g, lse, dd, scale, rate, seed)
    lib, plan = _bwd_args("flash_dkv", qh, kh, vh, g, lse, dd)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    _check(lib.jk_flash_dkv(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), *plan,
        scale, *_dropout_args(rate, seed), _stream()), "flash_dkv")
    _build.count(LAUNCHES, "flash_dkv")
    return dk, dv


# ---------------------------------------------------------------------------
# autograd and the public function (dense_attn layout)
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Heads (q, k, v) -> out; the backward is the dq and dk/dv passes."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale, rate, seed, plain):
        fwd = flash_fwd_plain if plain else flash_fwd
        out, lse = fwd(qh, kh, vh, scale, rate, seed)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.cfg = (scale, rate, seed, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        scale, rate, seed, plain = ctx.cfg
        g = g.contiguous()
        dd = (g.float() * out.float()).sum(dim=-1)
        dq_fn, dkv_fn = ((flash_dq_plain, flash_dkv_plain) if plain
                         else (flash_dq, flash_dkv))
        dq = dq_fn(qh, kh, vh, g, lse, dd, scale, rate, seed)
        dk, dv = dkv_fn(qh, kh, vh, g, lse, dd, scale, rate, seed)
        return dq, dk, dv, None, None, None, None


def flash_dense_attn(q, k, v, n_head, dropout_rate=0.0, dropout_seed=None,
                     plain=False, heads=None):
    """Causal dense attention, q, k, v [B, L, S] -> [B, L, S] in q's dtype,
    differentiable (jukebox_tpu.ops.pallas.flash_attention.flash_dense_attn).
    dropout_rate > 0 drops attention weights inside the kernels by the
    keep mask of dropout_seed (an int) at the global head row global_rows
    (b) * H + h (ops/core.py dropout's rows; heads=(h0, H) for a rank
    holding heads h0.. of H): the kernels key head row bh on seed + bh *
    0xC2B2AE3D, so the seed carries the offset, one launch for all rows
    where it is one offset (the rows consecutive, the heads all) and one a
    batch row where not. plain=True runs the plain versions."""
    B, L, S = q.shape
    if k.shape != (B, L, S) or v.shape != (B, L, S):
        raise ValueError(f"q, k, v must share one shape, got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    hd = S // n_head
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("flash attention dropout needs a seed")
    seed = int(dropout_seed) if rate > 0.0 else 0

    def split(x):
        return (x.reshape(x.shape[0], L, n_head, hd).transpose(1, 2)
                .reshape(-1, L, hd).contiguous())

    def attend(q_, k_, v_, bh0):
        out = FlashAttention.apply(
            split(q_), split(k_), split(v_), 1.0 / math.sqrt(hd), rate,
            (seed + bh0 * 0xC2B2AE3D) & _M32 if rate > 0.0 else 0, plain)
        return out.reshape(-1, n_head, L, hd).transpose(1, 2).reshape(
            -1, L, S)
    if rate == 0.0:
        return attend(q, k, v, 0)
    h0, H = heads or (0, n_head)
    rows = global_rows(B).tolist()
    if B == 1 or (H == n_head and rows == list(range(rows[0],
                                                      rows[0] + B))):
        return attend(q, k, v, rows[0] * H + h0)
    return torch.cat([attend(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                             rows[b] * H + h0) for b in range(B)])
