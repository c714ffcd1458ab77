"""Fused multi-tensor Adam of the port: wrapper, plain version, launch
counts.

Replaces the Pallas kernel of jukebox_tpu/ops/pallas/adam.py
(`adam_update_pallas`: _leaf_update / _adam_kernel, one launch per leaf)
and covers the fp16-moment form of jukebox_tpu/utils/train_utils.py
adam_update as well. One call updates every tensor of the optimizer state
through csrc/adam.cu: the reference's step (fp16.py:12-29)

    g = grad / scale;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= step_size (m / (sqrt(v) + eps) + wd p),
    step_size = lr sqrt(1 - b2^t) / (1 - b1^t)

with fp32 moments, or fp16 moments stored as x / s with a per-tensor fp32
scale s = 1e-8 + max|x| / 65504 (jk_adam, one entry for both). The
parameters, moments and scales are updated in place.

AdamTable holds the device table of the launch (pointers, sizes, the
work items of item_order and their counts per tensor) and the kernel's
state (per-tensor maxima and counts, the item ticket: zero, and left zero
by every launch), built once per optimizer state and kept in
opt_state[TABLE_KEY]; a step uploads only its gradient pointers (each
backward makes new gradient tensors) and passes scalars. `adam_update`
takes the plain version (a loop over the tensors) for parameters on the
CPU and launches the kernel for parameters on the card, adding one to
LAUNCHES["adam_update"] per update: one CUDA launch in either form, no
memset; there is no fallback from CUDA tensors to the plain version.
"""

import numpy as np
import torch

from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops.decode_stack import _check, _stream, sm_count

LAUNCHES = {"adam_update": 0}
FLOAT16_MAX = 65504.0  # reference FP16FusedAdam.FLOAT16_MAX (fp16.py:146)
CHUNK = 4096           # elements per work item (a multiple of 8)
AMAX, UPDATE, BOTH = 0, 1, 2  # item kinds (csrc/adam.cu Kind)
TABLE_KEY = "_adam_table"
_F32 = np.float32


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def step_scalars(step, lr, beta1, beta2):
    """fp32 host scalars of update number `step`: (step_size, b1, b2,
    1 - b1, 1 - b2) as Python floats holding fp32 values."""
    b1, b2 = _F32(beta1), _F32(beta2)
    bias1 = _F32(1) - b1 ** _F32(step)
    bias2 = _F32(1) - b2 ** _F32(step)
    step_size = torch.as_tensor(lr, dtype=torch.float32).cpu() \
        * float(np.sqrt(bias2)) / float(bias1)
    return (float(step_size), float(b1), float(b2), float(_F32(1) - b1),
            float(_F32(1) - b2))


# ---------------------------------------------------------------------------
# plain version: one tensor at a time
# ---------------------------------------------------------------------------

@torch.no_grad()
def adam_update_plain(params, grads, opt_state, lr, beta1, beta2, eps,
                      weight_decay, scale=1.0):
    """The update as a loop of PyTorch ops over the tensors, each rounded
    as its own op: the kernel's reference. Updates params in place and
    replaces the moment (and scale) tensors in opt_state. Returns
    opt_state."""
    fp16_state = "m_scale" in opt_state
    step = opt_state["step"] + 1
    step_size, b1, b2, c1, c2 = step_scalars(step, lr, beta1, beta2)
    on_device = {}  # device -> (step_size, scale) there
    for name, p in params.items():
        if p.device not in on_device:
            on_device[p.device] = (
                torch.tensor(step_size, dtype=torch.float32, device=p.device),
                torch.as_tensor(scale, dtype=torch.float32, device=p.device))
        step_dev, scale_dev = on_device[p.device]
        g = grads.get(name)
        g = torch.zeros_like(p) if g is None else g
        g = g.float() / scale_dev
        m, v = opt_state["m"][name], opt_state["v"][name]
        if fp16_state:
            m = m.float() * opt_state["m_scale"][name]
            v = v.float() * opt_state["v_scale"][name]
        m = b1 * m + c1 * g
        v = b2 * v + c2 * g * g
        denom = torch.sqrt(v) + eps
        p.sub_(step_dev * (m / denom + weight_decay * p))
        if fp16_state:
            for key, x in (("m", m), ("v", v)):
                s = 1e-8 + x.abs().max() / FLOAT16_MAX
                opt_state[key][name] = (x / s).half()
                opt_state[key + "_scale"][name] = s
        else:
            opt_state["m"][name], opt_state["v"][name] = m, v
    opt_state["step"] = step
    return opt_state


# ---------------------------------------------------------------------------
# the kernel's table and wrapper
# ---------------------------------------------------------------------------

def _ptr_tensor(values, device, dtype=torch.int64):
    return torch.tensor(values, dtype=dtype).to(device)


def item_order(sizes, fp16, chunk=None):
    """The kernel's work items, in the order its blocks claim them: a list
    of (tensor, start, kind) over chunks of `chunk` elements (default
    CHUNK, the items AdamTable launches). fp32 moments:
    every chunk an UPDATE item, tensors and chunks in order. fp16 moments:
    for each tensor, its chunks as AMAX items in order, then as UPDATE
    items in reverse (the bytes the amax pass read last are re-read first,
    from L2); a tensor of one chunk is one BOTH item."""
    chunk = CHUNK if chunk is None else chunk
    items = []
    for k, n in enumerate(sizes):
        starts = list(range(0, n, chunk))
        if not fp16:
            items += [(k, s, UPDATE) for s in starts]
        elif len(starts) == 1:
            items.append((k, 0, BOTH))
        else:
            items += [(k, s, AMAX) for s in starts]
            items += [(k, s, UPDATE) for s in reversed(starts)]
    return items


class AdamTable:
    """The launch's device table over the tensors of `params` and
    `opt_state` (their pointers and sizes, the work items of item_order and
    each tensor's count of amax and of update items) and the kernel's
    state (zero; every launch leaves it zero). `items` (a list of (tensor,
    start, kind) over chunks of CHUNK elements) may be given to launch
    another walk, e.g. one that leaves an item out."""

    def __init__(self, params, opt_state, items=None):
        self.names = list(params)
        self.fp16 = "m_scale" in opt_state
        keys = ("m", "v", "m_scale", "v_scale") if self.fp16 else ("m", "v")
        self.tensors = {"p": [params[n] for n in self.names]}
        for k in keys:
            self.tensors[k] = [opt_state[k][n] for n in self.names]
        mdtype = torch.float16 if self.fp16 else torch.float32
        device = self.tensors["p"][0].device
        for i, n in enumerate(self.names):
            p = self.tensors["p"][i]
            _require_flat(p, n, torch.float32, p.numel(), device)
            for k in ("m", "v"):
                _require_flat(self.tensors[k][i], f"{k} of {n}", mdtype,
                              p.numel(), device)
            if self.fp16:
                for k in ("m_scale", "v_scale"):
                    _require_flat(self.tensors[k][i], f"{k} of {n}",
                                  torch.float32, 1, device)
        self.device = device
        self.chunk = CHUNK  # the items' length
        sizes = [p.numel() for p in self.tensors["p"]]
        if items is None:
            items = item_order(sizes, self.fp16)
        self.items = list(items)
        T = len(self.names)
        n_amax, n_upd = [0] * T, [0] * T
        for k, _, kind in self.items:
            n_amax[k] += kind == AMAX
            n_upd[k] += kind == UPDATE
        self.p_ptrs = [p.data_ptr() for p in self.tensors["p"]]
        self.dev = {k: _ptr_tensor([t.data_ptr() for t in ts], device)
                    for k, ts in self.tensors.items()}
        self.dev["size"] = _ptr_tensor(sizes, device)
        for key, col, dtype in (("item_tensor", 0, torch.int32),
                                ("item_start", 1, torch.int64),
                                ("item_kind", 2, torch.int32)):
            self.dev[key] = _ptr_tensor([it[col] for it in self.items],
                                        device, dtype)
        self.dev["n_amax"] = _ptr_tensor(n_amax, device, torch.int32)
        self.dev["n_upd"] = _ptr_tensor(n_upd, device, torch.int32)
        self.amax = torch.zeros((2 * T,), dtype=torch.float32, device=device)
        self.done = torch.zeros((2 * T,), dtype=torch.int32, device=device)
        self.ticket = torch.zeros((2,), dtype=torch.int32, device=device)

    def matches(self, params, opt_state):
        """Whether params and opt_state still hold the tensors of this
        table (the same objects on the same storage)."""
        if list(params) != self.names:
            return False
        if ("m_scale" in opt_state) != self.fp16:
            return False
        if any(a is not b or a.data_ptr() != ptr for a, b, ptr in zip(
                self.tensors["p"], params.values(), self.p_ptrs)):
            return False
        return all(a is not None and a is opt_state[k].get(n)
                   for k, ts in self.tensors.items() if k != "p"
                   for n, a in zip(self.names, ts))

    def grad_ptrs(self, grads):
        """The step's gradient pointers on the card (0 for a None
        gradient), each gradient checked against its parameter."""
        ptrs = []
        for n, p in zip(self.names, self.tensors["p"]):
            g = grads.get(n)
            if g is None:
                ptrs.append(0)
                continue
            _require_flat(g, f"gradient of {n}", torch.float32, p.numel(),
                          self.device)
            ptrs.append(g.data_ptr())
        host = torch.tensor(ptrs, dtype=torch.int64)
        if self.device.type == "cuda":  # an asynchronous copy
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)


def _require_flat(t, name, dtype, numel, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the update on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous with {numel} elements, "
                         f"got {tuple(t.shape)}")


def table_for(params, opt_state):
    """opt_state's AdamTable, built on first use and rebuilt when the
    state or the parameters are other tensors than it was built on."""
    table = opt_state.get(TABLE_KEY)
    if table is None or not table.matches(params, opt_state):
        table = AdamTable(params, opt_state)
        opt_state[TABLE_KEY] = table
    return table


def launch_args(table, grads, opt_state, lr, beta1, beta2, eps,
                weight_decay, scale=1.0):
    """The argument list of csrc/adam.cu's jk_adam for one update of
    `table` (update number opt_state["step"] + 1) on a persistent grid of
    the blocks an SM the kernel is built for (jk_adam_blocks_per_sm) on
    every SM."""
    step = opt_state["step"] + 1
    step_size, b1, b2, c1, c2 = step_scalars(step, lr, beta1, beta2)
    scale_dev = torch.as_tensor(scale, dtype=torch.float32).to(
        table.device).reshape(())
    g = table.grad_ptrs(grads)
    d = table.dev
    blocks = _build.lib("adam").jk_adam_blocks_per_sm() \
        * sm_count(table.device)
    blocks = max(1, min(blocks, len(table.items)))
    fp16 = table.fp16
    return (d["p"].data_ptr(), g.data_ptr(), d["m"].data_ptr(),
            d["v"].data_ptr(), d["m_scale"].data_ptr() if fp16 else None,
            d["v_scale"].data_ptr() if fp16 else None, d["size"].data_ptr(),
            d["item_tensor"].data_ptr(), d["item_start"].data_ptr(),
            d["item_kind"].data_ptr(), d["n_amax"].data_ptr(),
            d["n_upd"].data_ptr(), len(table.items), len(table.names),
            table.chunk, table.amax.data_ptr(), table.done.data_ptr(),
            table.ticket.data_ptr(), blocks, int(fp16), scale_dev.data_ptr(),
            step_size, b1, b2, c1, c2, float(eps), float(weight_decay),
            _stream())


@torch.no_grad()
def adam_update_kernel(table, grads, opt_state, lr, beta1, beta2, eps,
                       weight_decay, scale=1.0):
    """One update of the tensors of `table` through csrc/adam.cu, in place,
    in one launch (launch_args). `scale` (a float or a 0-d tensor) is read
    by the kernel on the card."""
    args = launch_args(table, grads, opt_state, lr, beta1, beta2, eps,
                       weight_decay, scale)
    _check(_build.lib("adam").jk_adam(*args), "adam_update")
    _build.count(LAUNCHES, "adam_update")
    opt_state["step"] += 1
    return opt_state


def adam_update(params, grads, opt_state, lr, beta1, beta2, eps,
                weight_decay, scale=1.0):
    """One Adam step in place (see the module docstring): the kernel for
    parameters on the card, the plain version for parameters on the CPU.
    A None gradient counts as zero. Returns opt_state."""
    if not next(iter(params.values())).is_cuda:
        return adam_update_plain(params, grads, opt_state, lr, beta1, beta2,
                                 eps, weight_decay, scale)
    return adam_update_kernel(table_for(params, opt_state), grads, opt_state,
                              lr, beta1, beta2, eps, weight_decay, scale)
