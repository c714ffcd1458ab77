"""Optimizer, LR schedule, gradient clipping, loss scaling and EMA of the
PyTorch port (counterpart of jukebox_tpu/utils/train_utils.py, itself the
reference's apex FusedAdam / fp16 utilities and EMA variants).

Parameters, gradients and moments are dicts {name: tensor} over a module's
named parameters. Where the JAX functions return new trees, the port updates
in place under torch.no_grad() to keep one copy of the billion-parameter
state on the card; adam_update still takes and returns the state dict. The
scalar arithmetic (bias correction, step size, scales) is fp32, as in the
JAX package.
"""

import contextlib

import torch

from jukebox_tpu_torch.ops import adam as _adam
from jukebox_tpu_torch.parallel.dist import all_reduce_


# ---------------------------------------------------------------------------
# Adam (reference adam_step, fp16.py:12-29)
# ---------------------------------------------------------------------------

def adam_init(params, fp16_state=False):
    """Optimizer state {"m", "v", "step"}: fp32 moments, or with fp16_state
    fp16 moments with per-tensor fp32 rescale factors "m_scale", "v_scale"
    (the reference's FP16FusedAdam, fp16.py:128-226)."""
    if fp16_state:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float16, device=p.device)

        def ones(p):
            return torch.ones((), dtype=torch.float32, device=p.device)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "m_scale": {n: ones(p) for n, p in params.items()},
                "v_scale": {n: ones(p) for n, p in params.items()},
                "step": 0}
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "step": 0}


def adam_update(params, grads, opt_state, lr, beta1, beta2, eps, weight_decay,
                scale=1.0):
    """One Adam step of the reference's form, in place: the gradients are
    divided by `scale` (loss scale x clipping), bias-corrected moments, and
    weight decay inside the update as step_size * (m / denom + wd * p).
    fp16 moments are unscaled to fp32, updated, and renormalised by their
    new per-tensor inf-norm. A None gradient counts as zero. On the card
    one multi-tensor kernel launch (ops/adam.py); on the CPU its plain
    version. Returns opt_state."""
    return _adam.adam_update(params, grads, opt_state, lr, beta1, beta2, eps,
                             weight_decay, scale)


def global_grad_norm(grads, placement=None):
    """L2 norm over every gradient (fp16.py:104-120), an fp32 0-d tensor.
    With a placement (parallel/placement.py) the grads are the rank's
    pieces and the norm is the whole gradient's: each piece's square sum
    weighted by one over the ranks that hold the same piece, summed over
    the world, so a replicated leaf counts once and every rank reads the
    same norm."""
    if placement is None:
        sq = [torch.sum(torch.square(g.float())) for g in grads.values()
              if g is not None]
        return torch.sqrt(torch.stack(sq).sum())
    sq = [torch.sum(torch.square(g.float())) * placement.weight[n]
          for n, g in grads.items() if g is not None]
    total = all_reduce_(torch.stack(sq).sum(), placement.mesh.world_group)
    return torch.sqrt(total)


def clipped_grad_scale(grad_norm, max_grad_norm, scale=1.0):
    """Fold clipping into the gradient divisor (fp16.py:122-126)."""
    clip = grad_norm / max_grad_norm
    return torch.where(clip > 1, clip * scale, torch.as_tensor(
        scale, dtype=clip.dtype, device=clip.device))


# ---------------------------------------------------------------------------
# Dynamic loss scaling (reference LossScalar, fp16.py:68-99)
# ---------------------------------------------------------------------------

class LossScalar:
    def __init__(self, loss_scale, init_scale=2.0 ** 16,
                 scale_factor=2.0 ** (1.0 / 1000), scale_window=1):
        if loss_scale is None:
            self.dynamic = True
            self.loss_scale = init_scale
        else:
            self.dynamic = False
            self.loss_scale = loss_scale
        self.max_loss_scale = 2.0 ** 24
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.unskipped = 0
        self.overflow = False

    def get_scale(self):
        return self.loss_scale

    def update_scale(self, overflow):
        if overflow and self.dynamic:
            self.loss_scale /= 2.0
            self.unskipped = 0
        else:
            self.unskipped += 1
        if self.unskipped == self.scale_window and self.dynamic:
            self.loss_scale = min(self.max_loss_scale,
                                  self.loss_scale * self.scale_factor)
            self.unskipped = 0


def check_overflow(val):
    return (val == float("inf")) or (val == -float("inf")) or (val != val)


# ---------------------------------------------------------------------------
# LR schedule (reference get_lr_scheduler, train.py:62-76)
# ---------------------------------------------------------------------------

def make_lr_schedule(hps):
    """step -> learning rate, an fp32 0-d tensor on the CPU."""
    def lr_lambda(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        if hps.lr_use_linear_decay:
            lr_scale = hps.lr_scale * torch.clamp(step / hps.lr_warmup, max=1.0)
            decay = torch.clamp(
                1.0 - torch.clamp(step - hps.lr_start_linear_decay, min=0.0)
                / hps.lr_decay, min=0.0)
            return hps.lr * lr_scale * decay
        return (hps.lr * hps.lr_scale
                * (hps.lr_gamma ** torch.floor(step / hps.lr_decay))
                * torch.clamp(step / hps.lr_warmup, max=1.0))
    return lr_lambda


# ---------------------------------------------------------------------------
# EMA of parameters (reference EMA / CPUEMA, utils/ema.py)
# ---------------------------------------------------------------------------

class EMA:
    """fp32 shadow of the params on their device, updated every `freq`
    steps with mu ** freq (ema.py:6-23); swap() for eval or checkpoints."""

    def __init__(self, params, mu=0.999, freq=1):
        self.mu = mu ** freq
        self.freq = freq
        self.steps = 0
        self.shadow = {n: p.detach().float().clone()
                       for n, p in params.items()}

    @torch.no_grad()
    def step(self, params):
        self.steps += 1
        if self.steps % self.freq == 0:
            for n, p in params.items():
                s = self.shadow[n]
                s.copy_(self.mu * s + (1.0 - self.mu) * p.float())

    def swap(self, params):
        """(ema params, stashed params): the caller swaps back after."""
        return self.shadow, params

    @torch.no_grad()
    def exchange(self, params):
        """Exchange the params' values with the shadow's in place, one
        tensor at a time (no second copy of the params on their device);
        a second call undoes the first."""
        for n, p in params.items():
            held = p.detach().float().clone()
            p.copy_(self.shadow[n])
            self.shadow[n].copy_(held)


class CPUEMA:
    """EMA shadow in host memory as fp32 numpy arrays, updated every `freq`
    steps with mu ** freq (the reference CPUEMA, ema.py:26-54): one
    device-to-host pull of the params per update, one tensor at a time, and
    no shadow on the card."""

    def __init__(self, params, mu=0.999, freq=100):
        self.mu = mu ** freq
        self.freq = freq
        self.steps = 0
        self.shadow = {n: p.detach().float().cpu().numpy().copy()
                       for n, p in params.items()}

    @torch.no_grad()
    def step(self, params):
        self.steps += 1
        if self.steps % self.freq == 0:
            for n, p in params.items():
                host = p.detach().float().cpu().numpy()
                self.shadow[n] = self.mu * self.shadow[n] \
                    + (1.0 - self.mu) * host

    def swap(self, params):
        return self.shadow, params

    @torch.no_grad()
    def exchange(self, params):
        """Exchange the params' values with the host shadow's, one tensor
        at a time; a second call undoes the first."""
        for n, p in params.items():
            held = p.detach().float().cpu().numpy().copy()
            p.copy_(torch.from_numpy(self.shadow[n]))
            self.shadow[n] = held


@contextlib.contextmanager
def ema_params(ema, params):
    """params hold the EMA weights inside the block and their own values
    again after it (nothing changes without an EMA)."""
    if ema is None:
        yield params
        return
    ema.exchange(params)
    try:
        yield params
    finally:
        ema.exchange(params)


def get_ema(params, hps):
    mu = hps.mu or (1.0 - (hps.bs * hps.get("ngpus", 1) / 8.0) / 1000)
    if hps.ema and hps.get("train", False):
        if hps.cpu_ema:
            return CPUEMA(params, mu=mu, freq=hps.cpu_ema_freq)
        return EMA(params, mu=mu, freq=1)
    return None
