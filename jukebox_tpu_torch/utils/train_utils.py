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

import numpy as np
import torch

FLOAT16_MAX = 65504.0  # reference FP16FusedAdam.FLOAT16_MAX (fp16.py:146)
_F32 = np.float32


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


@torch.no_grad()
def adam_update(params, grads, opt_state, lr, beta1, beta2, eps, weight_decay,
                scale=1.0):
    """One Adam step of the reference's form, in place: the gradients are
    divided by `scale` (loss scale x clipping), bias-corrected moments, and
    weight decay inside the update as step_size * (m / denom + wd * p).
    fp16 moments are unscaled to fp32, updated, and renormalised by their
    new per-tensor inf-norm. A None gradient counts as zero. Returns
    opt_state."""
    fp16_state = "m_scale" in opt_state
    step = opt_state["step"] + 1
    b1, b2 = _F32(beta1), _F32(beta2)
    bias1 = _F32(1) - b1 ** _F32(step)
    bias2 = _F32(1) - b2 ** _F32(step)
    step_size = torch.as_tensor(lr, dtype=torch.float32) \
        * float(np.sqrt(bias2)) / float(bias1)
    c1, c2 = float(_F32(1) - b1), float(_F32(1) - b2)
    on_device = {}  # device -> (step_size, scale) there
    for name, p in params.items():
        if p.device not in on_device:
            on_device[p.device] = (
                step_size.to(p.device),
                torch.as_tensor(scale, dtype=torch.float32, device=p.device))
        step_dev, scale_dev = on_device[p.device]
        g = grads.get(name)
        g = torch.zeros_like(p) if g is None else g
        g = g.float() / scale_dev
        m, v = opt_state["m"][name], opt_state["v"][name]
        if fp16_state:
            m = m.float() * opt_state["m_scale"][name]
            v = v.float() * opt_state["v_scale"][name]
        m = float(b1) * m + c1 * g
        v = float(b2) * v + c2 * g * g
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


def global_grad_norm(grads):
    """L2 norm over every gradient (fp16.py:104-120), an fp32 0-d tensor."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()
          if g is not None]
    return torch.sqrt(torch.stack(sq).sum())


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


def get_ema(params, hps):
    mu = hps.mu or (1.0 - (hps.bs * hps.get("ngpus", 1) / 8.0) / 1000)
    if hps.ema and hps.get("train", False):
        if hps.cpu_ema:
            return CPUEMA(params, mu=mu, freq=hps.cpu_ema_freq)
        return EMA(params, mu=mu, freq=1)
    return None
