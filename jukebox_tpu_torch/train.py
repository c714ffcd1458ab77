"""Prior training of the PyTorch port (counterpart of jukebox_tpu/train.py):
the train step (frozen VQ-VAE encode, the prior's loss and gradients, the
reference's scaled and clipped Adam update with the all-or-nothing step
skip), the eval step, the training loop (dynamic loss scale, EMA, one
metrics line per log_steps on stdout, a checkpoint every save_iters) and
`run`, which builds everything from hps, restores it from
hps.restore_prior, trains to max_steps and evaluates under the EMA weights
when hps.test is set.

    python -m jukebox_tpu_torch.train \\
        --hps=vqvae,prior_1b_lyrics,all_fp16,cpu_ema --name=finetune \\
        --audio_files_dir=<wavs> --labels=False --prior --levels=3 \\
        --level=2 --bs=1 --train --restore_prior=<.jkb>

or from Python `run(hps, device="cuda", dataset=None, **kwargs)` (a
labelled run passes a labelled dataset subclass, see DataProcessor).
Checkpoints are `.jkb` files, the JAX package's format: the training
loop writes {local_logdir}/{name}/checkpoint_latest.jkb at every step i
with i % save_iters == 1, holding the EMA weights as params when EMA is
on, and --restore_prior (or restore_vqvae) takes one from either package.
Randomness: step i of epoch e draws its aug_blend mix and its dropout seed
from fold_seed(seed, e, i); jax.random draws other numbers, so the two
packages agree step for step only without dropout and aug_blend.
VQ-VAE training, in-training sampling, and audio and tensorboard logging
are not ported yet.
"""

import time

import torch

from jukebox_tpu_torch.data.data_processor import DataProcessor
from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.models.make_models import (make_prior, make_vqvae,
                                                  restore_opt,
                                                  save_model_checkpoint)
from jukebox_tpu_torch.ops.core import fold_seed
from jukebox_tpu_torch.utils.audio_utils import audio_preprocess
from jukebox_tpu_torch.utils.cli import fire
from jukebox_tpu_torch.utils.train_utils import (LossScalar, adam_init,
                                                 adam_update,
                                                 clipped_grad_scale,
                                                 ema_params, get_ema,
                                                 global_grad_norm,
                                                 make_lr_schedule)


def apply_update(params, grads, opt_state, hps, lr_fn, it, loss_scale):
    """The reference's scaled-gradient Adam with clipping folded into the
    divisor, skipped as a whole when the gradient norm is not finite or
    above hps.ignore_grad_norm (train.py:236-243, fp16.py:39-65).
    `loss_scale` is the loss scale the gradients carry. Returns (gn, lr, ok);
    params and opt_state change in place only when ok."""
    gn_scaled = global_grad_norm(grads)
    gn = gn_scaled / loss_scale
    scale = clipped_grad_scale(gn, hps.clip, scale=loss_scale)
    lr = lr_fn(it)
    ok = torch.isfinite(gn_scaled)
    if hps.ignore_grad_norm > 0:
        ok = ok & (gn <= hps.ignore_grad_norm)
    ok = bool(ok)
    if ok:
        adam_update(params, grads, opt_state, lr, hps.beta1, hps.beta2,
                    hps.eps, hps.weight_decay, scale)
    return gn, lr, ok


def make_prior_train_step(runtime, hps, lr_fn, mark=None):
    """step(opt_state, (x, y), seed, it, loss_scale) -> (loss, metrics): the
    prior's parameters and opt_state are updated in place. x is audio
    [N, T, 1], y labels [N, ...] or None, seed the step's dropout seed (an
    int or None), it the step number of the LR schedule. mark: optional
    callable, called with the name of each part of the step (encode,
    forward, backward, update) as it ends, to time the step by parts."""
    prior, vqvae = runtime.model, runtime.vqvae
    mark = mark or (lambda part: None)

    def step(opt_state, batch, seed, it, loss_scale=1.0):
        x, y = batch
        zs = vqvae.encode(x, start_level=prior.level)
        z, z_conds = zs[0], zs[1:]
        mark("encode")
        params = runtime.params
        for p in params.values():
            p.grad = None
        loss, metrics = prior.z_forward(z, z_conds=z_conds or None, y=y,
                                        fp16=hps.fp16, seed=seed)
        mark("forward")
        (loss * loss_scale).backward()
        mark("backward")
        grads = {n: p.grad for n, p in params.items()}
        gn, lr, ok = apply_update(params, grads, opt_state, hps, lr_fn, it,
                                  loss_scale)
        for p in params.values():
            p.grad = None
        mark("update")
        return loss.detach(), dict(metrics, gn=gn, lr=lr, step_ok=ok)

    return step


def make_eval_step(runtime, hps):
    """eval_fn(x, y) -> (loss, metrics): the prior's loss on audio x
    [N, T, 1] and labels y (or None) without gradients
    (jukebox_tpu/train.py:179)."""
    prior, vqvae = runtime.model, runtime.vqvae

    @torch.no_grad()
    def eval_fn(x, y):
        zs = vqvae.encode(x, start_level=prior.level)
        return prior.z_forward(zs[0], z_conds=zs[1:] or None, y=y,
                               fp16=hps.fp16)

    return eval_fn


def _batch(batch, hps, device, gen=None):
    """A loader batch as (x [N, T, 1] fp32, y or None) on device."""
    x, y = batch if isinstance(batch, tuple) else (batch, None)
    x = audio_preprocess(torch.as_tensor(x).to(device), hps, gen=gen)
    return x, (torch.as_tensor(y).to(device) if y is not None else None)


class Averages:
    """Running averages of named metrics, weighted by batch size."""

    def __init__(self):
        self.sum, self.n = {}, {}

    def update(self, key, val, n):
        self.sum[key] = self.sum.get(key, 0.0) + float(val) * n
        self.n[key] = self.n.get(key, 0) + n

    def avg(self, key):
        return self.sum[key] / self.n[key]


def evaluate(eval_fn, runtime, data_processor, hps):
    """One pass over the test split, forward only (jukebox_tpu/train.py
    :155): {metric: average weighted by batch size}, with "loss"."""
    averages = Averages()
    device = next(runtime.model.parameters()).device
    loader = iter(data_processor.test_loader)
    try:
        for batch in loader:
            x, y = _batch(batch, hps, device)
            loss, metrics = eval_fn(x, y)
            metrics = dict(metrics, loss=loss)
            for key, val in metrics.items():
                averages.update(key, float(val), int(x.shape[0]))
    finally:
        loader.close()
    return {k: averages.avg(k) for k in averages.sum}


def save_latest(runtime, opt_state, ema, hps, it):
    """checkpoint_latest.jkb under {local_logdir}/{name}, with the EMA
    weights as params when there is an EMA (jukebox_tpu/train.py:278-289).
    Returns (path, seconds)."""
    t0 = time.time()
    params = ema.swap(runtime.params)[0] if ema is not None else None
    path = save_model_checkpoint(f"{hps.local_logdir}/{hps.name}", "latest",
                                 runtime, opt_state, it, hps, params=params)
    return path, time.time() - t0


def train(step_fn, runtime, opt_state, ema, data_processor, hps, epoch,
          scalar, records):
    """One epoch of the loader, or fewer steps once runtime.step reaches
    hps.max_steps. Appends one record per step to `records` (metrics, the
    step's wall seconds, synchronised, and a checkpoint's path and save
    seconds at the steps that save). Returns the epoch's averages."""
    averages = Averages()
    device = next(runtime.model.parameters()).device
    loader = iter(data_processor.train_loader)
    try:
        for batch in loader:
            runtime.step += 1
            it = runtime.step
            gen = torch.Generator(device=device).manual_seed(
                fold_seed(hps.get("seed", 0), epoch, it, 0))
            x, y = _batch(batch, hps, device, gen)
            loss_scale = scalar.get_scale() if scalar else 1.0
            t0 = time.time()
            loss, metrics = step_fn(opt_state, (x, y),
                                    fold_seed(hps.get("seed", 0), epoch, it, 1),
                                    it, loss_scale)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["loss"] = float(loss)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.time() - t0
            if ema is not None:
                ema.step(runtime.params)
            step_ok = bool(metrics.pop("step_ok"))
            if scalar is not None:
                # dynamic loss scaling: halve on overflow, grow per window
                scalar.update_scale(not step_ok)
                metrics["loss_scale"] = scalar.get_scale()
            for key, val in metrics.items():
                averages.update(key, val, int(x.shape[0]))
            records.append(dict(it=it, epoch=epoch, step_ok=step_ok,
                                wall_s=wall, **metrics))
            if hps.save and it % hps.save_iters == 1:
                path, save_s = save_latest(runtime, opt_state, ema, hps, it)
                records[-1].update(checkpoint=path, save_s=save_s)
            if it % hps.log_steps == 0:
                print(f"step {it}: " + " ".join(
                    f"{k} {v:.6g}" for k, v in metrics.items())
                    + f" step_ok {step_ok} wall {wall:.3f}s", flush=True)
            if hps.max_steps and it >= hps.max_steps:
                break
    finally:
        loader.close()  # shuts the loader's thread pool down
    return {k: averages.avg(k) for k in averages.sum}


def setup(hps="teeny", device="cuda", dataset=None, **kwargs):
    """Everything a prior's training run needs, from hps (comma-separated
    set names) and kwargs, on `device`: weights drawn from hps.seed, then
    params, optimizer state and step restored from hps.restore_prior (and
    the VQ-VAE from hps.restore_vqvae) when those name a checkpoint.
    dataset: optional ready-made dataset for the DataProcessor (a labelled
    subclass for labels=True). Returns a dict for `fit`."""
    hps = setup_hparams(hps, kwargs)
    if not hps.prior:
        raise NotImplementedError("VQ-VAE training is not ported yet")
    hps.ngpus = 1
    hps.bs_sample = hps.nworkers = hps.bs
    # fp32 products at full precision, as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data_processor = DataProcessor(hps, dataset=dataset)
    vqvae = make_vqvae(hps, device)
    runtime = make_prior(hps, vqvae, device)
    lr_fn = make_lr_schedule(hps)
    opt_state = adam_init(runtime.params, fp16_state=hps.fp16_opt)
    opt_state, _ = restore_opt(opt_state, hps.restore_prior, runtime.model)
    ema = get_ema(runtime.params, hps)
    scalar = LossScalar(hps.fp16_loss_scale,
                        scale_factor=2.0 ** (1.0 / hps.fp16_scale_window)) \
        if hps.fp16 else None
    return dict(hps=hps, data_processor=data_processor, runtime=runtime,
                opt_state=opt_state, ema=ema, scalar=scalar,
                step_fn=make_prior_train_step(runtime, hps, lr_fn),
                eval_fn=make_eval_step(runtime, hps))


def fit(run_state):
    """Train from `setup`'s state until hps.max_steps (or hps.epochs),
    from the restored step on, evaluating on the test split under the EMA
    weights after each epoch when hps.test is set. Returns dict(runtime,
    opt_state, ema, scalar, records, test) with test the last evaluation's
    averages (or None)."""
    hps, runtime = run_state["hps"], run_state["runtime"]
    data_processor, ema = run_state["data_processor"], run_state["ema"]
    opt_state, scalar = run_state["opt_state"], run_state["scalar"]
    records, test = [], None
    for epoch in range(max(0, hps.curr_epoch), hps.epochs):
        if hps.max_steps and runtime.step >= hps.max_steps:
            break
        data_processor.set_epoch(epoch)
        if hps.train:
            averages = train(run_state["step_fn"], runtime, opt_state, ema,
                             data_processor, hps, epoch, scalar, records)
            print(f"Train epoch {epoch}: " + " ".join(
                f"{k} {v:0.4f}" for k, v in averages.items()), flush=True)
        if hps.test:
            with ema_params(ema, runtime.params):
                test = evaluate(run_state["eval_fn"], runtime,
                                data_processor, hps)
            print(f"Ema epoch {epoch}: " + " ".join(
                f"{k} {v:0.4f}" for k, v in test.items()), flush=True)
        if hps.max_steps and runtime.step >= hps.max_steps:
            break
    return dict(runtime=runtime, opt_state=opt_state, ema=ema, scalar=scalar,
                records=records, test=test)


def run(hps="teeny", device="cuda", dataset=None, **kwargs):
    """Fine-tune a prior: setup(hps, device, dataset, **kwargs), then
    fit. Returns fit's dict."""
    return fit(setup(hps, device, dataset, **kwargs))


if __name__ == "__main__":
    fire(run)
