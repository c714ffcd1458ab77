"""Training of the PyTorch port (counterpart of jukebox_tpu/train.py), for
a VQ-VAE (hps.prior False) or a prior over a VQ-VAE's codes: the train
steps (the VQ-VAE's forward with its codebook update, or a frozen VQ-VAE's
encode and the prior's loss; gradients; the reference's scaled and clipped
Adam update with the all-or-nothing step skip), the eval step, the
training loop (dynamic loss scale, EMA, one line of the JAX package's
print keys per log_steps on stdout, a checkpoint every save_iters) and
`run`, which builds everything from hps, restores it from
hps.restore_vqvae / hps.restore_prior, trains to max_steps and evaluates
under the EMA weights when hps.test is set. The README's two commands:

    python -m jukebox_tpu_torch.train --hps=small_vqvae --name=small_vqvae \\
        --sample_length=262144 --bs=4 --audio_files_dir=<dir> \\
        --labels=False --train=True --aug_shift=True --aug_blend=True
    python -m jukebox_tpu_torch.train \\
        --hps=small_vqvae,small_prior,all_fp16,cpu_ema --name=small_prior \\
        --sample_length=2097152 --bs=4 --audio_files_dir=<dir> \\
        --labels=False --train=True --test=True --aug_shift=True \\
        --aug_blend=True --prior=True --levels=2 --level=1 \\
        --restore_vqvae=logs/small_vqvae/checkpoint_step_<n>.jkb \\
        --weight_decay=0.01

or from Python `run(hps, device="cuda", dataset=None, **kwargs)` (a
labelled run passes a labelled dataset subclass, see DataProcessor).
Checkpoints are `.jkb` files, the JAX package's format: the training
loop writes {local_logdir}/{name}/checkpoint_step_<i>.jkb (a VQ-VAE, with
its codebook state) or checkpoint_latest.jkb (a prior) at every step i
with i % save_iters == 1, holding the EMA weights as params when EMA is
on, and --restore_prior / --restore_vqvae take one from either package.
Randomness: step i of epoch e draws its aug_blend mix from
fold_seed(seed, e, i, 0) and its dropout or codebook draws from
fold_seed(seed, e, i, 1); jax.random draws other numbers, so the two
packages agree step for step only without dropout, aug_blend and codebook
restarts. In-training sampling, and audio and tensorboard logging
(utils/logger.py) are not ported yet.
"""

import time

import torch

from jukebox_tpu_torch.data.data_processor import DataProcessor
from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.models.make_models import (VQVAERuntime, make_prior,
                                                  make_vqvae, restore_opt,
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


def make_vqvae_train_step(runtime, hps, lr_fn):
    """step(opt_state, (x, y), seed, it, loss_scale) -> (loss, metrics) of
    a VQ-VAE (jukebox_tpu/train.py:57): the training forward on audio x
    [N, T, 1] (y is ignored), which updates the codebooks in place drawing
    from a torch.Generator seeded `seed`, then gradients and the shared
    update of the parameters and opt_state in place. The codebook update
    stands when the step is skipped, as in the JAX package."""
    model = runtime.model

    def step(opt_state, batch, seed, it, loss_scale=1.0):
        x, _ = batch
        params = runtime.params
        for p in params.values():
            p.grad = None
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        _, loss, metrics = model(x, hps, loss_fn=hps.loss_fn, train=True,
                                 gen=gen)
        (loss * loss_scale).backward()
        grads = {n: p.grad for n, p in params.items()}
        gn, lr, ok = apply_update(params, grads, opt_state, hps, lr_fn, it,
                                  loss_scale)
        for p in params.values():
            p.grad = None
        return loss.detach(), dict(metrics, gn=gn, lr=lr, step_ok=ok)

    return step


def make_eval_step(runtime, hps):
    """eval_fn(x, y) -> (loss, metrics) without gradients
    (jukebox_tpu/train.py:179): the prior's loss on audio x [N, T, 1] and
    labels y (or None), or a VQ-VAE's loss on x with its codebooks left as
    they are."""
    if not hps.prior:
        model = runtime.model

        @torch.no_grad()
        def eval_vqvae(x, y):
            _, loss, metrics = model(x, hps, loss_fn=hps.loss_fn, train=False)
            return loss, metrics

        return eval_vqvae
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


def save_step(runtime, opt_state, ema, hps, it):
    """checkpoint_latest.jkb (a prior) or checkpoint_step_<it>.jkb (a
    VQ-VAE) under {local_logdir}/{name}, with the EMA weights as params
    when there is an EMA (jukebox_tpu/train.py:278-289). Returns (path,
    seconds)."""
    t0 = time.time()
    params = ema.swap(runtime.params)[0] if ema is not None else None
    name = "latest" if hps.prior else f"step_{it}"
    path = save_model_checkpoint(f"{hps.local_logdir}/{hps.name}", name,
                                 runtime, opt_state, it, hps, params=params)
    return path, time.time() - t0


# the metrics of a step's line and their short names
# (jukebox_tpu/train.py:205-210)
PRIOR_KEYS = dict(l="loss", bpd="bpd", gn="gn", g_l="gen_loss",
                  p_l="prime_loss")
VQVAE_KEYS = dict(l="loss", sl="spectral_loss", rl="recons_loss",
                  e="entropy", u="usage", uc="used_curr", gn="gn", pn="pn",
                  dk="dk")


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
                path, save_s = save_step(runtime, opt_state, ema, hps, it)
                records[-1].update(checkpoint=path, save_s=save_s)
            if it % hps.log_steps == 0:
                keys = PRIOR_KEYS if hps.prior else VQVAE_KEYS
                print(f"step {it}: " + " ".join(
                    f"{pk} {metrics[k]:.6g}" for pk, k in keys.items()
                    if k in metrics)
                    + f" step_ok {step_ok} wall {wall:.3f}s", flush=True)
            if hps.max_steps and it >= hps.max_steps:
                break
    finally:
        loader.close()  # shuts the loader's thread pool down
    return {k: averages.avg(k) for k in averages.sum}


def setup(hps="teeny", device="cuda", dataset=None, **kwargs):
    """Everything a training run needs, from hps (comma-separated set
    names) and kwargs, on `device`: weights drawn from hps.seed, then the
    VQ-VAE's params, codebook state (and, training it, optimizer state and
    step) restored from hps.restore_vqvae, and a prior's from
    hps.restore_prior, when those name a checkpoint. dataset: optional
    ready-made dataset for the DataProcessor (a labelled subclass for
    labels=True). Returns a dict for `fit`."""
    hps = setup_hparams(hps, kwargs)
    hps.ngpus = 1
    hps.bs_sample = hps.nworkers = hps.bs
    # fp32 products at full precision, as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data_processor = DataProcessor(hps, dataset=dataset)
    vqvae = make_vqvae(hps, device)
    if hps.prior:
        runtime = make_prior(hps, vqvae, device)
        restore = hps.restore_prior
        make_step = make_prior_train_step
    else:
        runtime = VQVAERuntime(vqvae)
        restore = hps.restore_vqvae
        make_step = make_vqvae_train_step
    lr_fn = make_lr_schedule(hps)
    opt_state = adam_init(runtime.params, fp16_state=hps.fp16_opt)
    opt_state, _ = restore_opt(opt_state, restore, runtime.model)
    ema = get_ema(runtime.params, hps)
    scalar = LossScalar(hps.fp16_loss_scale,
                        scale_factor=2.0 ** (1.0 / hps.fp16_scale_window)) \
        if hps.fp16 else None
    return dict(hps=hps, data_processor=data_processor, runtime=runtime,
                opt_state=opt_state, ema=ema, scalar=scalar,
                step_fn=make_step(runtime, hps, lr_fn),
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
    """Train a VQ-VAE or a prior: setup(hps, device, dataset, **kwargs),
    then fit. Returns fit's dict."""
    return fit(setup(hps, device, dataset, **kwargs))


if __name__ == "__main__":
    fire(run)
