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
fold_seed(seed, e, i, 0), its dropout or codebook draws from
fold_seed(seed, e, i, 1) and its in-training sample's tokens from
fold_seed(seed, e, i, 2); jax.random draws other numbers, so the two
packages agree step for step only without dropout, aug_blend and codebook
restarts, and their samples' tokens differ.

Several processes (parallel/): launched with JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID, as the JAX package's run is, the
ranks form a ("dp", "mp") mesh of hps.mesh_dp x hps.mesh_mp (mesh_dp -1:
all the ranks mp leaves); hps.ngpus is the world size and hps.bs stays
per process, so a step's global batch is bs x world / mp (each "dp" index
reads its slice of the loader's order). Gradients are averaged over "dp"
before the clipped Adam, so a step is one process's step on the global
batch; a prior with mesh_mp > 1 is split over "mp" (Megatron) and with
hps.fsdp its parameters and moments are held at 1/dp a rank (ZeRO-3),
parallel/placement.py. A VQ-VAE trains data-parallel, its codebooks kept
equal on every rank. The draws of a step (aug_blend, dropout, codebook
restarts) use the same seeds on every rank and are drawn for the global
batch, each rank taking its rows, so that a placed step is one process's
step on the global batch with them on too. Rank 0 alone writes the logs,
the checkpoints and the trace; a mesh that the world does not fill
raises.

    JAX_COORDINATOR_ADDRESS=localhost:29500 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=<rank> python -m jukebox_tpu_torch.train ... --fsdp=True

(one command per rank; JUKEBOX_DIST_BACKEND=gloo for several ranks on one
card, and on the CPU).

Logging, at the JAX loop's steps (utils/logger.py), under
{local_logdir}/{name}: argv.txt; TensorBoard events in logs/ (every
metric's running average each log_steps, lg_loss_scale = log2 of the loss
scale under fp16, the test_* averages of each evaluation, the labels' text
of a labelled prior); int16 wavs in audio/: train_x_in at every step i
with (i - 1) % save_iters == 0, and for a prior sample_x_T1 at every step
i with i % 12000 == 1 (step 1 included): one window sampled at temp 1.0
under the EMA weights through the fp32 layer-module decode, as
jukebox_tpu/train.py:129 samples it. JUKEBOX_TRAIN_JSONL=<path> appends
one line of running averages each log_steps (it, wall_s, window_s and the
metrics, rounded as the JAX package rounds them); hps.debug_speed writes
a torch.profiler Chrome trace of steps 3 to 2 + min(8, debug_iters) under
trace/ (utils/profiler.py).
"""

import contextlib
import json
import os
import time

import numpy as np
import torch

from jukebox_tpu_torch.data.data_processor import DataProcessor, ShardedLoader
from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.models.make_models import (VQVAERuntime, make_prior,
                                                  make_vqvae, restore_opt,
                                                  save_model_checkpoint)
from jukebox_tpu_torch.ops.core import dropout_rows, fold_seed
from jukebox_tpu_torch.parallel.dist import (dp_rows, make_mesh,
                                             rank_device, replicate,
                                             setup_dist)
from jukebox_tpu_torch.parallel.placement import Placement
from jukebox_tpu_torch.utils.audio_utils import audio_preprocess
from jukebox_tpu_torch.utils import profiler
from jukebox_tpu_torch.utils.cli import fire
from jukebox_tpu_torch.utils.logger import Metrics, init_logging
from jukebox_tpu_torch.utils.train_utils import (LossScalar, adam_init,
                                                 adam_update,
                                                 clipped_grad_scale,
                                                 ema_params, get_ema,
                                                 global_grad_norm,
                                                 make_lr_schedule)


def apply_update(params, grads, opt_state, hps, lr_fn, it, loss_scale,
                 placement=None):
    """The reference's scaled-gradient Adam with clipping folded into the
    divisor, skipped as a whole when the gradient norm is not finite or
    above hps.ignore_grad_norm (train.py:236-243, fp16.py:39-65).
    `loss_scale` is the loss scale the gradients carry. Returns (gn, lr, ok);
    params and opt_state change in place only when ok. Under a placement
    the norm is the whole gradient's, so every rank decides alike."""
    gn_scaled = global_grad_norm(grads, placement)
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


def _begin(runtime):
    """Gradients cleared (and, under a placement, its step begun)."""
    if runtime.placement is not None:
        runtime.placement.begin_step()
        return
    for p in runtime.params.values():
        p.grad = None


def _finish(runtime, hps, lr_fn, opt_state, it, loss_scale, loss, metrics):
    """The gradients (averaged over "dp" under a placement), the update,
    and the loss and metrics (the global batch's under a placement)."""
    params, placement = runtime.params, runtime.placement
    if placement is not None:
        grads = placement.grads()
    else:
        grads = {n: p.grad for n, p in params.items()}
    gn, lr, ok = apply_update(params, grads, opt_state, hps, lr_fn, it,
                              loss_scale, placement)
    for p in params.values():
        p.grad = None
    loss = loss.detach()
    if placement is not None:
        loss = placement.mean_over_dp(loss)
        metrics = {k: placement.mean_over_dp(torch.as_tensor(v))
                   for k, v in metrics.items()}
    return loss, dict(metrics, gn=gn, lr=lr, step_ok=ok)


def make_prior_train_step(runtime, hps, lr_fn, mark=None):
    """step(opt_state, (x, y), seed, it, loss_scale) -> (loss, metrics): the
    prior's parameters and opt_state are updated in place. x is audio
    [N, T, 1], y labels [N, ...] or None, seed the step's dropout seed (an
    int or None), it the step number of the LR schedule. mark: optional
    callable, called with the name of each part of the step (encode,
    forward, backward, update) as it ends, to time the step by parts.
    Under runtime.placement, x and y are the rank's slice of the global
    batch as the loader deals it (parallel/dist.py dp_rows), its dropout
    masks those rows' of the global batch's (ops/core.py dropout_rows),
    and the loss and metrics are the global batch's."""
    prior, vqvae = runtime.model, runtime.vqvae
    mark = mark or (lambda part: None)

    def step(opt_state, batch, seed, it, loss_scale=1.0):
        x, y = batch
        zs = vqvae.encode(x, start_level=prior.level)
        z, z_conds = zs[0], zs[1:]
        mark("encode")
        _begin(runtime)
        with dropout_rows(_rows(runtime, z.shape[0])):
            loss, metrics = prior.z_forward(z, z_conds=z_conds or None, y=y,
                                            fp16=hps.fp16, seed=seed)
            mark("forward")
            (loss * loss_scale).backward()
        mark("backward")
        out = _finish(runtime, hps, lr_fn, opt_state, it, loss_scale, loss,
                      metrics)
        mark("update")
        return out

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
        _begin(runtime)
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        _, loss, metrics = model(x, hps, loss_fn=hps.loss_fn, train=True,
                                 gen=gen)
        (loss * loss_scale).backward()
        return _finish(runtime, hps, lr_fn, opt_state, it, loss_scale, loss,
                       metrics)

    return step


def make_eval_step(runtime, hps):
    """eval_fn(x, y) -> (loss, metrics) without gradients
    (jukebox_tpu/train.py:179): the prior's loss on audio x [N, T, 1] and
    labels y (or None), or a VQ-VAE's loss on x with its codebooks left as
    they are; under runtime.placement, on the rank's slice with the
    placement's parameters, averaged over "dp"."""
    if not hps.prior:
        model = runtime.model

        def forward(x, y):
            _, loss, metrics = model(x, hps, loss_fn=hps.loss_fn, train=False)
            return loss, metrics
    else:
        prior, vqvae = runtime.model, runtime.vqvae

        def forward(x, y):
            zs = vqvae.encode(x, start_level=prior.level)
            return prior.z_forward(zs[0], z_conds=zs[1:] or None, y=y,
                                   fp16=hps.fp16)

    @torch.no_grad()
    def eval_fn(x, y):
        placement = runtime.placement
        if placement is None:
            return forward(x, y)
        loss, metrics = forward(x, y)
        return placement.mean_over_dp(loss), {
            k: placement.mean_over_dp(torch.as_tensor(v))
            for k, v in metrics.items()}

    return eval_fn


def _rows(runtime, n):
    """The global batch rows of the rank's n rows (parallel/dist.py
    dp_rows), or None without a placement."""
    placement = runtime.placement
    return None if placement is None else dp_rows(n, placement.mesh)


def _batch(batch, hps, device, gen=None, runtime=None):
    """A loader batch as (x [N, T, 1] fp32, y or None) on device; under
    runtime's placement the aug_blend mix is the rank's rows' of the
    global batch's."""
    x, y = batch if isinstance(batch, tuple) else (batch, None)
    x = torch.as_tensor(x).to(device)
    rows = None if runtime is None else _rows(runtime, x.shape[0])
    x = audio_preprocess(x, hps, gen=gen, rows=rows, total=None if rows
                         is None else x.shape[0] * runtime.placement.mesh.dp)
    return x, (torch.as_tensor(y).to(device) if y is not None else None)


def evaluate(eval_fn, runtime, data_processor, hps, logger=None,
             metrics=None):
    """One pass over the test split, forward only (jukebox_tpu/train.py
    :155): {metric: average weighted by batch size}, with "loss". With a
    logger, each average goes to its events as test_<metric> at the
    logger's step; metrics (a logger.Metrics, fresh when None) keeps the
    test_<metric> sums."""
    metrics = Metrics() if metrics is None else metrics
    device = next(runtime.model.parameters()).device
    loader = data_processor.test_loader
    if runtime.placement is not None:
        # every rank takes part in each batch's collectives
        counts = [len(ShardedLoader(loader.view, loader.bs, False, False,
                                    proc=r, nproc=loader.nproc))
                  for r in range(loader.nproc)]
        if len(set(counts)) > 1:
            raise ValueError(f"the test split gives the ranks {counts} "
                             f"batches; evaluate with a split that "
                             f"{loader.nproc} x bs divides")
    batches = iter(loader)
    keys = []
    try:
        steps = (logger.get_range(batches, total=len(loader))
                 if logger is not None else enumerate(batches))
        for _, batch in steps:
            x, y = _batch(batch, hps, device)
            loss, out = eval_fn(x, y)
            out = dict(sorted(out.items()), loss=loss)
            keys = list(out)
            for key, val in out.items():
                metrics.update(f"test_{key}", float(val), int(x.shape[0]))
            if logger is not None:
                logger.set_postfix(**{
                    pk: metrics.avg(f"test_{k}")
                    for pk, k in EVAL_KEYS[bool(hps.prior)].items()
                    if k in out})
    finally:
        batches.close()
    if logger is not None:
        for key in keys:
            logger.add_scalar(f"test_{key}", metrics.avg(f"test_{key}"))
        logger.close_range()
    return {k: metrics.avg(f"test_{k}") for k in keys}


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
# (jukebox_tpu/train.py:205-210), and of an evaluation's postfix (:160-163)
PRIOR_KEYS = dict(l="loss", bpd="bpd", gn="gn", g_l="gen_loss",
                  p_l="prime_loss")
VQVAE_KEYS = dict(l="loss", sl="spectral_loss", rl="recons_loss",
                  e="entropy", u="usage", uc="used_curr", gn="gn", pn="pn",
                  dk="dk")
EVAL_KEYS = {True: dict(l="loss", bpd="bpd"),
             False: dict(l="loss", rl="recons_loss", sl="spectral_loss")}
# a prior samples one window every SAMPLE_ITERS steps, at step 1 first
SAMPLE_ITERS = 12000


# ---------------------------------------------------------------------------
# logging and in-training sampling (jukebox_tpu/train.py:103-152)
# ---------------------------------------------------------------------------

def log_aud(logger, tag, x, hps):
    logger.add_audios(tag, x, hps.sr, max_len=hps.max_len,
                      max_log=hps.max_log)
    logger.flush()


def log_labels(logger, labeller, tag, y, hps):
    y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
    txt = ""
    for item in range(y.shape[0]):
        d = labeller.describe_label(y[item])
        txt += (f"{item} artist:{d['artist']}, genre:{d['genre']}, "
                f"lyrics:{d['lyrics']}\n")
    logger.add_text(tag, txt)
    logger.flush()


def log_inputs(runtime, logger, x_in, y, x_out, hps, tag="train"):
    print(f"Logging {tag} inputs/outputs")
    log_aud(logger, f"{tag}_x_in", x_in, hps)
    if x_out is not None:
        log_aud(logger, f"{tag}_x_out", x_out, hps)
    if hps.prior and hps.labels and y is not None:
        log_labels(logger, runtime.labeller, f"{tag}_y_in", y, hps)
    logger.flush()


def sample_prior(runtime, ema, logger, x_in, y, hps, gen=None):
    """One window sampled at temp 1.0 under the EMA weights
    (jukebox_tpu/train.py:129): the first bs_sample clips of x_in encoded,
    the prior's codes sampled (fp32, conditioned on the levels above and
    on y when the prior takes labels) from the torch.Generator gen,
    decoded and logged as sample_x_T1 (with the labels' text). The params
    hold their own values again after. Returns (codes, audio). Under
    runtime.placement every rank samples (the prior whole or its Megatron
    split) and rank 0 logs."""
    placement = runtime.placement
    gathered = (placement.materialized() if placement is not None
                else contextlib.nullcontext())
    with ema_params(ema, runtime.params), gathered:
        x_in = x_in[: hps.bs_sample]
        bs = x_in.shape[0]
        if not hps.labels:
            y = None
        elif y is not None:
            y = y[: hps.bs_sample]
        zs = runtime.encode(x_in, start_level=runtime.level, bs_chunks=bs)
        z_conds = zs[1:] if len(zs) > 1 else None
        z = runtime.sample(bs, z_conds=z_conds, y=y, gen=gen, fp16=False,
                           temp=1.0)
        x_sample = runtime.decode([z] + (list(z_conds) if z_conds else []),
                                  bs_chunks=bs)
        log_aud(logger, "sample_x_T1", x_sample, hps)
        if hps.labels and y is not None:
            log_labels(logger, runtime.labeller, "sample_x_T1", y, hps)
    logger.flush()
    return z, x_sample


def _append_jsonl(path, rec):
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def train(step_fn, runtime, opt_state, ema, data_processor, hps, epoch,
          scalar, records, logger, metrics):
    """One epoch of the loader, or fewer steps once runtime.step reaches
    hps.max_steps, with the JAX loop's side effects at its steps (see the
    module's docstring): logger.iters follows runtime.step, metrics
    (logger.Metrics) keeps the running averages. Appends one record per
    step to `records` (metrics, loss_scale under fp16, the step's wall
    seconds, synchronised, a checkpoint's path and save seconds at the
    steps that save, the sample's seconds at the steps that sample).
    Returns the epoch's averages."""
    device = next(runtime.model.parameters()).device
    seed = hps.get("seed", 0)
    timer = profiler.StepTimer(skip_first=1)
    tracing = False
    jsonl = os.environ.get("JUKEBOX_TRAIN_JSONL")
    t_start = t_last = time.time()
    keys = PRIOR_KEYS if hps.prior else VQVAE_KEYS
    loader = data_processor.train_loader
    batches = iter(loader)
    logger.iters = runtime.step
    try:
        for _, batch in logger.get_range(batches, total=len(loader)):
            it = runtime.step + 1
            gen = torch.Generator(device=device).manual_seed(
                fold_seed(seed, epoch, it, 0))
            x, y = _batch(batch, hps, device, gen, runtime)
            log_input_output = logger.iters % hps.save_iters == 0
            # a trace of a few steady-state steps
            if (hps.debug_speed and logger.iters == 2 and not tracing
                    and logger.rank == 0):
                profiler.start_trace(f"{logger.logdir}/trace")
                tracing = True
            if tracing and logger.iters >= 2 + min(8, hps.debug_iters):
                profiler.stop_trace()
                tracing = False
                print(f"Saved profiler trace to {logger.logdir}/trace")
            logger.step()
            runtime.step = it
            loss_scale = scalar.get_scale() if scalar else 1.0
            t0 = time.time()
            with timer:
                loss, out = step_fn(opt_state, (x, y),
                                    fold_seed(seed, epoch, it, 1), it,
                                    loss_scale)
                # in the JAX step's order: its jitted dict comes back sorted
                out = {k: float(v) for k, v in sorted(out.items())}
                out["loss"] = float(loss)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            wall = time.time() - t0
            if ema is not None:
                ema.step(runtime.params)
            step_ok = bool(out.pop("step_ok"))
            logged = dict(out)
            if scalar is not None:
                # dynamic loss scaling: halve on overflow, grow per window
                scalar.update_scale(not step_ok)
                out["loss_scale"] = scalar.get_scale()
                logged["lg_loss_scale"] = float(np.log2(scalar.get_scale()))
            for key, val in logged.items():
                logged[key] = metrics.update(key, val, int(x.shape[0]))
                if it % hps.log_steps == 0:
                    logger.add_scalar(key, logged[key])
            if jsonl and logger.rank == 0 and it % hps.log_steps == 0:
                now = time.time()
                _append_jsonl(jsonl, dict(
                    it=it, wall_s=round(now - t_start, 2),
                    window_s=round(now - t_last, 2),
                    **{k: round(float(v), 6) for k, v in logged.items()}))
                t_last = now
            records.append(dict(it=it, epoch=epoch, step_ok=step_ok,
                                wall_s=wall, **out))
            if hps.save and it % hps.save_iters == 1:
                path, save_s = save_step(runtime, opt_state, ema, hps, it)
                records[-1].update(checkpoint=path, save_s=save_s)
            if hps.prior and it % SAMPLE_ITERS == 1:
                t0 = time.time()
                sample_prior(runtime, ema, logger, x, y, hps,
                             torch.Generator(device=device).manual_seed(
                                 fold_seed(seed, epoch, it, 2)))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                records[-1].update(sample_s=time.time() - t0)
            if log_input_output:
                log_inputs(runtime, logger, x, y, None, hps)
            logger.set_postfix(**{pk: logged[k] for pk, k in keys.items()
                                  if k in logged})
            if it % hps.log_steps == 0 and logger.rank == 0:
                print(f"step {it}: " + " ".join(
                    f"{pk} {out[k]:.6g}" for pk, k in keys.items()
                    if k in out)
                    + f" step_ok {step_ok} wall {wall:.3f}s", flush=True)
            if hps.max_steps and it >= hps.max_steps:
                break
    finally:
        batches.close()  # shuts the loader's thread pool down
        if tracing:
            profiler.stop_trace()
        logger.close_range()
    if logger.rank == 0:
        print(f"Step timing: {timer.summary()}")
    return {key: metrics.avg(key) for key in metrics.sum}


def setup(hps="teeny", device="cuda", dataset=None, **kwargs):
    """Everything a training run needs, from hps (comma-separated set
    names) and kwargs, on `device`: weights drawn from hps.seed, then the
    VQ-VAE's params, codebook state (and, training it, optimizer state and
    step) restored from hps.restore_vqvae, and a prior's from
    hps.restore_prior, when those name a checkpoint. dataset: optional
    ready-made dataset for the DataProcessor (a labelled subclass for
    labels=True). The logger (init_logging: argv.txt, the event file)
    writes under {local_logdir}/{name}, from rank 0. Over several ranks
    (the JAX_* variables, parallel/dist.py setup_dist) the model is built
    whole on every rank, restored, replicated from rank 0 and then placed
    (parallel/placement.py) on the hps.mesh_dp x hps.mesh_mp mesh, its
    moments with it. Returns a dict for `fit`."""
    rank, world = setup_dist(device)
    hps = setup_hparams(hps, kwargs)
    mesh = make_mesh(hps.mesh_dp, hps.mesh_mp, device)
    device = rank_device(device)
    hps.ngpus = world
    hps.bs_sample = hps.nworkers = hps.bs
    # fp32 products at full precision, as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data_processor = DataProcessor(hps, dataset=dataset, proc=mesh.dp_rank,
                                   nproc=mesh.dp)
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
    if world > 1 or hps.fsdp or mesh.mp > 1:
        opt_state = place(runtime, opt_state, mesh, hps)
    ema = get_ema(runtime.params, hps)
    scalar = LossScalar(hps.fp16_loss_scale,
                        scale_factor=2.0 ** (1.0 / hps.fp16_scale_window)) \
        if hps.fp16 else None
    logger, metrics = init_logging(hps, rank, rank)
    logger.iters = runtime.step
    return dict(hps=hps, data_processor=data_processor, runtime=runtime,
                opt_state=opt_state, ema=ema, scalar=scalar, logger=logger,
                metrics=metrics, step_fn=make_step(runtime, hps, lr_fn),
                eval_fn=make_eval_step(runtime, hps))


def place(runtime, opt_state, mesh, hps):
    """runtime's model (and a VQ-VAE's codebooks) broadcast from rank 0,
    then placed on mesh: runtime.placement, a Megatron split over "mp"
    for a prior and ZeRO-3 over "dp" with hps.fsdp (a VQ-VAE trains data
    parallel, replicated, as the JAX package trains it). Returns opt_state
    with m and v cut to the rank's pieces."""
    model = runtime.model
    replicate(list(model.parameters()) + list(model.buffers()))
    fsdp = bool(hps.fsdp) and bool(hps.prior)
    if hps.fsdp and not hps.prior:
        print("fsdp places priors; the VQ-VAE trains replicated over dp")
    runtime.placement = Placement(model, mesh, fsdp=fsdp)
    if not hps.prior:
        for blk in model.bottleneck.level_blocks:
            blk.group = mesh.dp_group
    out = dict(opt_state)
    for key in ("m", "v"):
        out[key] = runtime.placement.shard_dict(opt_state[key])
    return out


def fit(run_state):
    """Train from `setup`'s state until hps.max_steps (or hps.epochs),
    from the restored step on, evaluating on the test split under the EMA
    weights after each epoch when hps.test is set. Returns dict(runtime,
    opt_state, ema, scalar, records, test, logger) with test the last
    evaluation's averages (or None)."""
    hps, runtime = run_state["hps"], run_state["runtime"]
    data_processor, ema = run_state["data_processor"], run_state["ema"]
    opt_state, scalar = run_state["opt_state"], run_state["scalar"]
    logger, metrics = run_state["logger"], run_state["metrics"]
    records, test = [], None
    for epoch in range(max(0, hps.curr_epoch), hps.epochs):
        if hps.max_steps and runtime.step >= hps.max_steps:
            break
        metrics.reset()
        data_processor.set_epoch(epoch)
        if hps.train:
            averages = train(run_state["step_fn"], runtime, opt_state, ema,
                             data_processor, hps, epoch, scalar, records,
                             logger, metrics)
            if logger.rank == 0:
                print(f"Train epoch {epoch}: " + " ".join(
                    f"{k} {v:0.4f}" for k, v in averages.items()),
                    flush=True)
        if hps.test:
            with ema_params(ema, runtime.params):
                test = evaluate(run_state["eval_fn"], runtime,
                                data_processor, hps, logger, metrics)
            if logger.rank == 0:
                print(f"Ema epoch {epoch}: " + " ".join(
                    f"{k} {v:0.4f}" for k, v in test.items()), flush=True)
        if hps.max_steps and runtime.step >= hps.max_steps:
            break
    logger.flush()
    return dict(runtime=runtime, opt_state=opt_state, ema=ema, scalar=scalar,
                records=records, test=test, logger=logger)


def run(hps="teeny", device="cuda", dataset=None, **kwargs):
    """Train a VQ-VAE or a prior: setup(hps, device, dataset, **kwargs),
    then fit. Returns fit's dict."""
    return fit(setup(hps, device, dataset, **kwargs))


if __name__ == "__main__":
    fire(run)
