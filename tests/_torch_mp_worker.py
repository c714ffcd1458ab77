"""One rank of the port's multi-process CPU tests, launched by
tests/test_torch_multiprocess.py: real processes over gloo, joined through
the JAX package's three variables (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID) by parallel/dist.py setup_dist.
Imports no JAX: the test process makes the JAX references and the shared
weights, and compares.

    python _torch_mp_worker.py <outdir> <job>[,<job>...]

Jobs (each writes <outdir>/<job>_<rank>_of_<world>.pt):
  vqvae    three VQ-VAE train steps data parallel over every rank on a
           slice of one global batch of 8 (tests/_mp_worker.py's)
  ckpt     the prior of inputs.pt placed ZeRO-3 over dp = world with
           random moments, then saved (rank 0's file) and its pieces
  decode   the prior of inputs.pt split over mp = world, then sampled at
           top_k=1 in fp32 and int8-staged (bf16 plain versions), and
           the logits of its bf16 and int8 staged decode on forced tokens
  dpmp     one prior train step at dp = world / 2, mp = 2
  dpmp_drop the same with attention, residual and embedding dropout 0.1
  fsdp     one prior train step ZeRO-3 over dp = world (min_size 64)
  up_mp    the upsampler-shaped prior of inputs.pt (one head: mp does not
           divide it) split over mp = world: one train step, its tokens
           at top_k=1 in fp32 and the logits of its bf16 staged decode on
           forced tokens
  run_drop train.run as run_fsdp without fsdp, with dropout 0.1 and
           aug_blend
  run_mp   train.run of a tiny labelled lyric prior on <outdir>/wavs with
           mesh_mp = world: two steps, an evaluation, a checkpoint, the
           in-training sample at step 1 (its records)
  run_fsdp the same with fsdp=True over dp = world
"""

import os
import sys

import numpy as np
import torch

# tests/_mp_worker.py's VQ-VAE (at 2048 samples: the port's STFT pads by
# n_fft / 2 = 1024 and needs more), and tests/test_parallel.py _build's pair
VQ_MP = dict(sample_length=2048, sr=8000, levels=2, downs_t=(2, 1),
             strides_t=(2, 2), emb_width=16, l_bins=32, l_mu=0.99,
             commit=0.02, width=8, depth=2, m_conv=1.0,
             dilation_growth_rate=1, loss_fn="l2", lr=1e-3, train=True)
VQ_PAR = dict(sample_length=512, sr=8000, levels=2, downs_t=(2, 1),
              strides_t=(2, 2), emb_width=16, l_bins=32, l_mu=0.99,
              commit=0.02, width=8, depth=1, m_conv=1.0,
              dilation_growth_rate=1)
PRIOR_PAR = dict(sample_length=256, sr=8000, level=1, levels=2, labels=True,
                 labels_v3=True, y_bins=(10, 100), max_bow_genre_size=1,
                 t_bins=16, min_duration=1.0, max_duration=600.0,
                 use_tokens=True, n_tokens=16, n_vocab=79,
                 prime_loss_fraction=0.4, single_enc_dec=True, n_ctx=32,
                 prior_width=32, prior_depth=3, heads=2, attn_order=12,
                 blocks=8, init_scale=0.7, lr=1e-3, prior=True, train=True)
# an upsampler-shaped prior: one head, a level-1 conditioner, labels
# without lyrics (tests/test_torch_prior.py UP at test_parallel.py's
# sizes); no warmup, so that its step moves each param by about lr, 50x
# the params' tolerance, whatever the size of its gradient (Adam)
UP_PAR = dict(sample_length=128, sr=8000, level=0, levels=2, labels=True,
              labels_v3=False, y_bins=(10, 100), max_bow_genre_size=1,
              t_bins=16, min_duration=1.0, max_duration=600.0,
              use_tokens=False, n_ctx=32, prior_width=32, prior_depth=3,
              heads=1, attn_order=2, blocks=8, init_scale=0.7, cond_width=16,
              cond_depth=2, cond_dilation_growth_rate=3,
              cond_dilation_cycle=None, lr=1e-3, lr_warmup=1.0, prior=True,
              train=True)
DROP = dict(attn_dropout=0.1, resid_dropout=0.1, emb_dropout=0.1)
DROP_SEED = 5
GLOBAL_BS = 8
FSDP_MIN = 64
FORCED = 16  # forced tokens of the staged decode's logits
# train.run's tiny lyric prior (tests/test_torch_train_logging.py's, at
# width 32 so that its c_attn splits by heads) and its run
RUN_VQ = dict(sample_length=256, levels=3, downs_t=(2, 1, 1),
              strides_t=(2, 2, 2), emb_width=16, l_bins=32, l_mu=0.99,
              commit=0.02, width=8, depth=1, m_conv=1.0,
              dilation_growth_rate=1, sr=8000)
RUN_TOP = dict(level=2, n_ctx=16, prior_width=32, prior_depth=2, heads=2,
               attn_order=12, blocks=4, init_scale=0.7, labels=True,
               labels_v3=True, y_bins=(10, 100), t_bins=16,
               max_bow_genre_size=1, n_vocab=79, min_duration=0.0,
               max_duration=600.0, use_tokens=True, n_tokens=8,
               prime_loss_fraction=0.4, single_enc_dec=True, prior=True,
               train=True, lr=1e-3, lr_warmup=1.0, weight_decay=0.01)
RUN = dict(bs=2, max_steps=2, log_steps=1, save_iters=2, test=True,
           train_test_split=0.5, ema=True, cpu_ema=True, cpu_ema_freq=1,
           mu=0.99, name="run", restore_vqvae="", aug_shift=False,
           aug_blend=False, seed=3)
RUN_LABELS = ("dianne reeves", "bebop", "la la la, oh la la")


def train_run(outdir, which, **over):
    """train.run of RUN_TOP on outdir/wavs, logging under outdir/which:
    {records (losses, gns), test, files (under the log dir), ckpt}."""
    from jukebox_tpu_torch import hparams as thp
    from jukebox_tpu_torch import train
    from jukebox_tpu_torch.data.files_dataset import FixedMetadataDataset
    kw = dict(RUN_VQ, **RUN, **RUN_TOP, audio_files_dir=f"{outdir}/wavs",
              local_logdir=f"{outdir}/{which}")
    kw.update(over)
    h = thp.setup_hparams("teeny", kw)
    out = train.run("teeny", device="cpu",
                    dataset=FixedMetadataDataset(h, *RUN_LABELS), **kw)
    logdir = f"{outdir}/{which}/run"
    files = sorted(os.path.relpath(os.path.join(d, f), logdir)
                   for d, _, fs in os.walk(logdir) for f in fs) \
        if os.path.isdir(logdir) else []
    return dict(loss=[r["loss"] for r in out["records"]],
                gn=[r["gn"] for r in out["records"]], test=out["test"],
                files=files, ckpt=f"{logdir}/checkpoint_latest.jkb")


def vq_hps():
    from jukebox_tpu_torch.hparams import setup_hparams
    hps = setup_hparams("teeny", dict(VQ_MP))
    hps.bandwidth = {"l1": 1.0, "l2": 1.0, "spec": 1.0}
    return hps


def global_audio():
    return np.random.RandomState(0).uniform(
        -1, 1, (GLOBAL_BS, VQ_MP["sample_length"], 1)).astype(np.float32)


def vqvae_steps(mesh=None):
    """Three train steps of the VQ-VAE on the rank's slice of
    global_audio(): {losses, gns, digest (each parameter's float64 sum),
    ks (the codebooks)}."""
    from jukebox_tpu_torch.models.make_models import VQVAERuntime, make_vqvae
    from jukebox_tpu_torch.parallel.dist import batch_slice
    from jukebox_tpu_torch.parallel.placement import Placement
    from jukebox_tpu_torch.train import make_vqvae_train_step
    from jukebox_tpu_torch.utils.train_utils import (adam_init,
                                                     make_lr_schedule)
    hps = vq_hps()
    model = make_vqvae(hps, "cpu")
    runtime = VQVAERuntime(model)
    x = global_audio()
    if mesh is not None:
        runtime.placement = Placement(model, mesh)
        for blk in model.bottleneck.level_blocks:
            blk.group = mesh.dp_group
        x = x[batch_slice(GLOBAL_BS, mesh)]
    opt = adam_init(runtime.params)
    step = make_vqvae_train_step(runtime, hps, make_lr_schedule(hps))
    losses, gns = [], []
    for i in range(3):
        loss, m = step(opt, (torch.from_numpy(x), None), i, i + 1)
        losses.append(float(loss))
        gns.append(float(m["gn"]))
    return dict(losses=np.array(losses), gns=np.array(gns),
                digest=np.array([p.detach().double().sum().item()
                                 for p in model.parameters()]),
                ks=[blk.k.numpy().copy()
                    for blk in model.bottleneck.level_blocks])


def build_prior(inputs, which="prior", **over):
    """The test_parallel.py _build prior (train=True), or with which="up"
    the UP_PAR one, on the weights of inputs["vq"], inputs[which] (state
    dicts); over: hparams over the preset's."""
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    vq = make_vqvae(setup_hparams("teeny", dict(VQ_PAR)), "cpu")
    vq.load_state_dict(inputs["vq"])
    cfg = PRIOR_PAR if which == "prior" else UP_PAR
    hps = setup_hparams("teeny", dict(cfg, **over))
    runtime = make_prior(hps, vq, "cpu")
    runtime.model.load_state_dict(inputs[which])
    return runtime, hps


def prior_step(inputs, mesh, fsdp, which="prior", seed=None, **over):
    """One train step of the placed prior on the rank's rows of inputs'
    global batch (x, y; x_up, y_up for which="up"), its dropouts (if over
    turns them on) seeded by seed: {loss, gn, params (whole, gathered),
    local_frac (the rank's share of each parameter's elements)}."""
    from jukebox_tpu_torch.parallel.dist import dp_rows
    from jukebox_tpu_torch.parallel.placement import Placement
    from jukebox_tpu_torch.train import make_prior_train_step
    from jukebox_tpu_torch.utils.train_utils import (adam_init,
                                                     make_lr_schedule)
    runtime, hps = build_prior(inputs, which, **over)
    full = {n: p.numel() for n, p in runtime.model.named_parameters()}
    opt = adam_init(runtime.params)
    runtime.placement = Placement(runtime.model, mesh, fsdp=fsdp,
                                  min_size=FSDP_MIN)
    opt = dict(opt, m=runtime.placement.shard_dict(opt["m"]),
               v=runtime.placement.shard_dict(opt["v"]))
    x, y = ((inputs["x"], inputs["y"]) if which == "prior"
            else (inputs["x_up"], inputs["y_up"]))
    rows = dp_rows(x.shape[0] // mesh.dp, mesh)  # as the loader deals them
    step = make_prior_train_step(runtime, hps, make_lr_schedule(hps))
    loss, m = step(opt, (x[rows], y[rows]), seed, 1)
    params = runtime.placement.full_dict(runtime.params)
    return dict(loss=float(loss), gn=float(m["gn"]),
                params={n: t.numpy() for n, t in params.items()},
                local_frac={n: t.numel() / full[n]
                            for n, t in runtime.params.items()},
                specs=runtime.placement.specs)


def checkpoint(inputs, mesh, outdir):
    """The prior placed ZeRO-3 over dp with inputs' moments, saved as
    ckpt_world<N>/checkpoint_latest.jkb (rank 0)."""
    from jukebox_tpu_torch.models.make_models import save_model_checkpoint
    from jukebox_tpu_torch.parallel.placement import Placement
    runtime, hps = build_prior(inputs)
    opt = {"m": {n: t.clone() for n, t in inputs["m"].items()},
           "v": {n: t.clone() for n, t in inputs["v"].items()}, "step": 7}
    if mesh.world > 1:
        runtime.placement = Placement(runtime.model, mesh, fsdp=True,
                                      min_size=FSDP_MIN)
        opt = dict(opt, m=runtime.placement.shard_dict(opt["m"]),
                   v=runtime.placement.shard_dict(opt["v"]))
    path = save_model_checkpoint(f"{outdir}/ckpt_world{mesh.world}",
                                 "latest", runtime, opt, 7, hps)
    return dict(path=path, local={n: t.numel() for n, t in
                                  runtime.params.items()})


def forced_logits(runtime, y, n=FORCED, z_conds=None, stream=None):
    """Logits [B, n, bins] of the staged decode (runtime.staged: bf16, or
    int8 as stage_decode made it; the decode kernels' plain versions), one
    decode step a token, the first n tokens of the stream forced: y's
    lyrics then zeros for a single_enc_dec prior, else `stream`."""
    m, dec = runtime.model, runtime.staged
    B = y.shape[0]
    with torch.no_grad():
        x_cond, y_cond, prime = m.get_cond(z_conds, y)
        if m.single_enc_dec:
            z = torch.zeros((B, m.n_ctx), dtype=torch.long)
            stream, x_cond = m.prior_preprocess([prime, z], [None, x_cond])
        caches = m.prior.init_decode_caches(
            B, "cpu", fp16=True, dec_params=dec,
            int8=runtime.staged_mode[0] == "int8")
        x_tok = torch.zeros((B, 1), dtype=torch.long)
        out = []
        for t in range(n):
            out.append(m.prior._decode_one(dec, caches, x_tok, t,
                                           x_cond.to(torch.bfloat16), y_cond,
                                           True, B)[:, 0].float())
            x_tok = stream[:, t:t + 1]
    return torch.stack(out, 1).numpy()


def decode(inputs, mesh):
    """The prior split over mp: its tokens fp32 at temp 0 (top_k=1) and
    int8-staged in bf16, and the forced_logits of its bf16 and int8 staged
    decode."""
    runtime, _ = build_prior(inputs)
    runtime.stage_decode(mesh=mesh)
    y = inputs["y"]
    z = runtime.sample(y.shape[0], y=y, fp16=False, temp=0.0, chunk_size=8)
    logits = forced_logits(runtime, y)
    runtime.stage_decode(quantize="int8", mesh=mesh)
    z8 = runtime.sample(y.shape[0], y=y, fp16=True, temp=0.0, chunk_size=8)
    cache_cols = runtime.model.prior.transformer.blocks[0].attn.n_state
    return dict(tokens=z.numpy(), tokens_int8=z8.numpy(),
                cache_cols=cache_cols, logits=logits,
                logits_int8=forced_logits(runtime, y))


def up_decode(runtime, inputs):
    """The UP_PAR prior's fp32 tokens at top_k=1 (temp 1) on inputs'
    z_conds_up and the first rows of y_up, the logits of its bf16 staged
    decode on the forced stream inputs["z_up"], and its caches'
    columns."""
    zc = [inputs["z_conds_up"]]
    y = inputs["y_up"][:zc[0].shape[0]]
    toks = runtime.sample(y.shape[0], z_conds=zc, y=y, fp16=False,
                          temp=1.0, top_k=1, chunk_size=8)
    return dict(tokens=toks.numpy(), logits=forced_logits(
                    runtime, y, z_conds=zc, stream=inputs["z_up"]),
                cache_cols=runtime.model.prior.transformer.blocks[0]
                .attn.n_state)


def up_mp(inputs, mesh):
    """up_decode of the UP_PAR prior split over mesh's mp, after one
    train step of a second copy split alike (prior_step)."""
    out = prior_step(inputs, mesh, False, "up")
    runtime, _ = build_prior(inputs, "up", train=False)
    runtime.stage_decode(mesh=mesh)
    out.update(up_decode(runtime, inputs))
    return out


def main():
    torch.set_num_threads(1)
    outdir, jobs = sys.argv[1], sys.argv[2].split(",")
    from jukebox_tpu_torch.parallel.dist import make_mesh, setup_dist
    rank, world = setup_dist("cpu")
    assert (rank, world) == (int(os.environ["JAX_PROCESS_ID"]),
                             int(os.environ["JAX_NUM_PROCESSES"]))
    inputs_path = os.path.join(outdir, "inputs.pt")
    inputs = (torch.load(inputs_path, weights_only=True)
              if os.path.exists(inputs_path) else None)
    for job in jobs:
        if job == "vqvae":
            out = vqvae_steps(make_mesh(device="cpu"))
        elif job == "ckpt":
            out = checkpoint(inputs, make_mesh(device="cpu"), outdir)
        elif job == "decode":
            out = decode(inputs, make_mesh(1, world, device="cpu"))
        elif job == "dpmp":
            out = prior_step(inputs, make_mesh(world // 2, 2, device="cpu"),
                             False)
        elif job == "dpmp_drop":
            out = prior_step(inputs, make_mesh(world // 2, 2, device="cpu"),
                             False, seed=DROP_SEED, **DROP)
        elif job == "up_mp":
            out = up_mp(inputs, make_mesh(1, world, device="cpu"))
        elif job == "run_drop":
            out = train_run(outdir, job, aug_blend=True, **DROP)
        elif job == "fsdp":
            out = prior_step(inputs, make_mesh(device="cpu"), True)
        elif job == "run_mp":
            out = train_run(outdir, job, mesh_mp=world)
        elif job == "run_fsdp":
            out = train_run(outdir, job, fsdp=True)
        else:
            raise ValueError(job)
        torch.save(out, os.path.join(outdir, f"{job}_{rank}_of_{world}.pt"))
        print(f"rank {rank}/{world}: {job} done", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
