"""Drive the PyTorch port (jukebox_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases, each printing timestamped lines:
  0 device   the card's name and power limit (nvidia-smi); TF32 off; a
             watchdog turns a hang into an exit with a stack dump
  1 build    nvcc builds the CUDA kernels from jukebox_tpu_torch/csrc
  2 kernels  every bf16 decode kernel against its plain PyTorch version at
             the shapes of the 1b_lyrics priors (top: S 2048, A 512, 2
             heads; upsamplers: S 1920, A 480, 1 head) and of the 5b_lyrics
             top (S 4800, A 1200, 8 heads): the GEMV at every product of
             a layer, an N % 16 == 8 and a K % 16 == 10 one, at batch 4, 1,
             3 and 16: c_attn, f6 q and mlp c_fc with the LayerNorm
             prologue (ln_gemv_bf16: the same bits twice, out32, and two
             planted faults, one split left out of the row statistics and a
             skipped column tile), the residual products (gemv_bf16) with
             out32, keep and res_scale, the same bits on a second call, and
             two planted faults (a skipped column tile, one K split left
             out of the combine); every attention pattern at
             positions that cross block and prime boundaries, f0 also at
             129 rows and at n_ctx (its rows split over blocks, the slot
             row in the last, ragged split), and at every split position
             a planted fault (one split left out of the combine) that the
             check must refuse; the attention reads q in fp32 (the c_attn
             product's fp32 row, its bf16 rounding feeding the new k, v);
             times per launch beside the bound, the plain version and one
             library call (the LN-GEMV: F.layer_norm, then addmm); the
             summary pattern (f4) at the 1b top's widths ([4, 65, 512]
             caches: the zero pad and 64 summaries) before, at and after
             a block's last token and in the last block, output and
             caches, with a planted fault at every block end (the
             summary written one row off) that the check must refuse,
             timed at the last block beside its bound and SDPA
  3 step     one full-width decode step per prior, kernel path against the
             plain path on the same caches after a one-block prefill
  2b flash   the flash-attention kernels (forward, dq, dk/dv) against their
             plain versions at the top prior's f0 shape (B 1, L 6528, S 512,
             2 heads) and a ragged L, at dropout rates 0 and 0.1, and a
             planted fault (one tile skipped) that the check must refuse;
             dq and dk/dv also give the same bits on a second call and are
             refused with one split pair left out of the merge; times per
             launch beside the bound, the plain version and SDPA; the same
             at head dim 128, [8, 6528, 128] (small_single_enc_dec_prior's
             f0 layer at its recipe's batch)
  2c ln      the LayerNorm kernels (forward, backward) against their plain
             versions at the top's training rows [6528, 2048] bf16, at
             [6528, 1920] fp32, a ragged [1000, 1000] bf16, the 5b width
             [1024, 4800] bf16, [1000, 1001] fp16 (the element path) and
             [2, 12288] fp32, and a planted fault (the last row skipped); the
             backward gives the same bits on a second call; times beside
             the bound, the plain version and F.layer_norm (and its
             autograd backward)
  4 cascade  the 1b_lyrics ancestral cascade (labels -> top codes -> two
             4-layer upsamplers -> 44.1 kHz wav, each level's html with the
             top's lyric alignment) from random weights drawn from --seed (the
             priors' dense weights rounded to fp16 values, as upstream's
             fp16 files hold them), at the sample CLI's hop fractions 0.5,
             0.5, 0.125 (level 0: 7 windows, 6 after 4096 context tokens),
             with the sequential scheduler and the inline finalize
             (pipeline_cascade=False, JUKEBOX_ASYNC_FINALIZE=0), the
             reference for phase 4c; checks codes, audio,
             every level's wav, html and alignment PNG / JSON, and that
             every decode step of every prior went through the kernels, and
             every LayerNorm of the prefill (lyrics and context), the
             conditioners and the alignment forward, and its flash_fwd
             (launch counts); the alignment recomputed: shape, range, rows
             summing to at most 1, against the plain path (flash and
             LayerNorm plain) within ALIGN_TOL, and a planted fault (the
             next head) refused
  4c upstream phase 4's four models written as upstream's .pth.tar files
             (5b/vqvae, 5b/prior_level_0, 5b/prior_level_1,
             1b_lyrics/prior_level_2, at the presets' paths under a
             temporary HOME's ~/.cache/jukebox/models; hps pickled as
             jukebox.hparams.Hyperparams from a module that exists only
             while writing, the priors' dense weights in fp16, the top's
             keys under "module."), restored by make_model("1b_lyrics")
             through the presets' own restore paths: every parameter, the
             codebooks and the steps bit for bit; each file's bytes, save
             and restore seconds and the host's peak RSS; then phase 4's
             cascade again with the default scheduler (pipelined, finalize
             and staging on worker threads): codes equal to phase 4's at
             every level, phase 4's checks, stage seconds beside phase 4's
  4b primed  primed_sample from ~3 s of phase 4's first wav (load_prompts)
             at the same length, with phase 4's top and VQ-VAE, upsamplers
             of 4 layers, and the default scheduler: every level's
             first window carries the prompt's codes as context; the
             prompt's codes kept at every level, and phase 4's checks
  4d golden  the golden dump of 1b_lyrics at full width from random weights
             (make_models.save_outputs, as `python -m
             jukebox_tpu_torch.models.make_models 1b_lyrics` writes it):
             the codes and decodes of fixed audio at every level, the top's
             fp32 teacher-forced logits; shapes and finite values
  2e int8    gemv_int8, ring_attn_int8 (every ring pattern) and
             cross_attn_decode (f6, bf16 and int8 encoder K/V) against their
             plain versions at the 5b_lyrics top's shapes (S 4800, A 1200, 8
             heads of 150, 512 encoder rows and a ragged 500), the upsamplers'
             and the 1b top's; ln_gemv_int8 and gemv_int8 as ln_gemv_bf16 and
             gemv_bf16 in phase 2; a planted fault for each (a skipped column
             tile, one K split left out of the combine or of the row
             statistics, a dropped head, and wherever the rows
             split, one split left out of the combine); quantize_dense on the
             card bit for bit against the host; times beside the bound, the
             plain version and one library call (the GEMVs at all five 5b
             top products)
  7 5b       the 5b_lyrics cascade from --seed: one full-width top decode
             step (79 layers) kernel path against plain path in bf16 and
             in int8, one int8 upsampler step, then the ancestral cascade
             in the int8 mode (int8 weights and ring caches in every
             prior, the context prefill writing int8 rows), lyric encoder
             -> 79-layer top -> two 8-layer upsamplers -> wav and html with the
             top's alignment (layer 68, f6, head 2; deferred: the top's
             params exceed 6e9 bytes), with the default scheduler and phase
             4's checks
             and the launch counts of every decode kernel (f6 included) and
             of the LayerNorm kernels; then prior_5b at full width, one
             decode step kernel path against plain path
  2d adam    the Adam kernel against its plain loop on the top prior's
             871 parameter tensors, fp32 and fp16 moments, three updates,
             run twice with equal bits, and planted faults (an update item
             and, with fp16 moments, an amax item of the largest tensor
             left out of the walk); the update's time (one launch) beside
             the bound and the plain loop
  5 train    one full-width train step of the 1b_lyrics top prior (72
             layers, all_fp16): loss and gradients through the flash and
             LayerNorm kernels against the plain path on one batch, against
             the path with flash alone plain, and a planted flash fault that
             the checks must refuse; the launch counts; one step timed by
             parts and one under torch.profiler; then 9 (c) on the same
             batch, and the fp32 decode (the in-training sample's) of 128
             tokens as a CUDA graph a token against op by op at temp 0:
             equal tokens, the LayerNorm wrapper's launches less the
             replayed steps', and the replays' LayerNorm kernels counted
             in a profiler trace of the graphed decode
  6 run      train.run: six optimizer steps of the top prior from two
             synthetic 40 s wavs (labelled dataset, aug_shift, aug_blend,
             loss scaling, fp16 Adam, host EMA every 2 steps), saving
             checkpoint_latest.jkb and sampling a window (fp32, under the
             EMA weights) at step 1; checks finite losses, the sample's
             codes and audio, launch counts of every training kernel (the
             sample's LayerNorms too), and that no thread outlives the
             run; then a run restored from the checkpoint holds its
             params, optimizer state and step bit for bit and takes two
             more steps, and a sampling make_prior restored from it holds
             its params as fp16_params casts them (bf16, LayerNorms fp32);
             the checkpoint's size, save and load times
  8 vq       the README's Quick start on two songs it writes (239 s stereo
             at 44.1 kHz, an IEEE float32 and an int16 wav, resampled to
             22.05 kHz as they are read): (a) the first command, small_vqvae
             through train.run for six steps at 262144 samples, bs 4, a
             checkpoint_step_1.jkb with the codebook state; finite losses
             and codebook metrics, codes in use, one Adam launch a step, no
             thread left; its restore bit for bit, and restored for
             training the fine-tuning reset as its formula; (b) the vqvae
             preset at its published widths (3 levels, multipliers 2, 1, 1,
             2048 codes), fresh: its gradients' Adam update through the
             kernel against the plain loop on its own tensors, with a
             planted fault (a one-element tensor's update item left out),
             then one train step timed with its peak memory; (c) the second
             command, small_prior (48 layers at width 1024, n_ctx 8192,
             all_fp16, cpu_ema) over (a)'s checkpoint for three steps, each
             epoch one step and one test batch: finite losses, the launches
             of the LayerNorm, flash (none: no dense layer) and Adam
             kernels, the sample at step 1, step walls and peak memory
  9 recipes  upstream's other training recipes on (a)'s checkpoint and
             songs: (a) the upsampler (small_upsampler at full depth: 48
             layers at 1024, a 16-layer conditioner at 512) through
             train.run for 3 steps with JUKEBOX_TRAIN_JSONL and
             debug_speed: finite losses, LayerNorm and Adam launches, the
             logger's files (every metric's scalar each step in the events
             read back with CRCs, argv.txt, the input wavs of steps 1 and 3,
             the sample's, JSONL lines with JAX's keys), the step-1 sample
             at full depth (codes in [0, 1024), finite audio, its wall),
             the trace of step 3 (d) naming the LayerNorm kernels, and the
             trained prior's fp32 decode as a CUDA graph against op by op;
             (b) small_labelled_prior, small_single_enc_dec_prior and
             small_sep_enc_dec_prior over a fresh 3-level vqvae on labels
             inside their y_bins: one full-depth step each through the
             kernels against the plain path (RECIPE_TOL), which must
             refuse a planted LayerNorm fault (the last 16 bytes of every
             row zero; phase 2c's one-row fault read beside it), the
             single-enc-dec one (its f0 layer at head dim 128) also
             against flash alone plain (LOSS_TOL / GN_TOL), then
             train.run for 2 steps at a cut depth (4 layers; sep-enc-dec
             10, keeping its f6 layer) with
             the checks of (a) and the labels' text in the events; (c) runs
             after phase 5: its step with c_attn = c_mlp = 1 against c_res
             alone, loss and gradients bit for bit where c_res alone repeats
             to the bit, peak memory of both
  10 parallel phase 5's top prior (all_fp16) at its width 2048 and 48 of
             its 72 layers (the f0 layer at 47 kept) across ranks
             (parallel/): world 1's references on one set of weights (a
             step at bs 2 and at bs 1, the kernel decode of 64 forced
             tokens in bf16 and 16 in int8); (a) fsdp=True, mesh_dp=1 over
             a process group of one (NCCL) in this process, against the
             unsharded step;
             (b) two ranks on the one card over gloo, started from here,
             every part run (a collective that fails fails the phase):
             the dp=2 and the ZeRO-3 dp=2 steps against world
             1 at bs 2 (ZeRO-3: each rank's params + m + v about half of
             world 1's), the mp=2 step (Megatron split) against world 1 at
             bs 1, and the decode at mp=2 in bf16 and in int8 (its kernels
             on the rank's heads, rows and columns, K/V caches halved, an
             int8 row scaled by the rank's piece) within STEP_TOL of world
             1's logits, with each rank's launches. The weights' biases
             are drawn nonzero from the seed, so that every comparison
             sees where a row-split product's bias is added. Also over
             gloo: the dp=2 step with dropout 0.1 (attention, residual,
             embedding) and aug_blend against world 1's at bs 2 (each
             rank's masks and mix its rows' of the global batch's), and
             upsampler_level_1 at its widths (1920, 1 head, its 16-layer
             conditioner) cut to 8 layers at mp=2, its head run whole on
             both ranks: its step against world 1's at bs 1 and the decode
             of 64 forced tokens in bf16 against world 1's logits, its K/V
             caches whole
  11 summary attn orders 3 ([1, 4], 8 layers: nothing packed) and 5 ([1,
             4, 1, 1], 9 layers: the f1 layers packed, the f4 ones not) at
             the 1b top's widths (2048, 2 heads, n_ctx 6144 in 64 blocks),
             labels without lyrics, from --seed: through the PriorRuntime
             pieces, 2 blocks of context prefilled then 4 blocks sampled,
             in bf16 and in the int8 mode (int8 weights everywhere, int8
             caches on the packed layers alone, as the JAX package stages
             them); the kernel path against the plain path on the same
             caches at the first step and at a block's last token (within
             STEP_TOL), every decode and LayerNorm launch counted by kind
             against the steps' and chunks'; runs after phase 3
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed check raises: exit code != 0.
It runs on the GPU only; without one it exits with an error.
"""

import argparse
import contextlib
import faulthandler
import functools
import json
import math
import multiprocessing
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import wave

import numpy as np
import torch
import torch.nn.functional as F

from jukebox_tpu_torch import align as align_mod
from jukebox_tpu_torch import sample as sample_mod
from jukebox_tpu_torch import save_html
from jukebox_tpu_torch import train as train_mod
from jukebox_tpu_torch.data.files_dataset import (FilesAudioDataset,
                                                  FixedMetadataDataset)
from jukebox_tpu_torch.hparams import REMOTE_PREFIX, Hyperparams, setup_hparams
from jukebox_tpu_torch.models import autoregressive as ar
from jukebox_tpu_torch.models import make_models as mm
from jukebox_tpu_torch.models.encdec import EncoderConvBlock
from jukebox_tpu_torch.models.make_models import (LN_KEYS, MODELS,
                                                  VQVAERuntime, make_model,
                                                  make_prior, make_vqvae)
from jukebox_tpu_torch.models.transformer import ATTN_ORDERS
from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops import adam as ad
from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.ops import flash_attention as fa
from jukebox_tpu_torch.ops import layer_norm as ln
from jukebox_tpu_torch.ops.core import (Conv1d, ConvTranspose1d, Dense,
                                        LayerNorm, Table, quantize_dense)
from jukebox_tpu_torch.utils import avio, profiler, wavio
from jukebox_tpu_torch.utils.audio_utils import (audio_preprocess,
                                                 calculate_bandwidth)
from jukebox_tpu_torch.utils.checkpoints import load_checkpoint
from jukebox_tpu_torch.utils.convert import STATE_KEYS, named_leaves
from jukebox_tpu_torch.utils.sample_utils import get_starts

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense, data sheet
ROTATE_BYTES = 256 << 20     # inputs rotated per timing: > 2x the 50 MB L2
KERNEL_TOL = 1e-2            # kernel vs plain, relative to max(1, |plain|)
STEP_TOL = 5e-2              # full-stack logits, relative to max(1, |plain|)
# the cascade: 4 samples of 262144 audio samples (5.94 s), the shortest
# cascade whose upsamplers get a full window of conditioning codes; the
# upsamplers run 4 of their 72 layers in the 1b_lyrics cascades (phases 4,
# 4c, 4b; 8 before phase 9 came) and 8 in the 5b_lyrics one (phase 7,
# UPS_DEPTH_5B) so the whole run stays near 15 minutes (their decode loop
# is bound by the host's launch rate)
N_SAMPLES, SAMPLE_LENGTH, UPS_DEPTH, TEMP = 4, 262144, 4, 0.99
UPS_DEPTH_5B = 8
# the sample CLI's documented hop fractions (jukebox_tpu/utils/cli.py:4):
# level 0 samples 7 windows, 6 of them after 4096 context tokens
HOPS = (0.5, 0.5, 0.125)
# phase 4b's prompt: about 3 s of phase 4's first wav, rounded down to a
# multiple of the top's raw_to_tokens
PROMPT_SECONDS = 3.0
GEMV_BATCHES = (1, 3, 16)    # phases 2, 2e: the GEMVs also at these batches
# flash kernels against their plain versions: fa.agreement, an elementwise
# bound of two bf16 steps of |plain| plus AGREE_ATOL of the row's RMS; a
# planted fault (skip_tile) must break it
# the full-width train step (bf16 through 72 layers), two comparisons:
# (1) flash alone: the kernel path against the path whose flash layer runs
# its plain versions, the LayerNorm kernels on both sides, so only the f0
# layer's attention differs: the loss relative to |loss|, the global
# gradient norm relative, and layer 47's c_attn.w and c_proj.w gradients
# as ||kernel - reference|| / ||reference||, held to LOSS_TOL, GN_TOL and
# GRAD_TOL. The planted fault (its flash forward skips a tile) moves only
# c_proj.w's gradient, which reads the forward's out, beyond the sound
# path's noise: 4.5e-3 against 7.7e-4, so its limit lies between them. The
# others sit at 5-9x the sound path's largest reading (loss 1.2e-6, grad
# norm 1.8e-5, c_attn.w 7.8e-4; H100 smoke runs).
# (2) the whole kernel path (flash and 288 LayerNorm launches) against the
# all-plain path, held to FULL_TOL: the LayerNorm kernels round 1 in ~2^9
# of their bf16 outputs otherwise than the plain versions (phase 2c), which
# lifts both probes' gaps to 1.8e-3 (loss 1.3e-6, grad norm 8.4e-6; H100
# smoke), so the probes get c_attn.w's limit of (1); the planted flash
# fault cannot be told from this noise here (c_proj.w 4.6e-3), which is
# why (1) isolates flash.
# the cascade's lyric alignment against its plain path (flash and
# LayerNorm plain), alignment_gap: the error over the alignment's own
# departure from flat rows. The bf16 roundings of the LayerNorm kernels
# (and flash's, 1b) carried through 63-68 random layers move it: the sound
# path read 4.0e-2 (5b), 6.5e-2 and 7.6e-2 (1b primed and ancestral); the
# planted fault (the next head) 1.35-2.34 (H100 smoke). The limit sits
# 3.3x over the first, 5.4x under the second.
ALIGN_TOL = 0.25
LOSS_TOL, GN_TOL = 1e-5, 1e-4
GRAD_TOL = {"c_attn": 5e-3, "c_proj": 2e-3}
FULL_TOL = {"loss": 1e-5, "grad norm": 1e-4, "c_attn": 5e-3, "c_proj": 5e-3}
# phase 9 (b): a labelled or lyric prior's full-depth step through the
# kernels against the all-plain path. The LayerNorm kernels' bf16 roundings
# (phase 2c) carried through 48-50 fresh layers at bs 4 moved the loss by
# 2.7e-6 to 2.0e-5 of itself and the grad norm by 8.4e-7 to 1.3e-5
# (eleven readings, H100 smoke runs): over FULL_TOL's loss limit. A
# planted fault in every LayerNorm forward (faulty_layer_norm "vector":
# the last 16 bytes of every row zero) moved them by 8.2e-3 to 1.7e-2 and
# 9.2e-4 to 1.2e-2 (three readings), so both limits sit 5-8x over the
# sound path's largest reading and 9-80x under the fault's smallest,
# which the check must refuse. Phase 2c's fault (one row of a launch)
# moved them by no more than the sound path's noise (4.0e-6 to 1.9e-5,
# 3.1e-6 to 1.5e-5): the step cannot see it, phase 2c does. Flash alone
# is held to LOSS_TOL / GN_TOL (read: 9.5e-8 to 2.8e-7, 7.9e-6 to
# 9.2e-6).
RECIPE_TOL = {"loss": 1e-4, "grad norm": 1e-4}
# the training configuration: upstream's fine-tuning command for the
# 1b_lyrics top prior (README "Fine-tune pre-trained top-level prior")
TRAIN_HPS = "vqvae,prior_1b_lyrics,all_fp16,cpu_ema"
TRAIN_KW = dict(level=2, levels=3, prior=True, train=True, labels=True,
                bs=1, weight_decay=0.01, aug_shift=True, aug_blend=True,
                sample_length=6144 * 128)
TRAIN_STEPS, CPU_EMA_FREQ, WAV_SECONDS = 6, 2, 40
LYRICS = ("I met a traveller from an antique land who said: two vast and "
          "trunkless legs of stone stand in the desert. Near them, on the "
          "sand, half sunk, a shattered visage lies.")
T0 = time.time()


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')} +{time.time() - T0:7.1f}s] {msg}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 0 / 1
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device is available; this "
                         "script measures the port on the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(1200, exit=True)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"phase 0 device: {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {card}")
    return name, count


def phase_build():
    t = time.time()
    logs = _build.build_all()
    for stem, info in logs.items():
        log(f"phase 1 build {stem}.cu: {info['seconds']:.1f}s nvcc"
            f"{' (cached)' if info['cached'] else ''}")
        for line in _build.ptxas_summary(info["ptxas"]):
            log(f"  ptxas {line}")
    smem = _build.lib("flash_attention").jk_flash_smem
    log("  dynamic shared memory per block at hd 256: " + ", ".join(
        f"{k} {smem(i, 256)} B" for i, k in enumerate(fa.LAUNCHES)))
    log(f"phase 1 build done in {time.time() - t:.1f}s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(fn, arg_sets, reps=200):
    """GPU time per call of fn(*args) over rotating arg sets: the stream is
    held busy while the calls are queued, so the events time the device
    back to back rather than the host's launch rate."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s of device time to queue behind
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _copies(nbytes):
    return max(2, math.ceil(ROTATE_BYTES / max(nbytes, 1)))


def bound(nbytes, flops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(out, ref):
    e = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return e, e / scale


class KernelReport:
    """Per kernel: the worst error over every checked shape and the times
    of its representative main-path shape."""

    def __init__(self):
        self.rows = {}

    def check(self, name, out, ref, what):
        e, rel = _err(out, ref)
        log(f"  {name} {what}: max_abs_err {e:.3e} (rel {rel:.2e}, "
            f"tol {KERNEL_TOL:g})")
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version ({e:.3e})")
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], e)

    def timed(self, name, shape, ms, plain_ms, library_ms, nbytes, flops,
              kind):
        bound_ms, by = bound(nbytes, flops, kind)
        lib = ("none" if library_ms is None
               else f"{library_ms * 1e3:.2f} us")
        log(f"  {name} {shape}: {ms * 1e3:.2f} us/launch, bound "
            f"{bound_ms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"library {lib}")
        return dict(shape=shape, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=by)


def prior_shapes(prior):
    tr = prior.model.prior.transformer
    blk = tr.blocks[0]
    return dict(S=tr.n_in, A=blk.attn.n_state, H=tr.n_head,
                Sm=blk.mlp.c_fc.w.shape[1], bc=blk.attn.block_ctx,
                blocks=blk.attn.blocks, n_ctx=tr.n_ctx,
                prime=(tr.blocks[15].attn._prime_len
                       if tr.n_depth > 15 and tr.attn_func(15) == 7 else None),
                enc=None, funcs=sorted({tr.attn_func(d)
                                        for d in range(tr.n_depth)}))


def preset_shapes(name):
    """prior_shapes of a preset without building it (a separate lyric
    encoder's encoder_dims as enc)."""
    h = setup_hparams(name, {})
    S = h.prior_width
    return dict(S=S, A=int(h.m_attn * S), H=h.heads, Sm=int(h.m_mlp * S),
                bc=h.n_ctx // h.blocks, blocks=h.blocks, n_ctx=h.n_ctx,
                prime=None, enc=(h.n_tokens if h.use_tokens
                                 and not h.single_enc_dec else None),
                funcs=sorted({ATTN_ORDERS[h.attn_order](d)
                              for d in range(h.prior_depth)}))


def attn_positions(sh, last_t, f=None):
    """Positions that cross block and prime boundaries up to last_t; the
    dense f0 ring also at ONE_SPLIT_ROWS (n one past a single split: three
    splits, the last of two rows) and at n_ctx - 1 (the whole cache), so
    its live rows span several splits with the slot row in the last,
    ragged one."""
    bc = sh["bc"]
    ts = {0, bc - 1, bc, 2 * bc + 1, last_t}
    if sh["prime"]:
        ts |= {sh["prime"] - 1, sh["prime"]}
    ts = {t for t in ts if t <= last_t}
    if f == 0:
        ts |= {ds.ONE_SPLIT_ROWS + 1, sh["n_ctx"] - 1}
    return sorted(t for t in ts if t < sh["n_ctx"])


def dropped_split(geom, B, H, hd, device):
    """(lo, hi) cache rows of one split of the attention kernels' plan for
    this geometry (a middle one, never the slot row's), or None when the
    rows run in one split: the split that the planted split fault leaves
    out of the combine."""
    rows, w, r0, n = geom
    splits, chunk, _ = ds.attn_split_plan(n, B, H, hd, ds.sm_count(device))
    if splits == 1:
        return None
    z = splits // 2
    if r0 + z * chunk <= w < r0 + (z + 1) * chunk:
        z -= 1
    return r0 + z * chunk, r0 + min((z + 1) * chunk, n)


def split_fault_caches(q, caches, lo, hi, A, H):
    """The planted split fault, as inputs: (caches with the split's values
    raised, so its share of the output shows, and the same caches with that
    split's keys turned against q, so the split's weights are exactly 0 and
    a kernel fed them computes the output without that split). caches:
    (k, v) bf16 [B, rows, A], or (k, v, ks, vs) int8 with row scales."""
    B = q.shape[0]
    sign = torch.sign(q[:, :A].float()).reshape(B, 1, A)
    shown = [c.clone() for c in caches]
    v3 = shown[1].view(B, -1, A)
    if len(caches) == 2:
        v3[:, lo:hi] = (v3[:, lo:hi].float() + 8.0).to(v3.dtype)
    else:
        v3[:, lo:hi] = 127
        shown[3].view(B, -1)[:, lo:hi] = 0.06
    dropped = [c.clone() for c in shown]
    k3 = dropped[0].view(B, -1, A)
    if len(caches) == 2:
        k3[:, lo:hi] = (-64.0 * sign).to(k3.dtype)
    else:
        k3[:, lo:hi] = (-127.0 * sign).to(torch.int8)
        dropped[2].view(B, -1)[:, lo:hi] = 0.5
    return shown, dropped


def check_kernels(shapes, B, last_t, device, gen, time_it=True):
    """Hold every kernel against its plain version at each prior shape in
    `shapes` ({label: prior_shapes(...)}): the bf16 GEMV at every product
    of gemv_products and at batch B and GEMV_BATCHES (check_gemv_ln with
    the LayerNorm prologue, check_gemv at the residual products), the
    attention at every pattern and at positions crossing block and prime
    boundaries; time every shape at batch B (attention at last_t[label]).
    Returns KernelReport.rows: the worst error of each kernel and the
    times of its representative shape (the first label's LayerNorm, qkv
    GEMV and f0 attention)."""
    rep = KernelReport()
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def copies(make, nbytes):
        """Input sets to rotate through while timing (none when not)."""
        return [make() for _ in range(_copies(nbytes))] if time_it else []

    def time3(name, what, kernel, plain, library, sets, lib_sets, nbytes,
              flops, kind, representative):
        if not time_it:
            return
        row = rep.timed(name, what, device_ms(kernel, sets),
                        device_ms(plain, sets), device_ms(library, lib_sets),
                        nbytes, flops, kind)
        if representative:
            timings[name] = row

    timings = {}
    for label, sh in shapes.items():
        S, A, H, Sm = sh["S"], sh["A"], sh["H"], sh["Sm"]
        main = label == next(iter(shapes))
        # -- every product of a layer at B and GEMV_BATCHES: the LayerNorm
        # products with the prologue (ln_gemv_bf16), the residual products
        # (gemv_bf16)
        for what, K, N, epi in gemv_products(sh):
            w, b = rnd(K, N, scale=0.02), rnd(N, scale=0.02)
            g_ln, b_ln = ln_params(K, gen, device)
            for Bx in [B] + [n for n in GEMV_BATCHES if n != B]:
                shape = (f"{label} {what} [{Bx},{K}]x[{K},{N}]"
                         f"{f' {epi}' if epi else ''}")
                if epi in ds.LN_EPILOGUES:
                    check_gemv_ln(rep, "gemv_bf16", shape, ln_rows_in(
                        Bx, K, gen, device), (w,), b, epi, (g_ln, b_ln),
                        device)
                else:
                    check_gemv(rep, "gemv_bf16", shape, rnd(Bx, K), (w,), b,
                               epi, rnd(Bx, N), device)
            if "," in what:  # the layout cases are checked, not timed
                continue
            if epi not in ds.LN_EPILOGUES:
                res = rnd(B, N)
                sets = copies(lambda: (rnd(B, K), rnd(K, N, scale=0.02), b,
                                       epi, res), K * N * 2)
                # the library call: the product and bias in one cuBLAS call
                time3("gemv_bf16", f"{label} {what} [{B},{K}]x[{K},{N}]",
                      ds.gemv_bf16, ds.gemv_bf16_plain,
                      lambda x_, w_, b_: torch.addmm(b_, x_, w_), sets,
                      [a[:3] for a in sets],
                      K * N * 2 + B * K * 2 + N * 2 + B * N * 2 * 2,
                      2 * B * K * N, "bf16", main and what == "mlp.c_proj")
                continue
            # the library pair: F.layer_norm, then addmm
            ln_ = (g_ln, b_ln)
            sets = copies(lambda: (ln_rows_in(B, K, gen, device),
                                   rnd(K, N, scale=0.02), b, epi), K * N * 2)
            time3("ln_gemv_bf16", f"{label} {what} [{B},{K}]x[{K},{N}]",
                  functools.partial(ds.gemv_bf16, ln=ln_),
                  lambda x_, w_, b_, e_: ds.ln_gemv_bf16_plain(x_, w_, b_,
                                                               ln_, e_),
                  lambda x_, w_, b_: torch.addmm(b_, F.layer_norm(
                      x_, (K,), g_ln.to(bf), b_ln.to(bf), ds.LN_EPS), w_),
                  sets,
                  [a[:3] for a in sets], ln_gemv_bytes(B, K, N, 2),
                  2 * B * K * N + 8 * B * K, "bf16", main and what == "c_attn")
        # -- ring_attn_decode, every ring pattern of this prior (f6: phase 2e)
        for f in (f for f in sh["funcs"] if f != 6):
            shape = {0: (B, sh["n_ctx"], A), 1: (B, sh["bc"], A),
                     2: (B, sh["bc"], sh["blocks"], A), 3: (B, 2 * sh["bc"], A),
                     7: (B, sh["prime"] or 1, A)}[f]
            kc, vc = rnd(*shape), rnd(*shape)
            for t in attn_positions(sh, last_t[label], f):
                geom = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])
                # the c_attn product's fp32 row and its bf16 rounding
                qkv32 = rnd(B, 3 * A, dtype=torch.float32)
                qkv = qkv32.to(bf)
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                out = ds.ring_attn_decode(qkv, k1, v1, geom, H, qkv32)
                ref = ds.ring_attn_decode_plain(qkv, k2, v2, geom, H, qkv32)
                what = f"{label} f{f} t={t} rows {geom[2]}+{geom[3]}"
                rep.check("ring_attn_decode", out, ref, what)
                if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                    raise AssertionError(f"f{f} t={t}: cache write differs")
                cut = dropped_split(geom, B, H, A // H, device)
                if cut is not None:
                    shown, dropped = split_fault_caches(qkv32, (kc, vc),
                                                        *cut, A, H)
                    refuse("ring_attn_decode",
                           ds.ring_attn_decode(qkv, *dropped, geom, H, qkv32),
                           ds.ring_attn_decode_plain(qkv, *shown, geom, H,
                                                     qkv32),
                           f"{what} split {cut[0]}:{cut[1]} dropped")
            # time the same work (n live rows read, one slot written) on
            # caches holding just those rows, so the rotated copies stay small
            t = last_t[label]
            _, w, _, n = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])
            geom = (n, n - 1 if w >= 0 else -1, 0, n)
            hd, live = A // H, B * n * A * 2 * 2

            def ring_set():
                q32 = rnd(B, 3 * A, dtype=torch.float32)
                return (q32.to(bf), rnd(B, n, A), rnd(B, n, A), geom, H, q32)
            sets = copies(ring_set, live)
            lib_sets = [tuple(z.reshape(B, -1, H, hd).transpose(1, 2).contiguous()
                              for z in (qkv_[:, :A], k_, v_))
                        for qkv_, k_, v_, *_ in sets]
            time3("ring_attn_decode", f"{label} f{f} t={t} ({n} rows)",
                  ds.ring_attn_decode, ds.ring_attn_decode_plain,
                  F.scaled_dot_product_attention, sets, lib_sets,
                  live + B * A * 4 + B * 2 * A * 2
                  + (2 * B * A * 2 if w >= 0 else 0)
                  + B * A * 2, 4 * B * n * A, "bf16", main and f == 0)
    for name, row in rep.rows.items():
        row.update(timings.get(name, {}))
    return rep.rows


# ---------------------------------------------------------------------------
# phase 2e: the int8 and cross-attention decode kernels against their plain
# versions
# ---------------------------------------------------------------------------

def skip_col_tile(w_q):
    """A copy of w_q [K, N] with its last ds.GEMV_COLS columns zeroed: a
    GEMV that skips its last column tile (and, where the last tile is
    ragged, part of the one before), a planted fault of the GEMVs."""
    w_q = w_q.clone()
    w_q[:, -ds.GEMV_COLS:] = 0
    return w_q


def k_split_fault(x, N, device):
    """The other planted fault of the GEMVs, as inputs: (x with the rows of
    one K split of gemv_split_plan (a middle one) raised, so its share of
    the product shows; the same x with those rows zeroed, of which a kernel
    computes what a kernel that leaves the split out of the combine would
    compute from the first; the split's rows), or None when K runs in one
    split."""
    B, K = x.shape
    splits, chunk, _ = ds.gemv_split_plan(K, N, ds.sm_count(device))
    if splits == 1:
        return None
    lo, hi = (splits // 2) * chunk, min((splits // 2 + 1) * chunk, K)
    shown = x.clone()
    shown[:, lo:hi] = (shown[:, lo:hi].float() * 8.0).to(x.dtype)
    dropped = shown.clone()
    dropped[:, lo:hi] = 0
    return shown, dropped, (lo, hi)


def gemv_products(sh):
    """(what, K, N, epilogue) of every GEMV of a decode layer of a prior
    (prior_shapes; the epilogues None and "gelu" take the LayerNorm
    prologue), then two layout cases of its c_attn: N % 16 == 8 (a lane's
    last 8 columns past N; int8 rows 8-byte aligned) and a K that is
    neither a multiple of 16 nor of 4 (x read element by element)."""
    S, A, Sm = sh["S"], sh["A"], sh["Sm"]
    out = [("c_attn", S, 3 * A, None), ("c_proj", A, S, "residual"),
           ("mlp.c_fc", S, Sm, "gelu"), ("mlp.c_proj", Sm, S, "residual"),
           ("c_attn, N % 16 = 8", S, 3 * A // 16 * 16 + 8, None),
           ("c_attn, K % 16 = 10", S // 16 * 16 - 6, 3 * A, None)]
    if sh["enc"]:
        out.insert(1, ("f6 c_attn (q)", S, A, None))
    return out


def check_gemv(rep, name, what, x, wts, b, epi, res, device):
    """A residual GEMV (name "gemv_bf16" with wts (w,), "gemv_int8" with
    (w_q, s); epi "residual") against its plain version on one product:
    the same bits on a second call, out32 (the fp32 row beside it), keep
    (the product kept beside the sum) and the res_scale residual; and both
    planted faults refused by the same check (the last column tile
    skipped; one K split left out of the combine)."""
    fn, plain = getattr(ds, name), getattr(ds, f"{name}_plain")
    ref = plain(x, *wts, b, epi, res)
    out = fn(x, *wts, b, epi, res)
    rep.check(name, out, ref, what)
    if not torch.equal(out, fn(x, *wts, b, epi, res)):
        raise AssertionError(f"{name} {what}: a second call gave other bits")
    y, y32 = fn(x, *wts, b, epi, res, out32=True)
    yp, y32p = plain(x, *wts, b, epi, res, out32=True)
    rep.check(name, y, yp, f"{what} out32")
    rep.check(name, y32, y32p, f"{what} out32's fp32 row")
    # x + (a + m) * rs with res = x, res2 = a; and the kept product
    res2, rs = res.roll(1, dims=1), 1.0 / 79
    rep.check(name, fn(x, *wts, b, "res_scale", res, res2, rs),
              plain(x, *wts, b, "res_scale", res, res2, rs),
              f"{what} res_scale")
    yk, ak = fn(x, *wts, b, "residual", res, keep=True)
    yp, ap = plain(x, *wts, b, "residual", res, keep=True)
    rep.check(name, yk, yp, f"{what} residual+kept")
    rep.check(name, ak, ap, f"{what} kept product")
    refuse(name, fn(x, skip_col_tile(wts[0]), *wts[1:], b, epi, res), ref,
           f"{what} last column tile skipped")
    cut = k_split_fault(x, wts[0].shape[1], device)
    if cut is not None:
        shown, dropped, (lo, hi) = cut
        refuse(name, fn(dropped, *wts, b, epi, res),
               plain(shown, *wts, b, epi, res),
               f"{what} K split {lo}:{hi} left out")


def ln_params(K, gen, device):
    """A LayerNorm's fp32 gain and bias [K], drawn from gen."""
    g = 1.0 + 0.1 * torch.randn(K, generator=gen, device=device)
    return g, 0.1 * torch.randn(K, generator=gen, device=device)


def ln_rows_in(B, K, gen, device):
    """Residual-stream rows [B, K] bf16: an offset and a spread, as the
    LayerNorm meets them."""
    return (2.0 * torch.randn((B, K), generator=gen, device=device)
            + 0.5).to(torch.bfloat16)


def ln_gemv_bytes(B, K, N, w_bytes):
    """Bytes of one LN-GEMV launch: x, g and b, W, the bias and y."""
    return B * K * 2 + 2 * K * 4 + K * N * w_bytes + N * 2 + B * N * 2


def stats_fault_ln(x, ln, N, device):
    """The planted fault of the LayerNorm prologue, as inputs: a kernel
    that leaves one split's partial (a middle one, its columns raised so it
    shows) out of the row statistics normalises x [1, K] with mean' and
    rstd' over the other splits' columns; from (g', b') = (g rstd' / rstd,
    b + (mean - mean') rstd' g) the sound kernel computes that same row.
    Returns (x with the split raised, (g', b'), the split's columns), or
    None when K runs in one split."""
    K = x.shape[1]
    splits, chunk, _ = ds.gemv_split_plan(K, N, ds.sm_count(device))
    if splits == 1:
        return None
    lo, hi = (splits // 2) * chunk, min((splits // 2 + 1) * chunk, K)
    shown = x.clone()
    shown[:, lo:hi] = (shown[:, lo:hi].float() + 4.0).to(x.dtype)
    xf = shown.float()[0]
    keep = torch.ones(K, dtype=torch.bool, device=x.device)
    keep[lo:hi] = False
    mean = xf.mean()
    rstd = torch.rsqrt((xf - mean).square().mean() + ds.LN_EPS)
    mean_f = xf[keep].sum() / K
    rstd_f = torch.rsqrt((xf[keep] - mean_f).square().sum() / K + ds.LN_EPS)
    g, b = ln
    return shown, (g * (rstd_f / rstd), b + (mean - mean_f) * rstd_f * g), \
        (lo, hi)


def check_gemv_ln(rep, name, what, x, wts, b, epi, ln, device):
    """A GEMV with the LayerNorm prologue ("gemv_bf16" or "gemv_int8" with
    ln=(g, b), epi None or "gelu"; counted as ln_<name>) against
    gemv_plain(ln_rows_plain(x)) on one product: the same bits on a second
    call, out32 (the fp32 row beside it), and two planted faults refused by
    the same check (one split's partial left out of the row statistics,
    stats_fault_ln, at batch 1; the last column tile skipped)."""
    key = "ln_" + name
    fn, plain = getattr(ds, name), getattr(ds, f"{key}_plain")
    ref = plain(x, *wts, b, ln, epi)
    out = fn(x, *wts, b, epi, ln=ln)
    rep.check(key, out, ref, f"{what} ln")
    if not torch.equal(out, fn(x, *wts, b, epi, ln=ln)):
        raise AssertionError(f"{key} {what}: a second call gave other bits")
    y, y32 = fn(x, *wts, b, epi, out32=True, ln=ln)
    yp, y32p = plain(x, *wts, b, ln, epi, out32=True)
    rep.check(key, y, yp, f"{what} ln out32")
    rep.check(key, y32, y32p, f"{what} ln out32's fp32 row")
    refuse(key, fn(x, skip_col_tile(wts[0]), *wts[1:], b, epi, ln=ln), ref,
           f"{what} ln, last column tile skipped")
    cut = stats_fault_ln(x[:1], ln, wts[0].shape[1], device)
    if cut is not None:
        shown, faulty, (lo, hi) = cut
        refuse(key, fn(shown, *wts, b, epi, ln=faulty),
               plain(shown, *wts, b, ln, epi),
               f"{what} ln, split {lo}:{hi} left out of the statistics")


def skip_head(q, A, H):
    """A copy of q [B, >= A] with the last head's query columns zeroed: an
    attention kernel that drops that head's scores (its softmax goes
    uniform), the planted fault of the attention kernels."""
    q = q.clone()
    q[:, A - A // H:A] = 0
    return q


def refuse(name, out, ref, what):
    """A planted fault must fail the kernel check."""
    e, rel = _err(out, ref)
    log(f"  {name} {what} planted fault: rel {rel:.2e} (must exceed "
        f"{KERNEL_TOL:g})")
    if not rel > KERNEL_TOL:
        raise AssertionError(f"{name} {what}: the check let a planted "
                             f"fault pass ({rel:.2e})")


def deq(q, s):
    """int8 rows [..., A] with scales [...] (None: already bf16) as bf16."""
    if s is None:
        return q
    return (q.float() * s.float()[..., None]).to(torch.bfloat16)


def heads(z, H):
    """[B, L, A] (or [B, A]) -> SDPA's [B, H, L, A / H]."""
    B, A = z.shape[0], z.shape[-1]
    return z.reshape(B, -1, H, A // H).transpose(1, 2).contiguous()


def check_int8_kernels(shapes, B, last_t, device, gen, time_it=True):
    """Hold gemv_int8, ring_attn_int8 and cross_attn_decode (bf16 and int8
    encoder K/V) against their plain versions at each prior shape in
    `shapes` (the first label's shapes are the representative ones), every
    ring pattern at positions crossing block boundaries, with the slot
    rows and scales each writes equal; the int8 GEMV through check_gemv_ln
    and check_gemv at every product of gemv_products and batch; a planted
    fault for each kernel (a skipped column tile, a K split left out of the
    combine or of the row statistics, a dropped head) that the same check
    must refuse; quantize_dense on the
    card bit-exact against the host. Times beside the bound, the plain
    version and one library call (addmm on the dequantised weight; SDPA
    on the dequantised rows or the encoder rows). Returns {name: row}."""
    rep = KernelReport()
    bf = torch.bfloat16
    timings = {}

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def int8_rows(*shape):
        """Random int8 rows [..., A] with positive bf16 scales [...]."""
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int32).to(torch.int8)
        s = (torch.rand(shape[:-1], generator=gen, device=device) * 0.02
             + 0.002).to(bf)
        return q, s

    def copies(make, nbytes):
        return [make() for _ in range(_copies(nbytes))] if time_it else []

    def time3(name, what, kernel, plain, library, sets, lib_sets, nbytes,
              flops, representative, timed=None):
        """Time when `timed` (default: representative); keep the row of
        the representative shape."""
        if not (time_it and (representative if timed is None else timed)):
            return
        row = rep.timed(name, what, device_ms(kernel, sets),
                        device_ms(plain, sets), device_ms(library, lib_sets),
                        nbytes, flops, "bf16")
        if representative:
            timings[name] = row

    for label, sh in shapes.items():
        S, A, H, Sm = sh["S"], sh["A"], sh["H"], sh["Sm"]
        main = label == next(iter(shapes))
        # -- every product at B and at other batch sizes: the LayerNorm
        # products with the prologue (ln_gemv_int8), the residual products
        # (gemv_int8)
        for what, K, N, epi in gemv_products(sh):
            w = rnd(K, N, dtype=torch.float32, scale=0.02)
            b = rnd(N, scale=0.02)
            qd = quantize_dense({"w": w, "b": b})
            wq, sc = qd["w_q"], qd["s"]
            g_ln, b_ln = ln_params(K, gen, device)
            for Bx in [B] + [n for n in GEMV_BATCHES if n != B]:
                shape = (f"{label} {what} [{Bx},{K}]x[{K},{N}]"
                         f"{f' {epi}' if epi else ''}")
                if epi in ds.LN_EPILOGUES:
                    check_gemv_ln(rep, "gemv_int8", shape, ln_rows_in(
                        Bx, K, gen, device), (wq, sc), b, epi, (g_ln, b_ln),
                        device)
                else:
                    check_gemv(rep, "gemv_int8", shape, rnd(Bx, K), (wq, sc),
                               b, epi, rnd(Bx, N), device)
            if not (time_it and main) or "," in what:
                continue
            ln_ = (g_ln, b_ln)
            res = None if epi in ds.LN_EPILOGUES else rnd(B, N)
            x_of = ((lambda: ln_rows_in(B, K, gen, device)) if res is None
                    else (lambda: rnd(B, K)))
            sets = copies(lambda: (x_of(), quantize_dense(
                {"w": rnd(K, N, dtype=torch.float32, scale=0.02),
                 "b": b})["w_q"], sc, b, epi, res), K * N)
            # the library call on the same inputs: each set's weight
            # dequantised to bf16, so it too streams a weight per call
            lib_sets = [(a[0], (a[1].float() * sc).to(bf), b) for a in sets]
            if res is not None:
                time3("gemv_int8", f"{label} {what} [{B},{K}]x[{K},{N}]",
                      ds.gemv_int8, ds.gemv_int8_plain,
                      lambda x_, w_, b_: torch.addmm(b_, x_, w_), sets,
                      lib_sets, K * N + N * 4 + B * K * 2 + N * 2
                      + B * N * 2 * 2, 2 * B * K * N, what == "mlp.c_proj",
                      timed=True)
                del sets, lib_sets
                continue
            sets = [a[:5] for a in sets]
            time3("ln_gemv_int8", f"{label} {what} [{B},{K}]x[{K},{N}]",
                  functools.partial(ds.gemv_int8, ln=ln_),
                  lambda x_, w_, s_, b_, e_: ds.ln_gemv_int8_plain(
                      x_, w_, s_, b_, ln_, e_),
                  lambda x_, w_, b_: torch.addmm(b_, F.layer_norm(
                      x_, (K,), g_ln.to(bf), b_ln.to(bf), ds.LN_EPS), w_),
                  sets, lib_sets, ln_gemv_bytes(B, K, N, 1) + N * 4,
                  2 * B * K * N + 8 * B * K, what == "c_attn", timed=True)
            del sets, lib_sets
        # -- ring_attn_int8, every ring pattern of this prior
        for f in (f for f in sh["funcs"] if f != 6):
            shape = {0: (B, sh["n_ctx"], A), 1: (B, sh["bc"], A),
                     2: (B, sh["bc"], sh["blocks"], A),
                     3: (B, 2 * sh["bc"], A),
                     7: (B, sh["prime"] or 1, A)}[f]
            (kc, ks), (vc, vs) = int8_rows(*shape), int8_rows(*shape)
            for t in attn_positions(sh, last_t[label], f):
                geom = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])
                qkv = rnd(B, 3 * A)
                # the c_attn product's fp32 values, of which qkv is the
                # bf16 rounding: the new row is quantised from them
                qkv32 = qkv.float() + rnd(B, 3 * A, dtype=torch.float32,
                                          scale=2e-3) * qkv.float().abs()
                ca = [c.clone() for c in (kc, vc, ks, vs)]
                cb = [c.clone() for c in (kc, vc, ks, vs)]
                out = ds.ring_attn_int8(qkv, *ca, geom, H, qkv32)
                ref = ds.ring_attn_int8_plain(qkv, *cb, geom, H, qkv32)
                what = f"{label} f{f} t={t} rows {geom[2]}+{geom[3]}"
                rep.check("ring_attn_int8", out, ref, what)
                if not all(torch.equal(a, b) for a, b in zip(ca, cb)):
                    raise AssertionError(f"ring_attn_int8 {what}: the "
                                         f"written row or scale differs")
                if t == last_t[label]:
                    cc = [c.clone() for c in (kc, vc, ks, vs)]
                    refuse("ring_attn_int8", ds.ring_attn_int8(
                        qkv, *cc, geom, H, skip_head(qkv32, A, H)), ref,
                        what)
                cut = dropped_split(geom, B, H, A // H, device)
                if cut is not None:
                    shown, dropped = split_fault_caches(
                        qkv32, (kc, vc, ks, vs), *cut, A, H)
                    refuse("ring_attn_int8",
                           ds.ring_attn_int8(qkv, *dropped, geom, H, qkv32),
                           ds.ring_attn_int8_plain(qkv, *shown, geom, H,
                                                   qkv32),
                           f"{what} split {cut[0]}:{cut[1]} dropped")
            if main and f == 3:
                t = last_t[label]
                n = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])[3]
                geom = (n, n - 1, 0, n)

                def ring_set():
                    (k_, ks_), (v_, vs_) = (int8_rows(B, n, A),
                                            int8_rows(B, n, A))
                    qkv_ = rnd(B, 3 * A)
                    return (qkv_, k_, v_, ks_, vs_, geom, H, qkv_.float())
                live = B * n * (A + 2) * 2
                sets = copies(ring_set, live)
                time3("ring_attn_int8", f"{label} f{f} t={t} ({n} rows)",
                      ds.ring_attn_int8, ds.ring_attn_int8_plain,
                      F.scaled_dot_product_attention, sets,
                      [(heads(a[0][:, :A], H), heads(deq(a[1], a[3]), H),
                        heads(deq(a[2], a[4]), H)) for a in sets],
                      live + B * 2 * A * 2 + 3 * B * A * 4
                      + 2 * B * (A + 2) + B * A * 2, 4 * B * n * A, True)
        # -- cross_attn_decode (f6), bf16 and int8 encoder K/V
        # the encoder rows, and where they split, a cut of them whose last
        # split is ragged
        enc_rows = [sh["enc"]] if sh["enc"] else []
        if sh["enc"] and sh["enc"] > ds.ONE_SPLIT_ROWS:
            enc_rows.append(sh["enc"] - 12)
        for E in enc_rows:
            for int8 in (False, True):
                def cross_set(int8=int8, E=E):
                    if int8:
                        (k_, ks_), (v_, vs_) = (int8_rows(B, E, A),
                                                int8_rows(B, E, A))
                        return (rnd(B, A, dtype=torch.float32), k_, v_, H,
                                ks_, vs_)
                    return (rnd(B, A, dtype=torch.float32), rnd(B, E, A),
                            rnd(B, E, A), H, None, None)
                q, k, v, _, ks, vs = cross_set()
                what = f"{label} f6 {'int8' if int8 else 'bf16'} [{B},{E},{A}]"
                ref = ds.cross_attn_decode_plain(q, k, v, H, ks, vs)
                rep.check("cross_attn_decode",
                          ds.cross_attn_decode(q, k, v, H, ks, vs), ref, what)
                refuse("cross_attn_decode", ds.cross_attn_decode(
                    skip_head(q, A, H), k, v, H, ks, vs), ref, what)
                cut = dropped_split((E, -1, 0, E), B, H, A // H, device)
                if cut is not None:
                    shown, dropped = split_fault_caches(
                        q, (k, v, ks, vs)[:4 if int8 else 2], *cut, A, H)
                    pad = [None] * (2 if not int8 else 0)
                    refuse("cross_attn_decode",
                           ds.cross_attn_decode(q, dropped[0], dropped[1], H,
                                                *dropped[2:], *pad),
                           ds.cross_attn_decode_plain(q, shown[0], shown[1],
                                                      H, *shown[2:], *pad),
                           f"{what} split {cut[0]}:{cut[1]} dropped")
                if E != sh["enc"]:
                    continue
                nbytes = (B * E * A * (1 if int8 else 2) * 2
                          + (4 * B * E if int8 else 0) + B * A * (4 + 2))
                sets = copies(cross_set, nbytes)
                time3("cross_attn_decode", what, ds.cross_attn_decode,
                      ds.cross_attn_decode_plain,
                      F.scaled_dot_product_attention, sets,
                      [(heads(a[0].to(bf), H), heads(deq(a[1], a[4]), H),
                        heads(deq(a[2], a[5]), H)) for a in sets],
                      nbytes, 4 * B * E * A, main and int8)
    # quantize_dense on the card against the host (numpy-free fp32 on the
    # CPU), bit for bit, at the first label's c_attn shape
    sh = next(iter(shapes.values()))
    w = rnd(sh["S"], 3 * sh["A"], dtype=torch.float32, scale=0.02)
    zb = torch.zeros(3 * sh["A"], device=device)
    dev, host = (quantize_dense({"w": w, "b": zb}),
                 quantize_dense({"w": w.cpu(), "b": zb.cpu()}))
    if not (torch.equal(dev["w_q"].cpu(), host["w_q"])
            and torch.equal(dev["s"].cpu(), host["s"])):
        raise AssertionError("quantize_dense on the card differs from the "
                             "host's")
    log(f"  quantize_dense [{sh['S']},{3 * sh['A']}]: card == host, bit for "
        f"bit")
    for name, row in rep.rows.items():
        row.update(timings.get(name, {}))
    return {k: v for k, v in rep.rows.items()
            if k in ("ln_gemv_int8", "gemv_int8", "ring_attn_int8",
                     "cross_attn_decode")}


# ---------------------------------------------------------------------------
# phase 2b: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_work(BH, L, hd):
    """(bytes, flops) per kernel of the causal flash pass: every input read
    once and every output written once; two flops per multiply-add over the
    L (L + 1) / 2 causal pairs of each head row, for the products each
    kernel computes (fwd: QK, PV; dq: QK, GV, dS K; dkv: QK, PG, GV, dS Q)."""
    t, rows = BH * L * hd * 2, BH * L * 4
    pair_flops = 2 * hd * BH * L * (L + 1) // 2
    return {"flash_fwd": (4 * t + rows, 2 * pair_flops),
            "flash_dq": (5 * t + 2 * rows, 3 * pair_flops),
            "flash_dkv": (6 * t + 2 * rows, 4 * pair_flops)}


def skip_tile(t):
    """A copy of t [BH, L, ...] with its 64 positions at 3/4 of L zeroed.
    Fed to a flash kernel in place of v (fwd, dq) or of g and dd (dkv), it
    makes the kernel skip one tile's work in the late rows, a planted fault
    that the checks must refuse."""
    t0 = (3 * t.shape[1] // 4) // 64 * 64
    t = t.clone()
    t[:, t0:t0 + 64] = 0
    return t


@contextlib.contextmanager
def unmerged_pair(name, q):
    """While open, the flash kernel `name` runs at q's shape on work items
    whose first pair has both halves marked whole: each half writes its own
    partial sum and the other half is left out of the merge, the planted
    merge fault. Yields False (and plants nothing) when nothing splits, or
    on the CPU, whose plain versions take no work items."""
    BH, L = q.shape[:2]
    items, pairs = fa.SCHEDULES[name](BH, L, ds.sm_count(q.device))
    planted = pairs > 0 and q.is_cuda
    key = (name, q.device, BH, L)
    saved = fa._PLANS.get(key)
    if planted:
        fa._PLANS[key] = (torch.tensor(
            [(*it[:4], -1) if it[4] == 0 else it for it in items],
            dtype=torch.int32, device=q.device), pairs)
    try:
        yield planted
    finally:
        if saved is None:
            fa._PLANS.pop(key, None)
        else:
            fa._PLANS[key] = saved


def check_flash(B, L, S, H, device, gen, time_it=True, ragged=2500,
                seed=1234):
    """Hold flash_fwd (out, lse), flash_dq and flash_dkv against their plain
    versions (fa.agreement) on random heads at [B*H, L, S/H] and a ragged
    L, at dropout rates 0 and 0.1, and check that each kernel fed the
    planted fault of skip_tile fails the same comparison, that dq and
    dk/dv give the same bits on a second call, and that they fail it too
    with one split pair left unmerged (unmerged_pair); time the main shape
    at rate 0 beside the bound, the plain version and SDPA (causal
    forward; its autograd backward, which computes dq, dk and dv together,
    for both backward kernels). Returns {name: row}."""
    BH, hd = B * H, S // H
    scale = hd ** -0.5
    rep = KernelReport()

    def heads(L_):
        return [(torch.randn((BH, L_, hd), generator=gen, device=device)
                 ).to(torch.bfloat16) for _ in range(4)]

    def check(name, out, ref, bad, what):
        worst = fa.agreement(out, ref)
        e = (out.float() - ref.float()).abs().max().item()
        fault = fa.agreement(bad, ref) if bad is not None else float("inf")
        log(f"  {name} {what}: max_abs_err {e:.3e}, worst {worst:.3f} of "
            f"its bound" + (f"; planted fault {fault:.3f}"
                            if bad is not None else ""))
        if not worst <= 1.0:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version ({worst:.3f} of the bound)")
        if not fault > 1.0:
            raise AssertionError(f"{name} {what}: the check passes a kernel "
                                 f"that skips a tile ({fault:.3f})")
        if name in fa.LAUNCHES:
            row = rep.rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], e)

    for L_ in (L, ragged):
        for rate in (0.0, 0.1):
            q, k, v, g = heads(L_)
            what = f"[{BH},{L_},{hd}] rate {rate}"
            out, lse = fa.flash_fwd(q, k, v, scale, rate, seed)
            ref, ref_lse = fa.flash_fwd_plain(q, k, v, scale, rate, seed)
            bad = fa.flash_fwd(q, k, skip_tile(v), scale, rate, seed)
            check("flash_fwd", out, ref, bad[0], what)
            check("flash_fwd.lse", lse, ref_lse, None, what)
            dd = (g.float() * ref.float()).sum(-1)
            args = (q, k, v, g, ref_lse, dd, scale, rate, seed)
            dq, ref_dq = fa.flash_dq(*args), fa.flash_dq_plain(*args)
            check("flash_dq", dq, ref_dq,
                  fa.flash_dq(q, k, skip_tile(v), *args[3:]), what)
            dkv, ref_dkv = fa.flash_dkv(*args), fa.flash_dkv_plain(*args)
            bad = fa.flash_dkv(q, k, v, skip_tile(g), ref_lse, skip_tile(dd),
                               *args[6:])
            for n, a, b, f in zip(("dk", "dv"), dkv, ref_dkv, bad):
                check("flash_dkv", a, b, f, f"{n} {what}")
            outs = {"flash_dq": (dq,), "flash_dkv": dkv}
            refs = {"flash_dq": (ref_dq,), "flash_dkv": ref_dkv}
            for name, fn in (("flash_dq", fa.flash_dq),
                             ("flash_dkv", fa.flash_dkv)):
                again = fn(*args)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, b)
                           for a, b in zip(again, outs[name])):
                    raise AssertionError(f"{name} {what}: a second call on "
                                         f"the same inputs gave other bits")
                with unmerged_pair(name, q) as planted:
                    if planted:
                        bad = fn(*args)
                        bad = bad if isinstance(bad, tuple) else (bad,)
                        for a, b, f in zip(outs[name], refs[name], bad):
                            check(name, a, b, f,
                                  f"{what} (one split pair unmerged)")
            log(f"  flash_dq, flash_dkv {what}: a second call gives the "
                f"same bits")
    if not time_it:
        return rep.rows
    q, k, v, g = heads(L)
    out, lse = fa.flash_fwd(q, k, v, scale)
    dd = (g.float() * out.float()).sum(-1)
    sets = [tuple(heads(L)) for _ in range(_copies(4 * q.numel() * 2))]
    fwd_sets = [(a, b, c, scale) for a, b, c, _ in sets]
    bwd_sets = [(a, b, c, d, lse, dd, scale) for a, b, c, d in sets]
    lib_q = [t.reshape(B, H, L, hd).requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_q, is_causal=True)
    lib_g = g.reshape(B, H, L, hd)

    def sdpa(a, b, c, *_):
        return F.scaled_dot_product_attention(
            a.reshape(B, H, L, hd), b.reshape(B, H, L, hd),
            c.reshape(B, H, L, hd), is_causal=True)

    def sdpa_bwd(*_):
        return torch.autograd.grad(lib_out, lib_q, lib_g, retain_graph=True)
    lib_ms = {"flash_fwd": device_ms(sdpa, fwd_sets),
              "flash_dq": device_ms(sdpa_bwd, [()], reps=50)}
    lib_ms["flash_dkv"] = lib_ms["flash_dq"]
    work = flash_work(BH, L, hd)
    for name, kernel, plain, arg_sets in (
            ("flash_fwd", fa.flash_fwd, fa.flash_fwd_plain, fwd_sets),
            ("flash_dq", fa.flash_dq, fa.flash_dq_plain, bwd_sets),
            ("flash_dkv", fa.flash_dkv, fa.flash_dkv_plain, bwd_sets)):
        rep.rows[name].update(rep.timed(
            name, f"[{BH},{L},{hd}]", device_ms(kernel, arg_sets, reps=20),
            device_ms(plain, arg_sets, reps=3), lib_ms[name], *work[name],
            "bf16"))
    return rep.rows


# ---------------------------------------------------------------------------
# phase 2c: the LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------

def skip_last_row(t):
    """A copy of t [N, ...] with its last row zeroed: what a kernel that
    skips the last row leaves in a zeroed output, the planted fault of
    phase 2c."""
    t = t.clone()
    t[-1] = 0
    return t


def layer_norm_work(N, D, itemsize):
    """(bytes, flops) of the forward and backward: every input read once
    and every output written once; ~8 flops per element forward, ~12
    backward (fp32, outside the tensor cores)."""
    fwd = (2 * N * D * itemsize + 2 * D * 4 + 2 * N * 4, 8 * N * D)
    bwd = (3 * N * D * itemsize + D * 4 + 2 * N * 4 + 2 * D * 4, 12 * N * D)
    return {"layer_norm_fwd": fwd, "layer_norm_bwd": bwd}


def check_layer_norm(shapes, device, gen, time_it=True):
    """Hold layer_norm_fwd (y, mu, rstd) and layer_norm_bwd (dx, dg, db)
    against their plain versions (ln.agreement) at each (N, D, dtype) of
    `shapes`, and check that a planted fault (the last row skipped) fails
    the same comparison; time the first shape beside the bound, the plain
    version and F.layer_norm (forward; its autograd backward for the
    backward kernel). Returns {name: row}."""
    rep = KernelReport()

    def check(name, what, out, ref, bad=None):
        worst = ln.agreement(out, ref)
        e = (out.float() - ref.float()).abs().max().item()
        fault = ln.agreement(bad, ref) if bad is not None else float("inf")
        log(f"  {name} {what}: max_abs_err {e:.3e}, worst {worst:.3f} of "
            f"its bound" + (f"; planted fault {fault:.1f}"
                            if bad is not None else ""))
        if not worst <= 1.0:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version ({worst:.3f} of the bound)")
        if not fault > 1.0:
            raise AssertionError(f"{name} {what}: the check passes a kernel "
                                 f"that skips the last row ({fault:.3f})")
        row = rep.rows.setdefault(name.split(".")[0], {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], e)

    def inputs(N, D, dtype):
        x = (torch.randn((N, D), generator=gen, device=device) * 2.0
             + 0.5).to(dtype)
        g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=device)
        b = 0.1 * torch.randn((D,), generator=gen, device=device)
        dy = torch.randn((N, D), generator=gen, device=device).to(dtype)
        return x, g, b, dy

    for N, D, dtype in shapes:
        assert N >= 2, "the planted fault leaves out one of N >= 2 rows"
        what = f"[{N},{D}] {str(dtype).split('.')[-1]}"
        x, g, b, dy = inputs(N, D, dtype)
        y, mu, rstd = ln.layer_norm_fwd(x, g, b)
        ref = ln.layer_norm_fwd_plain(x, g, b)
        bad = ln.layer_norm_fwd(x[:-1], g, b)
        for i, n in enumerate(("", ".mu", ".rstd")):
            check("layer_norm_fwd" + n, what, (y, mu, rstd)[i], ref[i],
                  torch.cat([bad[i], torch.zeros_like(ref[i][-1:])]))
        out = ln.layer_norm_bwd(x, g, mu, rstd, dy)
        ref = ln.layer_norm_bwd_plain(x, g, mu, rstd, dy)
        again = ln.layer_norm_bwd(x, g, mu, rstd, dy)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"layer_norm_bwd {what}: a second call gave "
                                 f"other bits")
        bad = ln.layer_norm_bwd(x[:-1], g, mu[:-1], rstd[:-1], dy[:-1])
        check("layer_norm_bwd", "dx " + what, out[0], ref[0],
              torch.cat([bad[0], torch.zeros_like(ref[0][-1:])]))
        for i, n in ((1, "dg"), (2, "db")):
            check("layer_norm_bwd." + n, what, out[i], ref[i], bad[i])
    if not time_it:
        return rep.rows
    N, D, dtype = shapes[0]
    itemsize = torch.tensor([], dtype=dtype).element_size()
    sets = [inputs(N, D, dtype) for _ in range(_copies(3 * N * D * itemsize))]
    stats = [ln.layer_norm_fwd_plain(x, g, b)[1:] for x, g, b, _ in sets]
    fwd_sets = [a[:3] for a in sets]
    bwd_sets = [(x, g, mu, rstd, dy) for (x, g, _, dy), (mu, rstd)
                in zip(sets, stats)]
    lib_in = [(x.detach().requires_grad_(), g.requires_grad_(),
               b.requires_grad_(), dy) for x, g, b, dy in sets[:2]]
    lib_out = [F.layer_norm(x, (D,), g.to(dtype), b.to(dtype), ln.EPS)
               for x, g, b, _ in lib_in]

    def lib_bwd(i):
        return torch.autograd.grad(lib_out[i], lib_in[i][:3], lib_in[i][3],
                                   retain_graph=True)
    lib_ms = {"layer_norm_fwd": device_ms(
        lambda x, g, b: F.layer_norm(x, (D,), g, b, ln.EPS),
        [(x, g.to(dtype), b.to(dtype)) for x, g, b in fwd_sets]),
        "layer_norm_bwd": device_ms(lib_bwd, [(0,), (1,)], reps=50)}
    work = layer_norm_work(N, D, itemsize)
    for name, kernel, plain, arg_sets in (
            ("layer_norm_fwd", ln.layer_norm_fwd, ln.layer_norm_fwd_plain,
             fwd_sets),
            ("layer_norm_bwd", ln.layer_norm_bwd, ln.layer_norm_bwd_plain,
             bwd_sets)):
        rep.rows[name].update(rep.timed(
            name, f"[{N},{D}] {str(dtype).split('.')[-1]}",
            device_ms(kernel, arg_sets), device_ms(plain, arg_sets, reps=20),
            lib_ms[name], *work[name], "fp32"))
    return rep.rows


# ---------------------------------------------------------------------------
# phase 2d: the Adam kernel against its plain version
# ---------------------------------------------------------------------------

ADAM_STEPS = 3
# kernel against plain after ADAM_STEPS updates from one state, per tensor:
# params normwise within ADAM_TOL of how far the steps moved them (both
# round every operation alike, so they should agree to the last bit); fp32
# moments normwise within ADAM_TOL of their norm; fp16 moments elementwise
# within one fp16 step, their scales within ADAM_TOL relative.
ADAM_TOL = 1e-6
ADAM_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01)


def adam_work(numels, fp16):
    """(bytes, flops) of one update: each input read once and each output
    written once (p, g, m, v read; p, m, v written), ~15 fp32 flops per
    parameter."""
    n = sum(numels)
    per = 4 + 4 + 4 + (2 + 2 + 2 + 2 if fp16 else 4 + 4 + 4 + 4)
    return n * per, 15 * n


def _adam_grads(shapes, step, device, seed, none_at):
    gen = torch.Generator(device=device).manual_seed(seed + step)
    return {n: (None if n == none_at else
                torch.randn(s, generator=gen, device=device) * 1e3)
            for n, s in shapes.items()}


def _adam_gaps(params, opt, ref_params, ref_opt, start):
    """Per tensor: params' ||x - ref|| / ||ref - start||, moments'
    (fp32: normwise / ||ref||; fp16: worst |x - ref| in fp16 steps of
    ref; scales relative). Returns {kind: (worst, tensor name)}."""
    worst = {}

    def note(kind, val, name):
        if val > worst.get(kind, (-1.0, ""))[0]:
            worst[kind] = (val, name)
    fp16 = "m_scale" in ref_opt
    for n, r in ref_params.items():
        moved = torch.linalg.vector_norm(r - start[n]).item()
        gap = torch.linalg.vector_norm(params[n] - r).item()
        note("params", gap / max(moved, 1e-30), n)
        for k in ("m", "v"):
            a, b = opt[k][n], ref_opt[k][n]
            if fp16:
                # one fp16 step at b: 2^(e - 11) for |b| = f 2^e, f in
                # [0.5, 1), and the subnormal step 2^-24 at zero
                e = torch.frexp(b.float().abs())[1]
                e = torch.where(b == 0, torch.full_like(e, -13), e)
                step = torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                                   (e - 11).clamp(min=-24))
                note(k, ((a.float() - b.float()).abs() / step).max().item(),
                     n)
                s, sr = opt[k + "_scale"][n], ref_opt[k + "_scale"][n]
                note(k + "_scale", (abs(float(s) - float(sr))
                                    / float(sr)), n)
            else:
                note(k, torch.linalg.vector_norm(a - b).item()
                     / max(torch.linalg.vector_norm(b).item(), 1e-30), n)
    return worst


def _adam_ok(worst, fp16):
    lim = {"params": ADAM_TOL, "m": 1.0 if fp16 else ADAM_TOL,
           "v": 1.0 if fp16 else ADAM_TOL, "m_scale": ADAM_TOL,
           "v_scale": ADAM_TOL}
    return all(v <= lim[k] for k, (v, _) in worst.items())


@torch.no_grad()
def check_adam(start, fp16, device, seed=7, time_it=True, grads=None,
               fault_at=None):
    """Phase 2d: ADAM_STEPS updates of the tensors `start` ({name: fp32
    parameter}, left unchanged) through the Adam kernel against the plain
    version from one state, with gradients of ~1e3 drawn per step (one
    tensor's gradient None), or `grads` ({name: tensor}) at every step, and
    a loss scale x clip divisor on the card, twice, the two runs equal bit
    for bit; then the same with planted faults, an update item (and in the
    fp16 form an amax item) of the largest tensor, or of tensor `fault_at`,
    left out of the walk, which the check must refuse. Times one update
    beside the bound and the plain version (no single PyTorch call computes
    this update: torch's fused AdamW places eps and the weight decay
    elsewhere). Returns the kernel's row."""
    shapes = {n: p.shape for n, p in start.items()}
    none_at = (None if grads is not None
               else min(shapes, key=lambda n: start[n].numel()))

    def grads_of(step):
        return grads if grads is not None else _adam_grads(
            shapes, step, device, seed, none_at)
    scale = torch.tensor(2.0 ** 16 * 1.7, device=device)
    cuda = torch.device(device).type == "cuda"
    what = "fp16 moments" if fp16 else "fp32 moments"

    def clone():
        params = {n: p.detach().clone() for n, p in start.items()}
        return params, train_mod.adam_init(params, fp16_state=fp16)

    def run(update, params, opt):
        for step in range(ADAM_STEPS):
            update(params, grads_of(step), opt, scale=scale, **ADAM_HYPER)
        return params, opt

    ref_params, ref_opt = run(ad.adam_update_plain, *clone())
    params, opt = clone()
    if cuda:
        table = ad.AdamTable(params, opt)

        def kernel(p, g, o, **kw):
            ad.adam_update_kernel(table, g, o, **kw)
    else:
        kernel = ad.adam_update
    run(kernel, params, opt)
    if cuda:  # a second walk from the same state gives the same bits
        again, again_opt = clone()
        table = ad.AdamTable(again, again_opt)
        run(kernel, again, again_opt)
        same = all(torch.equal(params[n], again[n])
                   and all(torch.equal(opt[k][n], again_opt[k][n])
                           for k in ("m", "v", "m_scale", "v_scale")
                           if k in opt) for n in start)
        if not same:
            raise AssertionError(f"adam_update ({what}): a second run gave "
                                 f"other bits")
        del again, again_opt, table
    worst = _adam_gaps(params, opt, ref_params, ref_opt, start)
    log(f"phase 2d adam {what}, {len(start)} tensors, "
        f"{sum(p.numel() for p in start.values()) / 1e6:.1f} M params, "
        f"{ADAM_STEPS} steps: " + ", ".join(
            f"{k} {v:.3e} ({n})" for k, (v, n) in worst.items()))
    if not _adam_ok(worst, fp16):
        raise AssertionError(f"adam_update ({what}) disagrees with its plain "
                             f"version: {worst}")
    err = max(torch.linalg.vector_norm(params[n] - ref_params[n]).item()
              for n in start)
    row = {"max_abs_err": max((params[n] - ref_params[n]).abs().max().item()
                              for n in start)}
    del params, opt
    if cuda:
        # the planted faults, each an item of the largest tensor left out of
        # the walk: the update item of its last chunk; in the fp16 form
        # also the amax item of the chunk that holds the first step's
        # largest |m| and |v| (the largest |gradient|), whose loss shrinks
        # the tensor's new scales
        sizes = [p.numel() for p in start.values()]
        big = (max(range(len(sizes)), key=sizes.__getitem__)
               if fault_at is None else list(start).index(fault_at))
        items = ad.item_order(sizes, fp16)
        g0 = grads_of(0)[list(start)[big]]
        peak = int(g0.abs().argmax()) // ad.CHUNK * ad.CHUNK
        faults = [("update", max(i for i, it in enumerate(items)
                                 if it[0] == big and it[2] == ad.UPDATE))]
        if fp16:
            faults.append(("amax", items.index((big, peak, ad.AMAX))))
        for kind, drop in faults:
            params, opt = clone()
            faulty = ad.AdamTable(params, opt, items[:drop] + items[drop + 1:])
            run(lambda p, g, o, **kw: ad.adam_update_kernel(faulty, g, o,
                                                            **kw),
                params, opt)
            bad = _adam_gaps(params, opt, ref_params, ref_opt, start)
            log(f"  planted fault ({kind} item {items[drop]} left out): "
                + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in bad.items()))
            if _adam_ok(bad, fp16):
                raise AssertionError(f"the Adam check passes a kernel that "
                                     f"skips an {kind} item")
            del params, opt, faulty
    del ref_params, ref_opt
    log(f"  largest normwise param gap {err:.3e}")
    if not (time_it and cuda):
        return row
    params, opt = clone()
    table = ad.AdamTable(params, opt)
    args = (grads_of(0), opt)
    ms = device_ms(lambda g, o: ad.adam_update_kernel(table, g, o, scale=scale,
                                                      **ADAM_HYPER),
                   [args], reps=10)
    plain_ms = device_ms(lambda g, o: ad.adam_update_plain(
        params, g, o, scale=scale, **ADAM_HYPER), [args], reps=2)
    del params, opt, table, args
    torch.cuda.empty_cache()
    nbytes, flops = adam_work([p.numel() for p in start.values()], fp16)
    row.update(KernelReport().timed("adam_update", what, ms, plain_ms, None,
                                    nbytes, flops, "fp32"))
    return row


# ---------------------------------------------------------------------------
# phase 3: one full-width decode step, kernel path against plain path
# ---------------------------------------------------------------------------

def check_stack_step(prior, B, device, gen, quantize=None):
    """One full-width decode step of `prior`, the kernel path against the
    plain path on twin caches after a one-block prefill (the f6 layers'
    caches projected from a random encoder_kv; with quantize="int8" int8
    weights and caches, the prefill writing int8 rows), then the step
    timed. Returns the step's wall ms."""
    tr = prior.model.prior.transformer
    bc = tr.blocks[0].attn.block_ctx
    dec = tr.prepare_decode_params(torch.bfloat16, quantize=quantize)
    enc = None
    if prior.model.prime_prior is not None:
        enc = torch.randn((B, prior.n_tokens, tr.n_in), generator=gen,
                          device=device).to(torch.bfloat16)
    caches = tr.init_cache(B, torch.bfloat16, device, encoder_kv=enc,
                           dec_params=dec, int8=bool(quantize))
    x0 = torch.randn((B, bc, tr.n_in), generator=gen, device=device)
    tr.prefill_chunk(caches, x0, 0, 1, fp16=True, dec_params=dec)
    twin = [{k: c.clone() for k, c in cache.items()} for cache in caches]
    x = torch.randn((B, 1, tr.n_in), generator=gen, device=device)
    h_k = tr.decode_step(dec, caches, x, bc, fp16=True)
    h_p = tr.decode_step(dec, twin, x, bc, fp16=True, plain=True)
    del twin
    lk, lp = prior.model.prior._logits(h_k), prior.model.prior._logits(h_p)
    e, rel = _err(lk, lp)
    mode = quantize or "bf16"
    log(f"phase 3 level {prior.level} {mode}: {tr.n_depth} layers at t={bc},"
        f" max logit err {e:.3e} (rel {rel:.2e}, tol {STEP_TOL:g})")
    if not (torch.isfinite(lk).all() and rel <= STEP_TOL):
        raise AssertionError(f"level {prior.level} {mode}: kernel-path "
                             f"decode step disagrees with the plain path "
                             f"({e:.3e})")
    if x.is_cuda:
        return time_decode_step(tr, dec, caches, x, bc + 1,
                                f"{prior.level} {mode}", bool(quantize))


def step_launches(tr, quantized, cache_int8):
    """Kernel launches of one decode step of the whole stack (int8 caches
    on the packed layers alone)."""
    out = dict.fromkeys(ds.LAUNCHES, 0)
    packed = tr.packed
    for d in range(tr.n_depth):
        for k, v in ds.layer_launches(tr.attn_func(d), quantized,
                                      cache_int8 and d in packed).items():
            out[k] += v
    return out


def time_decode_step(tr, dec, caches, x, t, level, int8=False, reps=20):
    """Wall time of a kernel-path decode step (host clock, synchronised)
    against the device time of its kernels (torch.profiler, summed).
    Returns the wall ms."""
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(reps):
        tr.decode_step(dec, caches, x, t + i, fp16=True)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) / reps * 1e3
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
        for i in range(reps):
            tr.decode_step(dec, caches, x, t + reps + i, fp16=True)
        torch.cuda.synchronize()
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in p.key_averages()) / reps / 1e3
    launches = sum(step_launches(tr, int8, int8).values())
    busy = (f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.0%})"
            if busy_ms > 0 else "device busy not measured (no profiler "
                                "device time)")
    log(f"phase 3 level {level}: decode step {wall_ms:.2f} ms wall, {busy}, "
        f"{launches} launches = {wall_ms / launches * 1e3:.1f} us wall each")
    return wall_ms


# ---------------------------------------------------------------------------
# phase 4: the cascade
# ---------------------------------------------------------------------------

def cascade_windows(priors, hps, have=None):
    """Per level, the windows the cascade samples as (context tokens, new
    tokens), as sample.sample_level walks them from codes of length
    have[level] (all 0 in the ancestral mode), and the levels' final code
    lengths."""
    have = list(have or [0] * len(priors))
    out = []
    for level, prior in enumerate(priors):
        total = hps.sample_length // prior.raw_to_tokens
        n_ctx = prior.n_ctx
        wins = []
        if total >= n_ctx:
            hop = int(hps.hop_fraction[level] * n_ctx)
            for start in get_starts(total, n_ctx, hop):
                c = min(n_ctx, max(0, have[level] - start))
                if c < n_ctx:
                    wins.append((c, n_ctx - c))
                    have[level] += n_ctx - c
        else:  # sample_partial_window
            cur = have[level]
            c = cur if cur < n_ctx - total else n_ctx - total
            wins.append((c, total))
            have[level] += total
        out.append(wins)
    return out, have


def window_work(prior, skw, c):
    """(whole prefill chunks, decode steps of the prefill's tail) of one
    window with c context tokens: the 1b top prefills its lyric prefix
    too."""
    P = c + (prior.n_tokens if prior.single_enc_dec else 0)
    bc = prior.model.prior.block_ctx
    chunk = max(1, skw["chunk_size"] // bc) * bc
    return P // chunk, P - (P // chunk) * chunk


def decode_steps(priors, hps, sampling_kwargs, have=None):
    """Token steps each prior decodes in the cascade, over its windows and
    batches: the sampled tokens and the tail of each window's prefill (its
    context tokens, the 1b top's lyric prefix ahead of them) that is not a
    whole chunk."""
    steps = []
    for level, wins in enumerate(cascade_windows(priors, hps, have)[0]):
        prior, skw = priors[level], sampling_kwargs[level]
        batches = -(-hps.n_samples // skw["max_batch_size"])
        steps.append(batches * sum(new + window_work(prior, skw, c)[1]
                                   for c, new in wins))
    return steps


def cascade_layer_norms(priors, hps, sampling_kwargs, have=None):
    """LayerNorm kernel launches of the cascade's sampling: per window and
    batch, the conditioner's LayerNorm (upsamplers), two per layer for each
    whole prefill chunk (the 1b top's lyric prefix and the windows' context
    tokens, chunk_size rounded to blocks; the decode steps, the prefill's
    tails included, normalise in their GEMVs' prologue instead), and the
    5b_lyrics top's lyric encoder forward."""
    n = 0
    for level, wins in enumerate(cascade_windows(priors, hps, have)[0]):
        prior, skw = priors[level], sampling_kwargs[level]
        batches = -(-hps.n_samples // skw["max_batch_size"])
        enc = prior.model.prime_prior
        per_window = (int(prior.model.x_cond)
                      + (0 if enc is None else 2 * enc.transformer.n_depth + 1))
        for c, _ in wins:
            chunks = window_work(prior, skw, c)[0]
            n += batches * (per_window + 2 * prior.model.prior.transformer
                            .n_depth * chunks)
    return {"layer_norm_fwd": n, "layer_norm_bwd": 0}


def aligns(prior):
    """Whether the cascade computes the top prior's lyric alignment
    (sample._compute_alignments)."""
    return (prior.n_tokens > 0 and prior.alignment_layer is not None
            and prior.alignment_head is not None)


def alignment_launches(prior, hps, total, fp16):
    """flash_fwd and layer_norm_fwd launches of get_alignment on `total`
    top codes: per hop one recording forward of the whole batch, whose f0
    layers take flash unless recorded (bf16, L >= 2048), with two
    LayerNorms a layer, the conditioner's and a lyric encoder's forward."""
    if not aligns(prior):
        return {"flash_fwd": 0, "layer_norm_fwd": 0}
    n_ctx = prior.n_ctx
    hops = len(get_starts(max(total, n_ctx), n_ctx,
                          int(hps.hop_fraction[-1] * n_ctx)))
    tr = prior.model.prior.transformer
    dtype = torch.bfloat16 if fp16 else torch.float32
    flash = sum(blk.attn.uses_flash(tr.n_ctx, dtype,
                                    d == prior.alignment_layer)
                for d, blk in enumerate(tr.blocks))
    enc = prior.model.prime_prior
    lns = (2 * tr.n_depth + int(prior.model.x_cond)
           + (0 if enc is None else 2 * enc.transformer.n_depth + 1))
    return {"flash_fwd": hops * flash, "layer_norm_fwd": hops * lns}


@contextlib.contextmanager
def plain_kernels():
    """The flash and LayerNorm wrappers run their plain versions inside the
    block: the plain path an alignment is held against."""
    names = [(fa, n) for n in fa.LAUNCHES] + [(ln, n) for n in ln.LAUNCHES]
    saved = {(m, n): getattr(m, n) for m, n in names}
    for m, n in names:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for (m, n), f in saved.items():
            setattr(m, n, f)


def alignment_gap(got, ref):
    """The worst over samples of ||got - ref|| over the alignment's own
    signal, ||ref - its row means|| on the columns each row attends (ref >
    0; the characters outside the lyric window stay 0): random weights
    attend nearly evenly, so the error is held against the departure from
    flat rows."""
    gaps = []
    for g, r in zip(got, ref):
        m = r > 0
        mean = (r * m).sum(axis=1, keepdims=True) / np.maximum(
            m.sum(axis=1, keepdims=True), 1)
        signal = np.linalg.norm((r - mean) * m)
        gaps.append(np.linalg.norm(g - r) / max(signal, 1e-30))
    return max(gaps)


def check_alignment(priors, hps, sampling_kwargs, zs, labels):
    """The cascade's lyric alignment recomputed by get_alignment: one per
    sample of shape [top codes, lyric characters], finite, in [0, 1], rows
    summing to at most 1 + 1e-3, equal to the html JSON the cascade wrote;
    its flash_fwd and layer_norm_fwd launches equal alignment_launches; it
    agrees with the plain path (flash and LayerNorm plain) within
    ALIGN_TOL (alignment_gap), and the planted fault (the next head) is
    refused. Returns a report dict."""
    top = priors[-1]
    fp16 = sampling_kwargs[-1].get("fp16", False)
    total = zs[-1].shape[1]
    cuda = next(top.model.parameters()).is_cuda

    def align():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        out = align_mod.get_alignment(None, zs, labels[-1], top, fp16, hps)
        if cuda:
            torch.cuda.synchronize()
        return out, time.time() - t0
    expected = alignment_launches(top, hps, total, fp16)
    fa.reset_launches()
    ln.reset_launches()
    got, seconds = align()
    launches = {"flash_fwd": fa.LAUNCHES["flash_fwd"],
                "layer_norm_fwd": ln.LAUNCHES["layer_norm_fwd"]}
    infos = labels[-1]["info"]
    for i, a in enumerate(got):
        shape = (total, len(infos[i]["full_tokens"]))
        if a.shape != shape or not np.isfinite(a).all() or a.min() < 0 \
                or a.max() > 1 or (a.sum(axis=1) > 1 + 1e-3).any():
            raise AssertionError(f"alignment {i}: {a.shape} (want {shape}),"
                                 f" range [{a.min()}, {a.max()}], largest "
                                 f"row sum {a.sum(axis=1).max()}")
        with open(os.path.join(hps.name, f"level_{len(priors) - 1}",
                               f"item_{i}_align.json")) as f:
            written = np.asarray(json.load(f))
        want = np.asarray(save_html._downsample_alignment(a))
        if written.shape != want.shape or np.abs(written - want).max() > 1e-3:
            raise AssertionError(f"item {i}: the html's alignment JSON is not"
                                 f" the recomputed alignment's")
    with plain_kernels():
        ref, plain_s = align()
    gap = alignment_gap(got, ref)
    head = top.alignment_head
    planted = (head + 1) % top.model.prior.transformer.n_head
    top.model.alignment_head = planted
    try:
        wrong, _ = align()
    finally:
        top.model.alignment_head = head
    fault = alignment_gap(wrong, ref)
    rep = dict(seconds=seconds, plain_s=plain_s, gap=gap, fault_gap=fault,
               launches=launches, expected=expected, shape=got[0].shape)
    log(f"  alignment: {len(got)} x {got[0].shape} in {seconds:.2f}s (plain"
        f" path {plain_s:.2f}s); gap to the plain path {gap:.3e} (tol "
        f"{ALIGN_TOL:g}), planted fault (head {planted}) {fault:.3e}; "
        f"launches {launches} == expected {expected}")
    if not gap <= ALIGN_TOL:
        raise AssertionError(f"the alignment disagrees with its plain path "
                             f"({gap:.3e})")
    if not fault > ALIGN_TOL:
        raise AssertionError(f"the planted alignment fault was not refused "
                             f"({fault:.3e})")
    if cuda and launches != expected:
        raise AssertionError(f"alignment launches {launches} != expected "
                             f"{expected}")
    return rep


def run_cascade(priors, hps, sampling_kwargs, int8=False, prompt=None,
                sequential=False):
    """ancestral_sample (or, given a prompt [n, T, 1], primed_sample) +
    checks; int8=True samples in the int8 mode (JUKEBOX_INT8_DECODE=1:
    int8 weights and ring caches in every prior); sequential=True with the
    sequential scheduler and the inline finalize (pipeline_cascade=False,
    JUKEBOX_ASYNC_FINALIZE=0), else with the default ones (pipelined,
    finalize and staging on worker threads). Returns a report dict: the
    codes (zs), the decode kernels' launches against their expected counts
    (launches, expected), the LayerNorm and flash kernels' (ln_launches,
    ln_expected, fa_launches, fa_expected: the sampling's prefill and
    conditioners, and the alignment's forward, counted across threads),
    the recorder's coarse span seconds (stages: utils/profiler.py totals()
    of the cascade) and the alignment's check (align). No
    thread may outlive the cascade."""
    metas = [dict(artist="unknown", genre="unknown", lyrics=LYRICS,
                  total_length=hps.sample_length, offset=0)] * hps.n_samples
    labels = [p.labeller.get_batch_labels(metas) for p in priors]
    device = next(priors[0].model.parameters()).device
    cuda = device.type == "cuda"
    prompt_zs = None
    if prompt is not None:
        prompt_zs = [z.cpu().numpy() for z in priors[-1].encode(
            prompt.to(device), start_level=0, end_level=len(priors),
            bs_chunks=prompt.shape[0])]
    have = None if prompt_zs is None else [z.shape[1] for z in prompt_zs]
    steps = decode_steps(priors, hps, sampling_kwargs, have)
    final = cascade_windows(priors, hps, have)[1]
    expected = dict.fromkeys(ds.LAUNCHES, 0)
    for prior, n in zip(priors, steps):
        for k, v in step_launches(prior.model.prior.transformer, int8,
                                  int8).items():
            expected[k] += n * v
    aligned = alignment_launches(priors[-1], hps, final[-1],
                                 sampling_kwargs[-1].get("fp16", False))
    ln_expected = cascade_layer_norms(priors, hps, sampling_kwargs, have)
    ln_expected["layer_norm_fwd"] += aligned["layer_norm_fwd"]
    fa_expected = dict.fromkeys(fa.LAUNCHES, 0)
    fa_expected["flash_fwd"] = aligned["flash_fwd"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for mod in (ds, ln, fa):
        mod.reset_launches()
    profiler.reset()
    env = {k: os.environ.pop(k, None)
           for k in ("JUKEBOX_INT8_DECODE", "JUKEBOX_INT8_CACHE",
                     "JUKEBOX_PIPELINE", "JUKEBOX_ASYNC_FINALIZE",
                     "JUKEBOX_ASYNC_STAGE", "JUKEBOX_ALIGN_DEFER")}
    if int8:
        os.environ["JUKEBOX_INT8_DECODE"] = "1"
    if sequential:
        os.environ["JUKEBOX_ASYNC_FINALIZE"] = "0"
        hps = Hyperparams(dict(hps, pipeline_cascade=False))
    threads = set(threading.enumerate())
    t0 = time.time()
    try:
        if prompt is None:
            zs = sample_mod.ancestral_sample(labels, sampling_kwargs, priors,
                                             hps)
        else:
            zs = sample_mod.primed_sample(prompt, labels, sampling_kwargs,
                                          priors, hps)
        if cuda:
            torch.cuda.synchronize()
    finally:
        for k, v in env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    wall = time.time() - t0
    _outlived(threads)
    report = dict(wall_s=wall, steps=steps, expected=expected, zs=zs,
                  scheduler="sequential" if sequential else "pipelined",
                  launches=dict(ds.LAUNCHES), ln_launches=dict(ln.LAUNCHES),
                  ln_expected=ln_expected, fa_launches=dict(fa.LAUNCHES),
                  fa_expected=fa_expected, prompt=have, levels={},
                  stages={k: v["seconds"]
                          for k, v in profiler.totals().items()})
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for level, prior in enumerate(priors):
        z = zs[level]
        if z.shape != (hps.n_samples, final[level]) or z.min() < 0 \
                or z.max() >= prior.l_bins:
            raise AssertionError(f"level {level}: codes {z.shape} "
                                 f"[{z.min()}, {z.max()}] out of range "
                                 f"(want {final[level]} codes)")
        if prompt_zs is not None and not np.array_equal(
                z[:, :have[level]], prompt_zs[level]):
            raise AssertionError(f"level {level}: the prompt's codes were "
                                 f"not kept")
        logdir = os.path.join(hps.name, f"level_{level}")
        with open(os.path.join(logdir, "data.jkb"), "rb") as f:
            x = pickle.load(f)["x"]
        length = final[level] * prior.raw_to_tokens
        if x.shape != (hps.n_samples, length, 1) or not np.isfinite(x).all():
            raise AssertionError(f"level {level}: audio {x.shape} not finite")
        exts = (".wav", ".html") + (("_align.png", "_align.json")
                                    if aligns(priors[-1]) else ())
        files = {f"item_{i}{ext}" for i in range(hps.n_samples)
                 for ext in exts}
        missing = files - set(os.listdir(logdir))
        if missing:
            raise AssertionError(f"level {level}: {sorted(missing)} missing")
        sec = report["stages"].get(f"windows_l{level}", float("nan"))
        report["levels"][level] = dict(tokens=int(z.shape[1]),
                                       decode_steps=steps[level],
                                       seconds=sec,
                                       tokens_per_s=steps[level] / sec,
                                       audio_rms=float(np.sqrt((x ** 2).mean())))
    report["vqvae_decode_s"] = report["stages"].get("vqvae_decode")
    if cuda:
        if report["launches"] != expected:
            raise AssertionError(f"kernel launches {report['launches']} != "
                                 f"expected {expected}: a decode step missed a"
                                 f" kernel")
        if report["ln_launches"] != ln_expected:
            raise AssertionError(f"LayerNorm launches {report['ln_launches']}"
                                 f" != expected {ln_expected}")
        if report["fa_launches"] != fa_expected:
            raise AssertionError(f"flash launches {report['fa_launches']} != "
                                 f"expected {fa_expected}")
    if aligns(priors[-1]):
        report["align"] = check_alignment(priors, hps, sampling_kwargs, zs,
                                          labels)
    return report


# ---------------------------------------------------------------------------
# phase 4c: phase 4's models through upstream's .pth.tar files
# ---------------------------------------------------------------------------

def round_dense_fp16(priors):
    """Round every prior's dense weights (upstream's Conv1D.w, which its
    fp16_params models hold in fp16) to fp16 values in place, so that phase
    4c's files hold them in fp16 and restore them bit for bit. Returns the
    number of tensors."""
    n = 0
    with torch.no_grad():
        for prior in priors:
            for mod in prior.model.modules():
                if isinstance(mod, Dense):
                    mod.w.copy_(mod.w.to(torch.float16).to(mod.w.dtype))
                    n += 1
    return n


def upstream_key(name, modules, layout="model"):
    """Upstream's state-dict key of the port's parameter `name`, with the
    module layout of upstream's torch code: a conv block is a numbered
    Sequential (encoder: model.{i} = (strided conv, resnet), then
    model.{down_t} the projection; decoder: model.0 the projection, then
    model.{1 + i} = (resnet, transposed conv)), a resnet block is
    {layout}.{j} = Sequential(ReLU, conv, ReLU, conv 1x1) (layout "model",
    or "blocks" when trained with per-block checkpointing), the
    transformer's layers are _attn_mods.{d}, convs and LayerNorms name
    their tensors weight / bias. Returns (key, transpose): x_out and
    prime_x_out are torch Linear layers, (out, in)."""
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    owner = modules[path]
    if path.endswith(".proj"):
        block = modules[path[:-len(".proj")]]
        path = path[:-len("proj")] + (
            f"model.{block.down_t}" if isinstance(block, EncoderConvBlock)
            else "model.0")
    for pat, rep in (
            (r"\.downs\.(\d+)\.conv_down$", r".model.\1.0"),
            (r"\.downs\.(\d+)\.resnet\.", r".model.\1.1."),
            (r"\.ups\.(\d+)\.conv_up$",
             lambda m: f".model.{1 + int(m.group(1))}.1"),
            (r"\.ups\.(\d+)\.resnet\.",
             lambda m: f".model.{1 + int(m.group(1))}.0."),
            (r"\.blocks\.(\d+)\.conv_dil$", rf".{layout}.\1.model.1"),
            (r"\.blocks\.(\d+)\.conv_1x1$", rf".{layout}.\1.model.3"),
            (r"\.transformer\.blocks\.", ".transformer._attn_mods.")):
        path = re.sub(pat, rep, path)
    transpose = False
    if isinstance(owner, (Conv1d, ConvTranspose1d)):
        leaf = {"w": "weight", "b": "bias"}[leaf]
    elif isinstance(owner, LayerNorm):
        leaf = {"g": "weight", "b": "bias"}[leaf]
    elif isinstance(owner, Table) and leaf == "w":
        leaf, transpose = "weight", True
    return (f"{path}.{leaf}" if path else leaf), transpose


def upstream_state_dict(model, fp16=False, layout="model"):
    """The state dict upstream's torch modules would hold for the port's
    `model` (a VQVAE or a SimplePrior), on the CPU, in fp32, with the dense
    weights (upstream's Conv1D.w) in fp16 under fp16, and a VQ-VAE's
    codebooks as bottleneck.level_blocks.{level}.k."""
    modules = dict(model.named_modules())
    sd = {}
    for name, p in model.named_parameters():
        key, transpose = upstream_key(name, modules, layout)
        t = p.detach().t() if transpose else p.detach()
        half = fp16 and isinstance(modules[name.rsplit(".", 1)[0]], Dense) \
            and name.endswith(".w")
        sd[key] = t.to("cpu", torch.float16 if half else torch.float32,
                       copy=True).contiguous()
    if hasattr(model, "bottleneck"):
        for level, blk in enumerate(model.bottleneck.level_blocks):
            sd[f"bottleneck.level_blocks.{level}.k"] = blk.k.detach().to(
                "cpu", torch.float32, copy=True)
    return sd


def save_upstream(path, model, hps, step, fp16=False, layout="model",
                  prefix=""):
    """Write `model` as upstream's save_checkpoint does: {"hps": an object
    of class jukebox.hparams.Hyperparams (a module that exists only while
    writing), "model": its state dict (keys under `prefix`, e.g. "module."),
    "opt": None, "step": step}. Returns the state dict's dtypes counted."""
    sd = {prefix + k: v for k, v in
          upstream_state_dict(model, fp16, layout).items()}
    pkg, mod = types.ModuleType("jukebox"), types.ModuleType("jukebox.hparams")
    cls = type("Hyperparams", (dict,), {"__module__": "jukebox.hparams"})
    mod.Hyperparams, pkg.hparams = cls, mod
    saved = {k: sys.modules.get(k) for k in ("jukebox", "jukebox.hparams")}
    sys.modules.update({"jukebox": pkg, "jukebox.hparams": mod})
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(dict(hps=cls(dict(hps)), model=sd, opt=None, step=step),
                   path)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    dtypes = {}
    for v in sd.values():
        dtypes[str(v.dtype)] = dtypes.get(str(v.dtype), 0) + 1
    return dtypes


def _rss_gb():
    """This process's resident set (VmRSS of /proc/self/status) in GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("/proc/self/status has no VmRSS")


class RssPeak:
    """The largest VmRSS of this process (GB) inside a with block, read
    from /proc/self/status every `every` seconds by a thread that ends
    with the block (a sampled peak: a rise shorter than the period can be
    missed)."""

    def __init__(self, every=0.002):
        self.every, self.peak = every, _rss_gb()
        self._stop = threading.Event()

    def _poll(self):
        while not self._stop.wait(self.every):
            self.peak = max(self.peak, _rss_gb())

    def __enter__(self):
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gb())


def assert_same_model(got, want, what):
    """Every parameter (name, dtype, bits) and buffer of `got` equals
    `want`'s, but a VQ-VAE's codebook state: k equal, and the EMA state
    restore_state(k) sets (k_sum = k, k_elem 1, init, threshold 1)."""
    a, b = dict(got.named_parameters()), dict(want.named_parameters())
    if list(a) != list(b):
        raise AssertionError(f"{what}: parameters differ")
    for n in a:
        if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n]):
            raise AssertionError(f"{what}: {n} not restored bit for bit "
                                 f"({a[n].dtype} vs {b[n].dtype})")
    if hasattr(got, "bottleneck"):
        for level, (x, y) in enumerate(zip(got.bottleneck.level_blocks,
                                           want.bottleneck.level_blocks)):
            ok = (torch.equal(x.k, y.k) and torch.equal(x.k_sum, x.k)
                  and bool((x.k_elem == 1).all()) and bool(x.init)
                  and float(x.threshold) == 1.0)
            if not ok:
                raise AssertionError(f"{what}: codebook {level} not restored")
    return len(a)


def run_upstream(vqvae, priors, hps4, rep4, seed, device):
    """Phase 4c: phase 4's four models written as upstream's .pth.tar files
    (5b/vqvae, 5b/prior_level_0, 5b/prior_level_1,
    1b_lyrics/prior_level_2: the presets' own paths under a temporary
    HOME's ~/.cache/jukebox/models), the priors' dense weights in fp16
    and the rest in fp32, the top's keys under "module."; restored by
    make_model("1b_lyrics") through resolve_restore (its params, codebooks
    and steps checked bit for bit against phase 4's), then the same cascade
    at phase 4's seed with the default scheduler: pipelined, finalize and
    staging on worker threads. Its codes must equal phase 4's at every
    level. Returns the cascade's report with the files' (files)."""
    home = tempfile.mkdtemp(prefix="jukebox_smoke_home_")
    vq_name, *prior_names = MODELS["1b_lyrics"]
    plan = [(vq_name, setup_hparams(vq_name, {}).restore_vqvae, vqvae)] + [
        (n, setup_hparams(n, {}).restore_prior, p.model)
        for n, p in zip(prior_names, priors)]
    files = []
    try:
        for i, (name, remote, model) in enumerate(plan):
            path = os.path.join(home, ".cache", remote[len(REMOTE_PREFIX):])
            t = time.time()
            dtypes = save_upstream(
                path, model, setup_hparams(name, {}), step=100 + i,
                fp16=i > 0, prefix="module." if i == len(plan) - 1 else "")
            files.append(dict(path=remote[len(REMOTE_PREFIX):],
                              bytes=os.path.getsize(path),
                              save_s=time.time() - t, dtypes=dtypes))
        hps = Hyperparams(n_samples=N_SAMPLES, sample_length=SAMPLE_LENGTH,
                          sr=hps4.sr, hop_fraction=hps4.hop_fraction,
                          seed=seed,
                          name=tempfile.mkdtemp(prefix="jukebox_smoke_4c_"))
        load_s, load_any = {}, mm.load_any

        def timed(path, *args):
            t = time.time()
            out = load_any(path, *args)
            torch.cuda.synchronize()
            load_s[os.path.relpath(path, home)] = time.time() - t
            return out
        old_home = os.environ.get("HOME")
        os.environ["HOME"] = home
        mm.load_any = timed
        rss0 = _rss_gb()
        t = time.time()
        try:
            with RssPeak() as rss:
                vq2, priors2 = make_model("1b_lyrics", hps, device,
                                          prior_overrides=[
                                              {"prior_depth": UPS_DEPTH},
                                              {"prior_depth": UPS_DEPTH},
                                              {}])
                torch.cuda.synchronize()
        finally:
            mm.load_any = load_any
            if old_home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = old_home
        make_s = time.time() - t
        peak = rss.peak
        n = assert_same_model(vq2, vqvae, "vqvae")
        for level, (p2, p) in enumerate(zip(priors2, priors)):
            n += assert_same_model(p2.model, p.model, f"prior {level}")
        steps = [vq2.step] + [p.step for p in priors2]
        if steps != [100 + i for i in range(len(plan))] or len(load_s) != 4:
            raise AssertionError(f"restored steps {steps}, files read "
                                 f"{sorted(load_s)}")
        for f in files:
            f["load_s"] = load_s[os.path.join(".cache", f["path"])]
            log(f"  {f['path']}: {f['bytes']} bytes ({f['dtypes']}), saved "
                f"in {f['save_s']:.2f}s, restored in {f['load_s']:.2f}s")
        log(f"  make_model restored {n} tensors bit for bit in {make_s:.1f}s"
            f"; host RSS {rss0:.2f} GB before, {peak:.2f} GB at its peak "
            f"while restoring (sampled every 2 ms)")
        skw = [dict(temp=TEMP, fp16=True, chunk_size=256,
                    max_batch_size=N_SAMPLES) for _ in priors2]
        log(f"phase 4c cascade: the restored models, the default scheduler "
            f"(pipelined, async finalize and staging), phase 4's seed")
        rep = run_cascade(priors2, hps, skw)
        for level, (z, z4) in enumerate(zip(rep["zs"], rep4["zs"])):
            if not np.array_equal(z, z4):
                raise AssertionError(
                    f"level {level}: the pipelined cascade's codes differ "
                    f"from phase 4's at {int((z != z4).sum())} of {z.size}")
        log_cascade(rep, "upstream")
        log(f"  codes equal to phase 4's at every level; stage seconds "
            f"(thread-seconds) {_stages(rep)} vs phase 4's {_stages(rep4)}")
        rep.update(files=files, restore_s=make_s, host_peak_gb=peak,
                   host_rss_gb=rss0)
        del vq2, priors2
        shutil.rmtree(hps.name, ignore_errors=True)
    finally:
        shutil.rmtree(home, ignore_errors=True)
    torch.cuda.empty_cache()
    return rep


def run_golden(seed, device):
    """Phase 4d: the golden dump of 1b_lyrics at full width from random
    weights drawn from `seed` (make_models.save_outputs, as `python -m
    jukebox_tpu_torch.models.make_models 1b_lyrics` runs it): labels_v3,
    so the top prior alone runs its fp32 teacher-forced forward over 6144
    codes and 384 lyric tokens. Checks the dump's shapes and that every
    value is finite."""
    t = time.time()
    out = tempfile.mkdtemp(prefix="jukebox_smoke_golden_")
    try:
        data = mm.save_outputs("1b_lyrics", device, Hyperparams(seed=seed),
                               path=os.path.join(out, "data.jkb"))
        size = os.path.getsize(os.path.join(out, "data.jkb"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    n = 6144 * 128
    levels = sorted(k for k in data if isinstance(k, int))
    shapes = dict(zs=[z.shape for z in data["zs"]],
                  x_ds=[x.shape for x in data["x_ds"]],
                  x_out=data[2]["x_out"].shape, preds=data[2]["preds"].shape)
    bins = setup_hparams("vqvae", {}).l_bins
    want = dict(zs=[(1, n // 8), (1, n // 32), (1, n // 128)],
                x_ds=[(1, n, 1)] * 3, x_out=(1, n, 1),
                preds=(1, 384 + 6144, 79 + bins))
    finite = all(np.isfinite(a).all() for a in data["x_ds"] + [
        data[2]["x_out"], data[2]["preds"]])
    if shapes != want or levels != [2] or not finite:
        raise AssertionError(f"golden dump: {shapes} (want {want}), levels "
                             f"{levels}, finite {finite}")
    log(f"phase 4d golden: save_outputs('1b_lyrics') at full width in "
        f"{time.time() - t:.1f}s, {size} bytes: zs {shapes['zs']}, the "
        f"top's preds {shapes['preds']} (fp32 forward), finite")


def _stages(rep):
    return {k: round(v, 2) for k, v in sorted(rep["stages"].items())}


# ---------------------------------------------------------------------------
# phases 5 and 6: training the top prior
# ---------------------------------------------------------------------------

def train_hps(seed, **over):
    return setup_hparams(TRAIN_HPS, dict(TRAIN_KW, seed=seed, **over))


def n_flash_layers(runtime, hps):
    """f0 layers of the prior that take the flash path in training."""
    tr = runtime.model.prior.transformer
    return sum(blk.attn.uses_flash(tr.n_ctx, torch.bfloat16 if hps.fp16
                                   else torch.float32) for blk in tr.blocks)


def expected_flash(n_layers, n_steps):
    return {k: per * n_layers * n_steps
            for k, per in fa.LAUNCHES_PER_STEP.items()}


def expected_layer_norms(runtime, n_steps, n_evals=0):
    """LayerNorm kernel launches of n_steps train steps of the prior and
    n_evals eval batches: the transformer's two per block (under
    checkpoint_res the forward runs again in the recompute), the
    conditioner's one and a lyric encoder's two per block and its
    prime_state_ln, forward and backward once each (the eval batches
    forward only)."""
    model = runtime.model
    tr, enc = model.prior.transformer, model.prime_prior

    def per(t):
        return ln.LAUNCHES_PER_STEP["layer_norm_fwd"] \
            if t.checkpoint_res == 1 else 1
    once = int(model.x_cond)
    fwd, bwd = per(tr) * 2 * tr.n_depth + once, 2 * tr.n_depth + once
    if enc is not None:
        fwd += per(enc.transformer) * 2 * enc.transformer.n_depth + 1
        bwd += 2 * enc.transformer.n_depth + 1
    return {"layer_norm_fwd": fwd * n_steps + bwd * n_evals,
            "layer_norm_bwd": bwd * n_steps}


def sample_layer_norms(runtime):
    """LayerNorm kernels one in-training sample runs (train.sample_prior:
    the fp32 decode through the layer modules): two per layer for each
    token step (n_ctx, and the tail of a single_enc_dec prior's lyric
    prefix that is not a whole block_ctx chunk) and each whole chunk of
    that prefix, the conditioner's one and a lyric encoder's forward (two
    per layer and prime_state_ln). The wrapper counts them less the token
    steps a CUDA graph replays, plus each capture's (check_samples)."""
    model = runtime.model
    steps = model.n_ctx
    if model.single_enc_dec:
        bc = model.prior.block_ctx
        steps += model.n_tokens // bc + model.n_tokens % bc
    enc = model.prime_prior
    once = int(model.x_cond) + (0 if enc is None
                                else 2 * enc.transformer.n_depth + 1)
    return 2 * model.prior.transformer.n_depth * steps + once


@contextlib.contextmanager
def sampling_watch():
    """While open, train.sample_prior is wrapped: each in-training sample
    appends to the yielded list its kernel launches (the wrappers'
    counts), its decode graph's captures and replays, wall seconds (the
    card synchronised), codes and audio checks, the LayerNorm kernels
    sample_layer_norms expects it to run and the LayerNorms of one token
    step."""
    real, calls = train_mod.sample_prior, []

    def watched(runtime, *args, **kw):
        before, graphs = training_launches(), dict(ar.GRAPHS)
        t0 = time.time()
        z, x = real(runtime, *args, **kw)
        if z.is_cuda:
            torch.cuda.synchronize()
        after = training_launches()
        calls.append(dict(
            launches={k: after[k] - before[k] for k in after},
            graphs={k: ar.GRAPHS[k] - graphs[k] for k in graphs},
            wall_s=time.time() - t0, codes=(int(z.min()), int(z.max())),
            shape=tuple(z.shape), audio=tuple(x.shape),
            finite=bool(torch.isfinite(x).all()), bins=runtime.l_bins,
            n_ctx=runtime.n_ctx, expected_ln=sample_layer_norms(runtime),
            step_ln=2 * runtime.model.prior.transformer.n_depth))
        return z, x
    train_mod.sample_prior = watched
    try:
        yield calls
    finally:
        train_mod.sample_prior = real


def check_samples(calls, n, cuda, what):
    """The in-training samples of a run: n of them, codes in [0, l_bins)
    of n_ctx per item, finite audio; on the card a decode graph replayed
    and the LayerNorm wrapper's launches as sample_layer_norms expects
    less the replayed steps' and plus the captured one's, and no other
    kernel. Returns the launches the wrappers are expected to count,
    summed."""
    if len(calls) != n:
        raise AssertionError(f"{what}: {len(calls)} in-training samples, "
                             f"expected {n}")
    total = dict.fromkeys(training_launches(), 0)
    for c in calls:
        lo, hi = c["codes"]
        if not (0 <= lo and hi < c["bins"] and c["shape"][1] == c["n_ctx"]
                and c["finite"]):
            raise AssertionError(f"{what}: sample codes {c['codes']} of "
                                 f"{c['shape']}, audio finite {c['finite']}")
        want = dict.fromkeys(c["launches"], 0)
        g = c["graphs"]
        want["layer_norm_fwd"] = (c["expected_ln"] - c["step_ln"]
                                  * (g["replays"] - g["captures"]))
        if cuda and not (g["captures"] == 1 and g["replays"] > 0):
            raise AssertionError(f"{what}: the sample's decode graph {g}")
        if cuda and c["launches"] != want:
            raise AssertionError(f"{what}: sample launches {c['launches']} "
                                 f"!= expected {want}")
        for k, v in want.items():
            total[k] += v
    return total


def reset_training_launches():
    for mod in (fa, ln, ad):
        mod.reset_launches()


def training_launches():
    return dict(**fa.LAUNCHES, **ln.LAUNCHES, **ad.LAUNCHES)


def train_batch(runtime, hps, device, gen):
    """One batch: noisy random audio [bs, sample_length, 1] in [-1, 1] and
    labels for fixed metadata."""
    x = (0.3 * torch.randn((hps.bs, hps.sample_length, 1), generator=gen,
                           device=device)).clamp(-1, 1)
    meta = dict(artist="unknown", genre="unknown", lyrics=LYRICS,
                total_length=hps.sample_length * 3, offset=0)
    y = runtime.get_y(runtime.labeller.get_batch_labels([meta] * hps.bs), 0)
    return x, torch.as_tensor(y, device=device)


def loss_and_grads(runtime, hps, x, y, plain, probes):
    """Loss of one batch, the global grad norm and the gradients of the
    parameters named in `probes`; the gradients are dropped after."""
    model = runtime.model
    z = runtime.vqvae.encode(x, start_level=model.level)[0]
    for p in model.parameters():
        p.grad = None
    loss, _ = model.z_forward(z, y=y, fp16=hps.fp16, plain=plain)
    loss.backward()
    params = runtime.params
    gn = train_mod.global_grad_norm({n: p.grad for n, p in params.items()})
    grads = {n: params[n].grad.detach().clone() for n in probes}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), float(gn), grads


@contextlib.contextmanager
def plain_flash():
    """The flash wrappers run their plain versions inside the block (the
    LayerNorm kernels do not): the reference that isolates flash."""
    saved = {n: getattr(fa, n) for n in fa.LAUNCHES}
    for n in saved:
        setattr(fa, n, getattr(fa, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fa, n, f)


@contextlib.contextmanager
def faulty_flash_fwd():
    """The planted fault of phase 5: flash_fwd skips one kv tile's P.V in
    the late rows (skip_tile on its v)."""
    real = fa.flash_fwd

    def faulty(qh, kh, vh, *args):
        return real(qh, kh, skip_tile(vh), *args)
    fa.flash_fwd = faulty
    try:
        yield
    finally:
        fa.flash_fwd = real


@contextlib.contextmanager
def faulty_layer_norm(kind):
    """A planted fault in layer_norm_fwd for the step checks: "row", phase
    2c's (each launch leaves its last row out: y, mu and rstd zero there),
    or "vector" (each launch leaves the last 16 bytes of every row of y
    zero: a column loop one vector short)."""
    real = ln.layer_norm_fwd

    def faulty(x, g, b, eps=ln.EPS):
        if kind == "row" and x.shape[0] >= 2:
            y, mu, rstd = real(x[:-1], g, b, eps)
            return (torch.cat([y, torch.zeros_like(x[-1:])]),
                    torch.cat([mu, mu.new_zeros(1)]),
                    torch.cat([rstd, rstd.new_zeros(1)]))
        y, mu, rstd = real(x, g, b, eps)
        if kind == "vector":
            y[:, -(16 // x.element_size()):] = 0
        return y, mu, rstd
    ln.layer_norm_fwd = faulty
    try:
        yield
    finally:
        ln.layer_norm_fwd = real


def step_gaps(kernel, plain):
    """(loss, grad norm, {probe: grad}) of a path against the plain path's:
    relative gaps, the gradients' as ||g - g_plain|| / ||g_plain||."""
    (loss_k, gn_k, g_k), (loss_p, gn_p, g_p) = kernel, plain
    gaps = {"loss": abs(loss_k - loss_p) / abs(loss_p),
            "grad norm": abs(gn_k - gn_p) / gn_p}
    for n in g_p:
        gaps[n] = (torch.linalg.vector_norm((g_k[n] - g_p[n]).float())
                   / torch.linalg.vector_norm(g_p[n].float())).item()
    return gaps


def check_train_step(seed, device, gen, rows=None, **over):
    """Phase 5: the full-width top prior's loss and gradients on one batch
    through the flash and LayerNorm kernels, held against the path with
    flash alone plain (GRAD_TOL etc.) and against the all-plain path
    (FULL_TOL); the planted flash fault must fail the first. Each path's
    wall is printed. With `rows` (a dict), phase 2d runs first on the
    prior's parameters and its Adam rows go there. Returns the flash
    launches of the kernel path."""
    hps = train_hps(seed, **over)
    t = time.time()
    runtime = make_prior(hps, make_vqvae(hps, device), device)
    tr = runtime.model.prior.transformer
    f0 = [d for d in range(tr.n_depth) if tr.blocks[d].attn.attn_func == 0]
    n_flash = n_flash_layers(runtime, hps)
    if len(f0) != 1 or n_flash != 1:
        raise AssertionError(f"expected one f0 layer on the flash path, got "
                             f"{f0} ({n_flash} flash)")
    probes = [f"prior.transformer.blocks.{f0[0]}.attn.{w}.w"
              for w in ("c_attn", "c_proj")]
    n_params = sum(p.numel() for p in runtime.params.values())
    log(f"phase 5 train step: top prior {tr.n_depth} layers, width "
        f"{tr.n_in}, n_ctx {tr.n_ctx}, {n_params / 1e6:.1f} M params in "
        f"{len(runtime.params)} tensors, f0 layer {f0[0]}, built in "
        f"{time.time() - t:.1f}s")
    if rows is not None:
        for fp16 in (False, True):
            row = check_adam(runtime.params, fp16, device)
            if fp16 == hps.fp16_opt:  # the main path's form
                rows["adam_update"] = row
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    x, y = train_batch(runtime, hps, device, gen)
    walls = {}

    def timed(path, plain_):
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        out = loss_and_grads(runtime, hps, x, y, plain_, probes)
        if x.is_cuda:
            torch.cuda.synchronize()
        walls[path] = (time.time() - t0) * 1e3
        return out
    reset_training_launches()
    kernel = timed("kernel path (first)", False)
    launches = dict(fa.LAUNCHES)
    ln_launches = dict(ln.LAUNCHES)
    plain = timed("all plain", True)
    if dict(fa.LAUNCHES) != launches or dict(ln.LAUNCHES) != ln_launches:
        raise AssertionError("the plain path launched a kernel")
    with plain_flash():
        flash_plain = timed("flash alone plain", False)
    with faulty_flash_fwd():
        fault = timed("kernel path with the planted fault", False)
    log("phase 5 walls of one batch's encode, forward, backward and grad "
        "norm (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    tols = {n: GRAD_TOL[n.split(".")[-2]] for n in probes}
    tols.update({"loss": LOSS_TOL, "grad norm": GN_TOL})
    full_tols = {n: FULL_TOL[n.split(".")[-2] if "." in n else n]
                 for n in tols}
    sound, planted = (step_gaps(kernel, flash_plain),
                      step_gaps(fault, flash_plain))
    full, full_fault = step_gaps(kernel, plain), step_gaps(fault, plain)
    log(f"phase 5: loss kernel {kernel[0]:.6f} plain {plain[0]:.6f}, grad "
        f"norm {kernel[1]:.6g} vs {plain[1]:.6g}; launches {launches} "
        f"{ln_launches}")
    for n, tol in tols.items():
        log(f"  {n}: against flash alone plain: kernel path "
            f"{sound[n]:.3e}, planted fault {planted[n]:.3e} (tol {tol:g});"
            f" against all plain: kernel path {full[n]:.3e}, planted fault "
            f"{full_fault[n]:.3e} (tol {full_tols[n]:g})")
    if not (math.isfinite(kernel[0]) and math.isfinite(kernel[1])
            and all(sound[n] <= tol for n, tol in tols.items())):
        raise AssertionError("the kernel path's train step disagrees with "
                             "the path with flash alone plain")
    if not all(full[n] <= tol for n, tol in full_tols.items()):
        raise AssertionError("the kernel path's train step disagrees with "
                             "the plain path")
    if all(planted[n] <= tol for n, tol in tols.items()):
        raise AssertionError("the train step's checks pass a flash forward "
                             "that skips a tile")
    if x.is_cuda and launches != expected_flash(1, 1):
        raise AssertionError(f"flash launches {launches} != expected "
                             f"{expected_flash(1, 1)}")
    if x.is_cuda and ln_launches != expected_layer_norms(runtime, 1):
        raise AssertionError(f"LayerNorm launches {ln_launches} != expected "
                             f"{expected_layer_norms(runtime, 1)}")
    profile_train_step(runtime, hps, x, y)
    c = check_c_attn(runtime, hps, x, y)
    log(f"phase 9 (c) c_attn = c_mlp = 1 on phase 5's step: loss "
        f"{c['loss'][1]:.6f} against c_res alone {c['loss'][0]:.6f}, grad "
        f"norm {c['gn'][1]:.6g} against {c['gn'][0]:.6g}; {c['equal']} of "
        f"{c['n']} gradients equal bit for bit ({c['repeat_equal']} repeat "
        f"to the bit under c_res alone; differing: {c['differ'][:4]}); "
        f"wall {c['wall_s'][1] * 1e3:.1f} ms against "
        f"{c['wall_s'][0] * 1e3:.1f}; peak memory {_gb(c['peak_gb'][1])} "
        f"against {_gb(c['peak_gb'][0])}")
    graph = check_decode_graph(runtime, x, y, GRAPH_TOKENS,
                               "phase 5 top prior")
    return dict(launches=dict(launches, **ln_launches), c_attn=c,
                graph=graph)


def profile_train_step(runtime, hps, x, y, top=8):
    """Two steps of train.make_prior_train_step: one timed by its parts
    (encode, forward, backward, update) on the host clock, synchronised at
    the end of each, then, on the card, one under torch.profiler: the
    device's busy share of the step and the kernels with the most device
    time."""
    lr_fn = train_mod.make_lr_schedule(hps)
    opt = train_mod.adam_init(runtime.params, fp16_state=hps.fp16_opt)
    marks = []

    def mark(part):
        if x.is_cuda:
            torch.cuda.synchronize()
        marks.append((part, time.time()))
    mark("start")
    train_mod.make_prior_train_step(runtime, hps, lr_fn, mark=mark)(
        opt, (x, y), None, 1, 2.0 ** 16)
    parts = {p: (t1 - t0) * 1e3 for (_, t0), (p, t1) in zip(marks, marks[1:])}
    log(f"phase 5 step by parts (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items())
        + f"; total {sum(parts.values()):.1f}")
    if not x.is_cuda:
        return
    step = train_mod.make_prior_train_step(runtime, hps, lr_fn)
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as pr:
        t0 = time.time()
        step(opt, (x, y), None, 2, 2.0 ** 16)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
             e.count) for e in pr.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    busy = (f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.0%})"
            if busy_ms > 0 else "device busy not measured (no profiler "
                                "device time)")
    groups = {}
    for ms, key, count in rows:
        g = kernel_group(key)
        groups[g] = [a + b for a, b in zip(groups.get(g, (0.0, 0)),
                                            (ms, count))]
    log(f"phase 5 profiled step: {wall_ms:.1f} ms wall, {busy}; by kernel "
        f"group: " + ", ".join(f"{g} {ms:.1f} ms x{n}" for g, (ms, n) in
                               sorted(groups.items(), key=lambda i: -i[1][0])))
    log("  top kernels by device time:")
    for ms, key, count in rows[:top]:
        log(f"    {ms:8.2f} ms  x{count:<6d} {key[:100]}")


def kernel_group(name):
    """A coarse class of a profiled kernel by its name."""
    n = name.lower()
    for group, marks in (("flash", ("flash_",)),
                         ("layer_norm", ("layer_norm_",)),
                         ("adam", ("adam_fp",)),
                         ("matmul", ("gemm", "cutlass", "nvjet", "xmma",
                                     "sm90_")),
                         ("reduce", ("reduce",)),
                         ("softmax", ("softmax",)),
                         ("copy/cast", ("copy",))):
        if any(m in n for m in marks):
            return group
    return "elementwise/other"


def write_wavs(dirname, n, seconds, sr, seed):
    """n stereo 16-bit wavs of chords and noise drawn from seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        f = rng.uniform(110, 880, size=3)
        sig = sum(np.sin(2 * np.pi * fi * t) for fi in f) / 6
        sig = sig + 0.05 * rng.standard_normal(t.shape)
        pcm = (np.clip(np.stack([sig, sig * 0.8], axis=1), -1, 1)
               * 32767).astype("<i2")
        with wave.open(os.path.join(dirname, f"song_{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())


def run_training(seed, device, n_steps=TRAIN_STEPS, wav_seconds=WAV_SECONDS,
                 logdir=None, **over):
    """Phase 6: train.run on two synthetic wavs with a labelled dataset,
    saving checkpoint_latest.jkb under {logdir}/smoke at step 1 when a
    logdir is given (nothing is saved without). Returns a report dict
    (per-step records, flash launches and their expected counts, the
    LayerNorm and Adam kernels' (kernel_launches, kernel_expected), median
    step wall, tokens/s, peak memory)."""
    cuda = device != "cpu" and torch.device(device).type == "cuda"
    threads = set(threading.enumerate())
    with tempfile.TemporaryDirectory(prefix="jukebox_train_") as wavs:
        kw = dict(over, audio_files_dir=wavs, max_steps=n_steps,
                  cpu_ema_freq=CPU_EMA_FREQ, log_steps=1)
        if logdir is None:  # the logs go with the wavs
            kw.update(save=False, local_logdir=wavs, name="smoke")
        else:  # save_iters > n_steps: only step 1 saves
            kw.update(save=True, save_iters=n_steps + 1, local_logdir=logdir,
                      name="smoke")
        hps = train_hps(seed, **kw)
        write_wavs(wavs, 2, wav_seconds, hps.sr, seed)
        dataset = FixedMetadataDataset(hps, "unknown", "unknown", LYRICS)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_training_launches()
        t0 = time.time()
        with sampling_watch() as samples:
            out = train_mod.run(TRAIN_HPS, device=device, dataset=dataset,
                                **dict(TRAIN_KW, seed=seed, **kw))
        wall = time.time() - t0
        launches = dict(fa.LAUNCHES)
        kernel_launches = dict(**ln.LAUNCHES, **ad.LAUNCHES)
    runtime, records = out["runtime"], out["records"]
    n_flash = n_flash_layers(runtime, hps)
    walls = [r["wall_s"] for r in records[1:]]
    step_s = float(np.median(walls)) if walls else float("nan")
    sampled = check_samples(samples, 1, cuda, "phase 6")
    expected = expected_layer_norms(runtime, len(records))
    expected["layer_norm_fwd"] += sampled["layer_norm_fwd"]
    report = dict(records=records, launches=launches, wall_s=wall,
                  expected=expected_flash(n_flash, len(records)),
                  kernel_launches=kernel_launches, samples=samples,
                  n_depth=runtime.model.prior.transformer.n_depth,
                  kernel_expected=dict(
                      expected,
                      adam_update=sum(r["step_ok"] for r in records)),
                  median_step_s=step_s, n_flash_layers=n_flash,
                  tokens_per_s=runtime.model.prior.input_dims * hps.bs / step_s,
                  ema_updates=out["ema"].steps // out["ema"].freq,
                  peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None))
    del out, runtime
    if len(records) != n_steps:
        raise AssertionError(f"{len(records)} steps, expected {n_steps}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["gn"])):
            raise AssertionError(f"step {r['it']}: loss {r['loss']} gn "
                                 f"{r['gn']} not finite")
    saved = [r["it"] for r in records if "checkpoint" in r]
    if saved != ([1] if logdir is not None else []):
        raise AssertionError(f"checkpoints saved at steps {saved}")
    left = [t for t in set(threading.enumerate()) - threads if t.is_alive()]
    if left or multiprocessing.active_children():
        raise AssertionError(f"threads {left} or processes "
                             f"{multiprocessing.active_children()} outlive "
                             f"the run")
    if cuda and launches != report["expected"]:
        raise AssertionError(f"flash launches {launches} != expected "
                             f"{report['expected']}")
    if cuda and kernel_launches != report["kernel_expected"]:
        raise AssertionError(f"LayerNorm / Adam launches {kernel_launches} "
                             f"!= expected {report['kernel_expected']}")
    return report


def assert_same(tensors, ref, what):
    """{name: tensor} equal bit for bit to {name: numpy array}."""
    if set(tensors) != set(ref):
        raise AssertionError(f"{what}: names differ from the file's")
    for n, t in tensors.items():
        a = t.detach().cpu().numpy()
        if a.dtype != ref[n].dtype or not np.array_equal(
                a.reshape(ref[n].shape), ref[n]):
            raise AssertionError(f"{what}: {n} differs from the file")


def check_resume(seed, device, ckpt, n_more=2, wav_seconds=WAV_SECONDS,
                 **over):
    """Phase 6 (a) and (b): a new train.run restored from the checkpoint
    `ckpt` holds its params, optimizer state and step bit for bit, then
    takes n_more finite steps through the kernels; a sampling make_prior
    restored from it holds its params as convert_params_bf16 casts them.
    Returns a report dict (checkpoint
    bytes, load and restore seconds, the resumed records, launches)."""
    cuda = torch.device(device).type == "cuda"
    t = time.time()
    file = load_checkpoint(ckpt)
    load_s = time.time() - t
    step = int(file["step"])
    with tempfile.TemporaryDirectory(prefix="jukebox_train_") as wavs:
        kw = dict(over, audio_files_dir=wavs, max_steps=step + n_more,
                  cpu_ema_freq=CPU_EMA_FREQ, log_steps=1, save=False,
                  restore_prior=ckpt, local_logdir=wavs, name="resumed")
        hps = train_hps(seed, **kw)
        write_wavs(wavs, 2, wav_seconds, hps.sr, seed)
        dataset = FixedMetadataDataset(hps, "unknown", "unknown", LYRICS)
        t = time.time()
        state = train_mod.setup(TRAIN_HPS, device=device, dataset=dataset,
                                **dict(TRAIN_KW, seed=seed, **kw))
        setup_s = time.time() - t
        model, opt = state["runtime"].model, state["opt_state"]
        assert_same(state["runtime"].params, named_leaves(model,
                                                          file["params"]),
                    "restored params")
        for key in ("m", "v", "m_scale", "v_scale"):
            if key in file["opt"]:
                assert_same(opt[key], named_leaves(model, file["opt"][key]),
                            f"restored optimizer {key}")
        if not (state["runtime"].step == opt["step"] == step
                == int(file["opt"]["step"])):
            raise AssertionError(f"restored step {state['runtime'].step} / "
                                 f"{opt['step']} != the file's {step}")
        reset_training_launches()
        out = train_mod.fit(state)
        launches = training_launches()
    records = out["records"]
    expected = dict(expected_flash(n_flash_layers(out["runtime"], hps),
                                   len(records)),
                    **expected_layer_norms(out["runtime"], len(records)),
                    adam_update=sum(r["step_ok"] for r in records))
    del out, state, model, opt
    if [r["it"] for r in records] != list(range(step + 1,
                                               step + n_more + 1)):
        raise AssertionError(f"resumed steps {[r['it'] for r in records]}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["gn"])
               for r in records):
        raise AssertionError("a resumed step is not finite")
    if cuda and launches != expected:
        raise AssertionError(f"resumed run launches {launches} != expected "
                             f"{expected}")
    # (b) the sampling runtime
    shps = setup_hparams(TRAIN_HPS, dict(TRAIN_KW, seed=seed, train=False,
                                         restore_prior=ckpt, **over))
    t = time.time()
    sampler = make_prior(shps, make_vqvae(shps, device), device)
    sample_s = time.time() - t
    # the sampling prior holds the checkpoint's tensors as
    # convert_params_bf16 casts them (hps.fp16_params): bf16 except the
    # LayerNorms, bit for bit
    ref = named_leaves(sampler.model, file["params"])
    if set(ref) != set(sampler.params):
        raise AssertionError("sampling params: names differ from the file's")
    for n, t in sampler.params.items():
        want = torch.from_numpy(np.ascontiguousarray(ref[n]))
        if not set(n.split(".")) & set(LN_KEYS):
            want = want.to(torch.bfloat16)
        if t.dtype != want.dtype or not torch.equal(
                t.detach().cpu(), want.reshape(t.shape)):
            raise AssertionError(f"sampling params: {n} differs from the "
                                 f"file's tensor cast by "
                                 f"convert_params_bf16")
    if sampler.step != step:
        raise AssertionError(f"sampling runtime step {sampler.step}")
    dtypes = {}
    for t in sampler.params.values():
        dtypes[str(t.dtype)] = dtypes.get(str(t.dtype), 0) + 1
    del sampler, file
    return dict(bytes=os.path.getsize(ckpt), load_s=load_s, setup_s=setup_s,
                sample_restore_s=sample_s, step=step, records=records,
                launches=launches, expected=expected, sampling_dtypes=dtypes)


def log_cascade(rep, label):
    for level, lv in sorted(rep["levels"].items(), reverse=True):
        log(f"  {label} level {level}: {lv['tokens']} codes"
            + ("" if rep["prompt"] is None
               else f" ({rep['prompt'][level]} of the prompt kept)")
            + f", {lv['decode_steps']} decode steps in {lv['seconds']:.1f}s"
            f" = {lv['tokens_per_s']:.1f} steps/s (x{N_SAMPLES} samples), "
            f"audio rms {lv['audio_rms']:.3f}")
    st = rep["stages"]
    log(f"  {label} cascade ({rep['scheduler']}) {rep['wall_s']:.1f}s, "
        f"vqvae decode "
        f"{rep['vqvae_decode_s']:.1f}s, alignment {st.get('align', 0):.2f}s,"
        f" html {st.get('html', 0):.2f}s, peak memory "
        f"{rep['peak_mem_gb']:.1f} GB; launches {rep['launches']} == "
        f"expected {rep['expected']}; LayerNorm {rep['ln_launches']} == "
        f"expected {rep['ln_expected']}; flash {rep['fa_launches']} == "
        f"expected {rep['fa_expected']}")


def run_primed(priors, hps4, seed):
    """Phase 4b: primed_sample from phase 4's level_0/item_0.wav, read by
    load_prompts for PROMPT_SECONDS rounded down to the top's
    raw_to_tokens, at phase 4's length and hop fractions, with phase 4's
    VQ-VAE and top and upsamplers of UPS_DEPTH layers drawn from
    `seed`: the first window of every level carries the prompt's codes as
    context. Returns the cascade's report."""
    top = priors[-1]
    device = next(top.model.parameters()).device
    priors = [make_prior(setup_hparams(name, dict(
        seed=seed, prior_depth=UPS_DEPTH)), top.vqvae, device)
        for name in MODELS["1b_lyrics"][1:3]] + [top]
    duration = (int(PROMPT_SECONDS * hps4.sr) // top.raw_to_tokens
                * top.raw_to_tokens)
    hps = Hyperparams(n_samples=N_SAMPLES, sample_length=hps4.sample_length,
                      sr=hps4.sr, hop_fraction=hps4.hop_fraction, seed=seed,
                      name=tempfile.mkdtemp(prefix="jukebox_smoke_primed_"))
    x = sample_mod.load_prompts(
        [os.path.join(hps4.name, "level_0", "item_0.wav")], duration, hps)
    skw = [dict(temp=TEMP, fp16=True, chunk_size=256,
                max_batch_size=N_SAMPLES) for _ in priors]
    log(f"phase 4b primed: a {duration}-sample prompt ({duration / hps.sr:.2f}"
        f" s) of phase 4's first wav, {N_SAMPLES} x {hps.sample_length} "
        f"samples, {UPS_DEPTH}-layer upsamplers")
    try:
        rep = run_cascade(priors, hps, skw, prompt=x)
    finally:
        shutil.rmtree(hps.name, ignore_errors=True)
    log_cascade(rep, "primed")
    return rep


def run_5b_lyrics(seed, device, gen):
    """Phase 7: the 5b_lyrics cascade drawn from `seed` (the top at all 79
    layers, the upsamplers at UPS_DEPTH_5B): one full-width top decode step
    kernel path against plain path in bf16 and in int8 and one int8
    upsampler step (phase 3), then the ancestral cascade in the int8 mode;
    then prior_5b at full width and one of its decode steps checked.
    Returns the cascade's report."""
    t = time.time()
    hps = Hyperparams(n_samples=N_SAMPLES, sample_length=SAMPLE_LENGTH,
                      sr=44100, hop_fraction=HOPS, seed=seed,
                      name=tempfile.mkdtemp(prefix="jukebox_smoke_5b_"))
    vqvae, priors = make_model("5b_lyrics", hps, device, prior_overrides=[
        {"prior_depth": UPS_DEPTH_5B}, {"prior_depth": UPS_DEPTH_5B}, {}])
    torch.cuda.synchronize()
    top = priors[-1]
    n_params = sum(p.numel() for p in top.model.parameters())
    log(f"phase 7 models: 5b_lyrics drawn from seed {seed} in "
        f"{time.time() - t:.1f}s, depths "
        f"{[p.model.prior.transformer.n_depth for p in priors]}, top "
        f"{n_params / 1e9:.3f} G parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    step_ms = {}
    for prior, quantize in ((top, None), (top, "int8"), (priors[0], "int8")):
        step_ms[(prior.level, quantize)] = check_stack_step(
            prior, N_SAMPLES, device, gen, quantize)
        torch.cuda.empty_cache()
    skw = [dict(temp=TEMP, fp16=True, chunk_size=256,
                max_batch_size=N_SAMPLES) for _ in priors]
    log(f"phase 7 cascade: 5b_lyrics, int8 weights and caches "
        f"(JUKEBOX_INT8_DECODE=1), {N_SAMPLES} x {hps.sample_length} "
        f"samples, temp {TEMP}")
    rep = run_cascade(priors, hps, skw, int8=True)
    log_cascade(rep, "5b_lyrics")
    lv = rep["levels"][2]
    log(f"  5b_lyrics top: {lv['tokens_per_s']:.2f} decode steps/s "
        f"(x{N_SAMPLES} samples, 79 layers, int8); phase 3 step walls "
        f"bf16 {step_ms[(2, None)]:.2f} ms, int8 {step_ms[(2, 'int8')]:.2f} "
        f"ms")
    shutil.rmtree(hps.name, ignore_errors=True)
    del vqvae, priors, top, prior
    torch.cuda.empty_cache()
    # the lyric-free prior_5b (order 2, no f6), built at full width: one
    # decode step, kernel path against plain path
    vq = make_vqvae(setup_hparams("vqvae", dict(
        sample_length=SAMPLE_LENGTH, seed=seed)), device)
    p5 = make_prior(setup_hparams("prior_5b", dict(seed=seed)), vq, device)
    log(f"phase 7 prior_5b: {p5.model.prior.transformer.n_depth} layers, "
        f"{sum(p.numel() for p in p5.model.parameters()) / 1e9:.3f} G "
        f"parameters")
    check_stack_step(p5, N_SAMPLES, device, gen)
    del vq, p5
    torch.cuda.empty_cache()
    return rep


# ---------------------------------------------------------------------------
# phase 8: the Quick start: train a VQ-VAE, then a prior over its codes
# ---------------------------------------------------------------------------

# upstream's two training commands (README "Quick start"); the second
# restores the first's checkpoint and writes checkpoint_latest.jkb at
# step 1 as the command does
VQ_HPS = "small_vqvae"
VQ_KW = dict(name="small_vqvae", sample_length=262144, bs=4, labels=False,
             train=True, aug_shift=True, aug_blend=True)
PRIOR_HPS = "small_vqvae,small_prior,all_fp16,cpu_ema"
PRIOR_KW = dict(name="small_prior", sample_length=2097152, bs=4,
                labels=False, train=True, test=True, aug_shift=True,
                aug_blend=True, prior=True, levels=2, level=1,
                weight_decay=0.01)
VQ_STEPS, PRIOR_STEPS = 6, 3
# the songs: two stereo files at 44.1 kHz (the presets train at 22.05 kHz),
# one IEEE float32 wav and one int16
SONG_SR, SONG_KINDS = 44100, ("float32", "int16")
# the vqvae preset at its published widths, fresh (no restore), at the
# first command's length and batch
BIG_VQ_KW = dict(sample_length=262144, bs=4, train=True, labels=False,
                 restore_vqvae="", aug_blend=True)


def quick_start_hps(which, seed, **over):
    name, kw = ((VQ_HPS, VQ_KW) if which == "vqvae" else (PRIOR_HPS,
                                                         PRIOR_KW))
    return setup_hparams(name, dict(kw, seed=seed, **over))


def song_seconds(hps, n_files=2):
    """Whole seconds of each of n_files songs so that the prior's dataset
    holds a training batch of bs items and a test item (an epoch is then one
    step), plus one second."""
    n = hps.bs
    while int(n * hps.train_test_split) < hps.bs or \
            n - int(n * hps.train_test_split) < 1:
        n += 1
    return math.ceil(n * hps.sample_length / hps.sr / n_files) + 1


def write_songs(dirname, seconds, sr, seed, kinds=SONG_KINDS):
    """One stereo song per kind (a wav of IEEE float32 or int16 samples) of
    `seconds` at rate sr: three-note chords changing every half second over
    noise, drawn from seed. Returns the paths."""
    from scipy.io import wavfile
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    paths = []
    for i, kind in enumerate(kinds):
        chords = rng.uniform(110, 880, size=(int(seconds * 2) + 1, 3))
        freq = np.repeat(chords, sr // 2, axis=0)[:n]
        phase = 2 * np.pi * np.cumsum(freq, axis=0) / sr
        sig = np.sin(phase).sum(axis=1) / 6
        sig = sig + 0.05 * rng.standard_normal(n)
        x = np.clip(np.stack([sig, 0.8 * sig], axis=1), -1, 1)
        data = (x.astype(np.float32) if kind == "float32"
                else (x * 32767).astype(np.int16))
        path = os.path.join(dirname, f"song_{i}.wav")
        wavfile.write(path, sr, data)
        paths.append(path)
    return paths


def expected_quick_start(hps, n_steps, n_evals):
    """Kernel launches of n_steps train steps of the prior of hps and
    n_evals eval batches: LayerNorm per step (its two per block, under
    c_res twice in the forward), per eval batch its two per block forward
    only; flash for its f0 layers (none in attn_order 2's cycle); one Adam
    update per step."""
    n_f0 = sum(ATTN_ORDERS[hps.attn_order](d) == 0
               for d in range(hps.prior_depth))
    n_ln = 2 * hps.prior_depth
    fwd_per = ln.LAUNCHES_PER_STEP["layer_norm_fwd"] if hps.c_res == 1 else 1
    return dict(
        expected_flash(n_f0, n_steps),
        layer_norm_fwd=fwd_per * n_ln * n_steps + n_ln * n_evals,
        layer_norm_bwd=n_ln * n_steps, adam_update=n_steps)


def _outlived(threads):
    left = [t for t in set(threading.enumerate()) - threads if t.is_alive()]
    if left or multiprocessing.active_children():
        raise AssertionError(f"threads {left} or processes "
                             f"{multiprocessing.active_children()} outlive "
                             f"the run")


def _finite(records, keys):
    for r in records:
        bad = {k: r[k] for k in keys if not math.isfinite(r[k])}
        if bad:
            raise AssertionError(f"step {r['it']}: {bad} not finite")


def _peak_reset(cuda):
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(cuda):
    return torch.cuda.max_memory_allocated() / 1e9 if cuda else None


def _gb(x):
    return "not measured (CPU)" if x is None else f"{x:.2f} GB"


def run_vq_quick_start(seed, device, songs, logdir, n_steps=VQ_STEPS,
                       **over):
    """Phase 8 (a): the first Quick start command through train.run, for
    n_steps, saving checkpoint_step_1.jkb under {logdir}/small_vqvae.
    Checks finite losses and codebook metrics, used_curr > 0, one Adam
    launch per step, a checkpoint at step 1 alone with params, optimizer
    state and every level's whole codebook state, and that no thread
    outlives the run. Returns a report dict."""
    cuda = torch.device(device).type == "cuda"
    threads = set(threading.enumerate())
    kw = dict(VQ_KW, audio_files_dir=songs, max_steps=n_steps, log_steps=1,
              local_logdir=logdir, seed=seed, **over)
    _peak_reset(cuda)
    reset_training_launches()
    t0 = time.time()
    out = train_mod.run(VQ_HPS, device=device, **kw)
    wall = time.time() - t0
    launches = training_launches()
    records = out["records"]
    runtime = out["runtime"]
    hps = quick_start_hps("vqvae", seed, **over)
    n_params = sum(p.numel() for p in runtime.params.values())
    del out, runtime
    if len(records) != n_steps:
        raise AssertionError(f"{len(records)} steps, expected {n_steps}")
    _finite(records, ("loss", "gn", "recons_loss", "multispectral_loss",
                      "commit_loss", "entropy", "usage", "used_curr", "dk",
                      "pn", "fit"))
    if not all(r["used_curr"] > 0 for r in records):
        raise AssertionError("a step used no code")
    saved = [r["it"] for r in records if "checkpoint" in r]
    if saved != [1]:
        raise AssertionError(f"checkpoints saved at steps {saved}")
    ckpt = records[0]["checkpoint"]
    if os.path.basename(ckpt) != "checkpoint_step_1.jkb":
        raise AssertionError(f"checkpoint {ckpt}")
    file = load_checkpoint(ckpt)
    blocks = file["state"]["level_blocks"]
    if file["opt"] is None or len(blocks) != hps.levels or any(
            set(b) != set(STATE_KEYS) for b in blocks):
        raise AssertionError("the checkpoint lacks the optimizer state or "
                             "the codebook state")
    _outlived(threads)
    expected = dict(expected_flash(0, n_steps), layer_norm_fwd=0,
                    layer_norm_bwd=0,
                    adam_update=sum(r["step_ok"] for r in records))
    if cuda and launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    walls = [r["wall_s"] for r in records[1:]]
    return dict(records=records, launches=launches, expected=expected,
                wall_s=wall, median_step_s=float(np.median(walls)),
                n_params=n_params, checkpoint=ckpt,
                bytes=os.path.getsize(ckpt), peak_mem_gb=_peak_gb(cuda))


def check_vq_restore(seed, device, ckpt, **over):
    """Phase 8 (a), the restore: a frozen make_vqvae restored from the
    checkpoint holds its params and every level's codebook state bit for
    bit; restored for training (train=True), the codebooks get the
    fine-tuning reset, checked against its formula: k the file's, k_elem
    num_tokens / k_bins for every code and k_sum k times that (fp32),
    num_tokens = sample_length // the level's raw_to_tokens, init set,
    threshold revival_threshold. Returns the step restored."""
    file = load_checkpoint(ckpt)
    hps = quick_start_hps("vqvae", seed, restore_vqvae=ckpt, train=False,
                          **over)
    vq = make_vqvae(hps, device)
    assert_same(dict(vq.named_parameters()), named_leaves(vq, file["params"]),
                "restored VQ-VAE params")
    for level, (blk, ref) in enumerate(zip(vq.bottleneck.level_blocks,
                                           file["state"]["level_blocks"])):
        assert_same({k: getattr(blk, k) for k in STATE_KEYS}, ref,
                    f"restored codebook state of level {level}")
    step = vq.step
    del vq
    hps = quick_start_hps("vqvae", seed, restore_vqvae=ckpt, **over)
    vq = make_vqvae(hps, device)
    raw_to_tokens = np.cumprod(vq.downsamples)
    for level, (blk, ref) in enumerate(zip(vq.bottleneck.level_blocks,
                                           file["state"]["level_blocks"])):
        e = np.float32(hps.sample_length // int(raw_to_tokens[level])
                       / hps.l_bins)
        want = dict(k=ref["k"], k_sum=ref["k"] * e,
                    k_elem=np.full(hps.l_bins, e, np.float32),
                    init=np.asarray(True),
                    threshold=np.asarray(hps.revival_threshold, np.float32))
        assert_same({k: getattr(blk, k) for k in STATE_KEYS}, want,
                    f"fine-tuning reset of level {level}")
    if not all(p.requires_grad for p in vq.parameters()):
        raise AssertionError("a VQ-VAE restored for training is frozen")
    del vq
    return step


def vq_batch(hps, songs, gen, device):
    """bs items of the dataset over the songs (their bandwidth into hps),
    preprocessed as the training loop does: [bs, T, 1] on device."""
    hps.audio_files_dir = songs
    dataset = FilesAudioDataset(hps)
    hps.bandwidth = calculate_bandwidth(dataset, hps, duration=600)
    x = np.stack([dataset[i] for i in range(hps.bs)])
    return audio_preprocess(torch.from_numpy(x).to(device), hps, gen=gen)


def check_vqvae_step(seed, device, songs, gen, **over):
    """Phase 8 (b): the vqvae preset at its published widths (3 levels,
    downs_t (3, 2, 2), multipliers (2, 1, 1), 2048 codes, lmix), fresh, on a
    batch of the songs: its gradients' Adam update through the kernel
    against the plain loop on the VQ-VAE's own tensors (check_adam with the
    real gradients), with a planted fault (the update item of a one-element
    tensor, the last conv's bias, left out of the walk); then one whole
    train step (its codebooks seeded from the batch, one Adam launch),
    timed, with its peak memory. Returns a report dict."""
    cuda = torch.device(device).type == "cuda"
    hps = setup_hparams("vqvae", dict(BIG_VQ_KW, seed=seed, **over))
    x = vq_batch(hps, songs, gen, device)
    t = time.time()
    vq = make_vqvae(hps, device)
    runtime = VQVAERuntime(vq)
    params = runtime.params
    n_params = sum(p.numel() for p in params.values())
    widths = [e.level_blocks[0].downs[0]["conv_down"].w.shape[0]
              for e in vq.encoders]
    log(f"phase 8 (b) vqvae preset: {hps.levels} levels, downs_t "
        f"{tuple(hps.downs_t)}, widths {widths}, {hps.l_bins} codes, "
        f"{n_params / 1e6:.2f} M params in {len(params)} tensors "
        f"(smallest {min(p.numel() for p in params.values())} elements), "
        f"built in {time.time() - t:.1f}s; batch {tuple(x.shape)}")
    for p in params.values():
        p.grad = None
    _, loss, _ = vq(x, hps, loss_fn=hps.loss_fn, train=True,
                    gen=torch.Generator(device=device).manual_seed(seed))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    start = {n: p.detach().clone() for n, p in params.items()}
    fault_at = min(start, key=lambda n: (start[n].numel(), n))
    log(f"  Adam on its {len(start)} tensors, the planted fault at "
        f"{fault_at} ({start[fault_at].numel()} element)")
    adam_row = check_adam(start, hps.fp16_opt, device, grads=grads,
                          fault_at=fault_at, time_it=cuda)
    del grads, start
    step = train_mod.make_vqvae_train_step(runtime, hps,
                                           train_mod.make_lr_schedule(hps))
    opt = train_mod.adam_init(params, fp16_state=hps.fp16_opt)
    _peak_reset(cuda)
    reset_training_launches()
    t0 = time.time()
    loss, metrics = step(opt, (x, None), seed, 1)
    loss = float(loss)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = training_launches()
    peak = _peak_gb(cuda)
    if not (math.isfinite(loss) and math.isfinite(float(metrics["gn"]))):
        raise AssertionError(f"vqvae preset step: loss {loss} not finite")
    if cuda and launches["adam_update"] != int(metrics["step_ok"]):
        raise AssertionError(f"vqvae preset step: launches {launches}")
    del vq, runtime, params, opt, x
    return dict(loss=loss, wall_s=wall, peak_mem_gb=peak, launches=launches,
                n_params=n_params, adam=adam_row,
                used_curr=float(metrics["used_curr"]),
                gn=float(metrics["gn"]))


def check_prior_checkpoint(records, runtime, hps):
    """Phase 8 (c)'s checkpoint: checkpoint_latest.jkb written at step 1
    alone, holding step 1, a param of every trainable tensor at its shape
    and, under fp16_opt, fp16 Adam moments with their scales. Returns
    (path, bytes)."""
    saved = [r["it"] for r in records if "checkpoint" in r]
    if saved != [1]:
        raise AssertionError(f"prior checkpoints saved at steps {saved}")
    path = records[0]["checkpoint"]
    if os.path.basename(path) != "checkpoint_latest.jkb":
        raise AssertionError(f"prior checkpoint {path}")
    file = load_checkpoint(path)
    if int(file["step"]) != 1:
        raise AssertionError(f"prior checkpoint at step {file['step']}")
    # named_leaves raises on a missing, leftover or misshapen leaf
    named_leaves(runtime.model, file["params"])
    keys = ("m", "v", "m_scale", "v_scale") if hps.fp16_opt else ("m", "v")
    opt = {k: named_leaves(runtime.model, file["opt"][k]) for k in keys}
    if hps.fp16_opt and any(t.dtype != np.float16 for k in ("m", "v")
                            for t in opt[k].values()):
        raise AssertionError("prior checkpoint: moments not fp16")
    return path, os.path.getsize(path)


def run_prior_quick_start(seed, device, songs, vq_ckpt, logdir, gen,
                          n_steps=PRIOR_STEPS, **over):
    """Phase 8 (c): the second Quick start command through train.run, for
    n_steps over the VQ-VAE of checkpoint vq_ckpt, saving
    checkpoint_latest.jkb under {logdir}/small_prior at step 1: the VQ-VAE
    restored with its codebooks (bit for bit, no reset), finite losses, the
    launch counts of the LayerNorm, flash and Adam kernels against
    expected_quick_start (here each epoch is one step and one test batch),
    the checkpoint (check_prior_checkpoint), no thread left. Then, outside
    the counted run, the LayerNorm kernels against their plain versions at
    the run's rows [bs x n_ctx, width] in its dtype, and the Adam kernel
    against the plain loop on the prior's own tensors in its moments' form
    (check_adam). Returns a report dict with those rows' max_abs_err."""
    cuda = torch.device(device).type == "cuda"
    threads = set(threading.enumerate())
    kw = dict(PRIOR_KW, audio_files_dir=songs, restore_vqvae=vq_ckpt,
              max_steps=n_steps, log_steps=1, seed=seed, local_logdir=logdir,
              **over)
    hps = setup_hparams(PRIOR_HPS, kw)
    _peak_reset(cuda)
    reset_training_launches()
    t0 = time.time()
    with sampling_watch() as samples:
        out = train_mod.run(PRIOR_HPS, device=device, **kw)
    wall = time.time() - t0
    launches = training_launches()
    runtime, records = out["runtime"], out["records"]
    tr = runtime.model.prior.transformer
    file = load_checkpoint(vq_ckpt)
    for level, (blk, ref) in enumerate(zip(
            runtime.vqvae.bottleneck.level_blocks,
            file["state"]["level_blocks"])):
        assert_same({k: getattr(blk, k) for k in STATE_KEYS}, ref,
                    f"the prior's VQ-VAE codebook of level {level}")
    # each epoch evaluates the test split, ceil(test items / bs) batches
    n_items = len(FilesAudioDataset(hps))
    n_test = n_items - int(n_items * hps.train_test_split)
    n_evals = (len({r["epoch"] for r in records})
               * math.ceil(n_test / hps.bs))
    expected = expected_quick_start(hps, len(records), n_evals)
    expected["adam_update"] = sum(r["step_ok"] for r in records)
    expected["layer_norm_fwd"] += check_samples(
        samples, 1, cuda, "phase 8 (c)")["layer_norm_fwd"]
    report = dict(
        records=records, launches=launches, expected=expected, wall_s=wall,
        samples=samples,
        test=out["test"], n_depth=tr.n_depth, width=tr.n_in,
        n_ctx=tr.n_ctx, n_flash_layers=n_flash_layers(runtime, hps),
        n_params=sum(p.numel() for p in runtime.params.values()),
        median_step_s=float(np.median([r["wall_s"] for r in records[1:]])),
        peak_mem_gb=_peak_gb(cuda))
    report["tokens_per_s"] = tr.n_ctx * hps.bs / report["median_step_s"]
    if len(records) != n_steps:
        raise AssertionError(f"{len(records)} steps, expected {n_steps}")
    _finite(records, ("loss", "gn", "bpd"))
    if not math.isfinite(report["test"]["loss"]):
        raise AssertionError(f"test loss {report['test']}")
    _outlived(threads)
    if cuda and launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    report["checkpoint"], report["bytes"] = check_prior_checkpoint(
        records, runtime, hps)
    ln_shape = (hps.bs * tr.n_ctx, tr.n_in,
                torch.bfloat16 if hps.fp16 else torch.float32)
    start = {n: p.detach().clone() for n, p in runtime.params.items()}
    del out, runtime, tr
    log(f"  (c) LayerNorm kernels at the run's rows {ln_shape[:2]} "
        f"{str(ln_shape[2]).split('.')[-1]}; Adam on the prior's "
        f"{len(start)} tensors")
    report["rows"] = check_layer_norm([ln_shape], device, gen, time_it=False)
    report["rows"]["adam_update"] = check_adam(start, hps.fp16_opt, device,
                                               time_it=False)
    del start
    return report


def quick_start_songs(tmp, seed):
    """Phase 8's songs written under tmp/songs. Returns (songs, logdir),
    the logs' directory tmp/logs."""
    songs, logdir = os.path.join(tmp, "songs"), os.path.join(tmp, "logs")
    os.makedirs(songs)
    seconds = song_seconds(quick_start_hps("prior", seed))
    t = time.time()
    write_songs(songs, seconds, SONG_SR, seed)
    native = "built" if wavio.available() else "unavailable"
    compressed = ("available" if avio.available() else
                  "unavailable (no ffmpeg libraries): wav only")
    log(f"phase 8 songs: {len(SONG_KINDS)} x {seconds} s stereo at "
        f"{SONG_SR} Hz ({', '.join(SONG_KINDS)} wav) in "
        f"{time.time() - t:.1f}s; native wav reader {native}, avio "
        f"{compressed}")
    return songs, logdir


def run_quick_start(seed, device, gen, songs, logdir, only_a=False):
    """Phase 8 on the songs, logging under logdir: (a), its restore, (b)
    and (c); only (a) with only_a. Returns {"a", "b", "c"} reports (None
    where not run)."""
    a = run_vq_quick_start(seed, device, songs, logdir)
    for r in a["records"]:
        log(f"  (a) step {r['it']}: " + " ".join(
            f"{pk} {r[k]:.5g}" for pk, k in train_mod.VQVAE_KEYS.items())
            + f" step_ok {r['step_ok']} wall {r['wall_s']:.3f}s"
            + (f"; saved in {r['save_s']:.2f}s" if "save_s" in r else ""))
    log(f"  (a) run {a['wall_s']:.1f}s, median step (steps 2-"
        f"{VQ_STEPS}) {a['median_step_s'] * 1e3:.1f} ms, peak memory "
        f"{a['peak_mem_gb']:.2f} GB, {a['n_params'] / 1e6:.2f} M params;"
        f" launches {a['launches']} == expected {a['expected']}; "
        f"checkpoint {a['bytes']} bytes")
    if only_a:
        return dict(a=a, b=None, c=None)
    step = check_vq_restore(seed, device, a["checkpoint"])
    log(f"  (a) restored at step {step}: params and codebook state bit "
        f"for bit; for training, the fine-tuning reset as its formula")
    b = check_vqvae_step(seed, device, songs, gen)
    log(f"  (b) one train step: loss {b['loss']:.5g} gn {b['gn']:.5g} "
        f"used_curr {b['used_curr']:.0f}, wall {b['wall_s'] * 1e3:.1f} "
        f"ms, peak memory {b['peak_mem_gb']:.2f} GB, launches "
        f"{b['launches']}")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    c = run_prior_quick_start(seed, device, songs, a["checkpoint"], logdir,
                              gen)
    for r in c["records"]:
        log(f"  (c) step {r['it']}: " + " ".join(
            f"{pk} {r[k]:.5g}" for pk, k in train_mod.PRIOR_KEYS.items()
            if k in r) + f" step_ok {r['step_ok']} wall "
            f"{r['wall_s']:.3f}s"
            + (f"; sample {r['sample_s']:.1f}s" if "sample_s" in r else ""))
    log(f"  (c) {c['n_depth']} layers at width {c['width']}, n_ctx "
        f"{c['n_ctx']}, {c['n_params'] / 1e6:.1f} M params; run "
        f"{c['wall_s']:.1f}s, median step (steps 2-{PRIOR_STEPS}) "
        f"{c['median_step_s'] * 1e3:.1f} ms = {c['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {c['peak_mem_gb']:.2f} GB, test loss "
        f"{c['test']['loss']:.5g}; {c['n_flash_layers']} flash layers; "
        f"launches {c['launches']} == expected {c['expected']}; "
        f"checkpoint {c['bytes']} bytes, saved in "
        f"{c['records'][0]['save_s']:.2f}s; sample "
        f"{c['samples'][0]['wall_s']:.1f}s")
    return dict(a=a, b=b, c=c)


# ---------------------------------------------------------------------------
# phase 9: upstream's other training recipes
# ---------------------------------------------------------------------------

# README "Train the upsampler" over phase 8 (a)'s VQ-VAE at the preset's
# published widths and depth (48 layers at 1024, a 16-layer conditioner at
# 512, n_ctx 8192): three steps, the inputs logged at steps 1 and 3
# (save_iters 2), the in-training sample of step 1 at full depth, step 3
# traced (debug_speed)
UPS_HPS = "small_vqvae,small_upsampler,all_fp16,cpu_ema"
UPS_KW = dict(name="small_upsampler", sample_length=262144, bs=4,
              labels=False, train=True, test=True, aug_shift=True,
              aug_blend=True, prior=True, levels=2, level=0,
              weight_decay=0.01, save_iters=2, log_steps=1,
              debug_speed=True)
UPS_STEPS = 3
# the fp32 decode as a CUDA graph against op by op, at temp 0 (phase 9 (a)'s
# upsampler, phase 5's 72-layer top), and the graphed decode's kernels
# counted in a profiler trace of its first PROFILED_TOKENS tokens
GRAPH_TOKENS, PROFILED_TOKENS = 128, 16
# the labelled and lyric small priors over the 3-level vqvae preset, fresh
# (its released file is on neither machine), at sample_length n_ctx x 128
LABELLED_LENGTH = {"small_labelled_prior": 1048576,
                   "small_single_enc_dec_prior": 786432,
                   "small_sep_enc_dec_prior": 786432}
LABELLED_KW = dict(bs=4, labels=True, train=True, test=True, aug_shift=True,
                   aug_blend=True, prior=True, levels=3, level=2,
                   weight_decay=0.01, restore_vqvae="", log_steps=1)
LABELLED_STEPS = 2
# their train.run at a cut depth, widths kept (one full-depth step each is
# held to the plain path first): 4 layers; the sep-enc-dec prior 10, so
# that its first f6 cross-attention layer (depth 9) stays
CUT_DEPTH = {"small_labelled_prior": 4, "small_single_enc_dec_prior": 4,
             "small_sep_enc_dec_prior": 10}
# the labels: v3 artist 3 and genre 9, inside the presets' y_bins (10, 100)
RECIPE_ARTIST, RECIPE_GENRE = "dianne reeves", "bebop"
# what a prior's step logs each log_steps (jukebox_tpu/train.py) under
# all_fp16, and the JSONL line's own keys
STEP_TAGS = ("bpd", "gen_loss", "gn", "lr", "prime_loss", "loss",
             "lg_loss_scale")
JSONL_KEYS = ("it", "wall_s", "window_s") + STEP_TAGS


def recipe_args(preset, seed, **over):
    """(hps set names, kwargs) of a recipe's train.run."""
    if preset == "small_upsampler":
        names, kw = UPS_HPS, dict(UPS_KW)
    else:
        names = f"vqvae,{preset},all_fp16,cpu_ema"
        kw = dict(LABELLED_KW, name=preset,
                  sample_length=LABELLED_LENGTH[preset])
    kw.update(seed=seed, **over)
    return names, kw


def recipe_hps(preset, seed, **over):
    return setup_hparams(*recipe_args(preset, seed, **over))


def recipe_dataset(hps):
    """The labelled dataset of a recipe, or None (labels=False)."""
    if not hps.labels:
        return None
    return FixedMetadataDataset(hps, RECIPE_ARTIST, RECIPE_GENRE, LYRICS)


def recipe_label_ids(hps):
    """(artist id, genre ids) of the recipes' metadata under hps's
    labeller; raises unless they fall inside hps.y_bins (genres,
    artists)."""
    from jukebox_tpu_torch.data.labels import Labeller
    lab = Labeller(hps.max_bow_genre_size, hps.n_tokens, hps.sample_length,
                   v3=hps.labels_v3)
    y = lab.get_label(RECIPE_ARTIST, RECIPE_GENRE, LYRICS,
                      hps.sample_length * 4, 0)["y"]
    artist, genres = int(y[3]), [int(g) for g in
                                 y[4:4 + hps.max_bow_genre_size]]
    n_genres, n_artists = hps.y_bins
    if not (0 <= artist < n_artists and all(-1 <= g < n_genres
                                            for g in genres)):
        raise AssertionError(f"label ids artist {artist} genres {genres} "
                             f"outside y_bins {hps.y_bins}")
    return artist, genres


def check_logs(logdir, hps, records, jsonl, labelled, evaluated, start=0):
    """The logger's files of a train.run under logdir that started at step
    `start`: argv.txt; events (utils/logger.py read_events, CRCs checked)
    holding every STEP_TAGS scalar, finite, at each step i with i %
    log_steps == 0, the test_* averages after an evaluation, and for a
    labelled prior the labels' text of its inputs and its sample naming
    the recipe's artist and genre; the input wavs at the steps i with
    (i - 1) % save_iters == 0 and the sample's at step 1; JSONL lines at
    the logged steps with JAX's keys. Returns a summary dict."""
    from jukebox_tpu_torch.utils.logger import read_events
    if not os.path.exists(os.path.join(logdir, "argv.txt")):
        raise AssertionError(f"{logdir}: no argv.txt")
    paths = [os.path.join(logdir, "logs", f) for f in
             os.listdir(os.path.join(logdir, "logs"))
             if f.startswith("events.out.tfevents.")]
    if len(paths) != 1:
        raise AssertionError(f"{logdir}: event files {paths}")
    events = read_events(paths[0])
    got = {(step, tag): v for step, tag, v in events}
    steps = [r["it"] for r in records]
    for it in steps:
        if it % hps.log_steps:
            continue
        for tag in STEP_TAGS:
            v = got.get((it, tag))
            if not (isinstance(v, float) and math.isfinite(v)):
                raise AssertionError(f"{logdir}: scalar {tag} at step {it}: "
                                     f"{v}")
    if evaluated and not any(tag.startswith("test_") and step == steps[-1]
                             for step, tag in got):
        raise AssertionError(f"{logdir}: no test_* scalar")
    name = f"artist:{RECIPE_ARTIST}, genre:{RECIPE_GENRE}"
    texts = {tag: v for (step, tag), v in got.items() if step == 1
             and tag.endswith("/text_summary")}
    if labelled and not all(name in texts.get(f"{t}/text_summary", "")
                            for t in ("train_y_in", "sample_x_T1")):
        raise AssertionError(f"{logdir}: the labels' text {texts}")
    n_clips = min(hps.bs, hps.max_log)
    want = {f"sample_x_T1_{i}_it1.wav" for i in range(n_clips)}
    want |= {f"train_x_in_{i}_it{it}.wav" for it in steps
             if (it - 1) % hps.save_iters == 0 for i in range(n_clips)}
    have = set(os.listdir(os.path.join(logdir, "audio")))
    if have != want:
        raise AssertionError(f"{logdir}: audio {sorted(have)} != "
                             f"{sorted(want)}")
    with open(jsonl) as f:
        lines = [json.loads(line) for line in f]
    logged = [it for it in steps if it % hps.log_steps == 0]
    if [r["it"] for r in lines] != logged or any(
            set(r) != set(JSONL_KEYS) for r in lines):
        raise AssertionError(f"{jsonl}: lines {lines}")
    return dict(events=len(events), tags=len({t for _, t, _ in events}),
                audio=len(have), jsonl=len(lines))


def run_recipe(preset, seed, device, songs, logdir, n_steps, graph_check=0,
               **over):
    """Phase 9 (a) / (b): train.run of a recipe for n_steps on the songs
    under logdir, JUKEBOX_TRAIN_JSONL set: finite losses, the LayerNorm,
    flash and Adam launches (expected_layer_norms with the run's
    evaluation, its in-training sample's own launches as
    sample_layer_norms), the sample (check_samples), the logger's files
    (check_logs), no thread left. With debug_speed, the trace of step 3:
    a Chrome trace file naming the LayerNorm or flash kernels. With
    graph_check, the trained prior's fp32 decode of that many tokens as a
    CUDA graph against op by op (check_decode_graph). Returns a report
    dict."""
    cuda = torch.device(device).type == "cuda"
    threads = set(threading.enumerate())
    names, kw = recipe_args(preset, seed, audio_files_dir=songs,
                            max_steps=n_steps, local_logdir=logdir, **over)
    hps = setup_hparams(names, kw)
    if hps.labels:
        recipe_label_ids(hps)
    jsonl = os.path.join(logdir, f"{hps.name}.jsonl")
    _peak_reset(cuda)
    reset_training_launches()
    saved_env = os.environ.get("JUKEBOX_TRAIN_JSONL")
    os.environ["JUKEBOX_TRAIN_JSONL"] = jsonl
    t0 = time.time()
    try:
        with sampling_watch() as samples:
            out = train_mod.run(names, device=device,
                                dataset=recipe_dataset(hps), **kw)
    finally:
        if saved_env is None:
            os.environ.pop("JUKEBOX_TRAIN_JSONL", None)
        else:
            os.environ["JUKEBOX_TRAIN_JSONL"] = saved_env
    wall = time.time() - t0
    launches = training_launches()
    runtime, records = out["runtime"], out["records"]
    model = runtime.model
    tr = model.prior.transformer
    n_items = len(FilesAudioDataset(hps))
    n_test = n_items - int(n_items * hps.train_test_split)
    n_evals = math.ceil(n_test / hps.bs) if hps.test else 0
    n_flash = n_flash_layers(runtime, hps)
    expected = dict(expected_flash(n_flash, len(records)),
                    **expected_layer_norms(runtime, len(records), n_evals),
                    adam_update=sum(r["step_ok"] for r in records))
    expected["flash_fwd"] += n_flash * n_evals
    sampled = check_samples(samples, 1, cuda, f"phase 9 {preset}")
    expected["layer_norm_fwd"] += sampled["layer_norm_fwd"]
    report = dict(
        preset=preset, records=records, launches=launches, wall_s=wall,
        expected=expected, samples=samples, n_depth=tr.n_depth,
        width=tr.n_in, n_ctx=model.n_ctx, n_flash_layers=n_flash,
        n_params=sum(p.numel() for p in runtime.params.values()),
        peak_mem_gb=_peak_gb(cuda), test=out["test"],
        encoder=(None if model.prime_prior is None else
                 (model.prime_prior.transformer.n_depth,
                  model.prime_prior.transformer.n_in)),
        cond=(hps.cond_depth, hps.cond_width) if model.x_cond else None)
    logdir_run = out["logger"].logdir
    if graph_check:
        x = 0.3 * torch.randn((1, hps.sample_length, 1),
                              device=next(model.parameters()).device)
        report["graph"] = check_decode_graph(runtime, x, None, graph_check,
                                             f"phase 9 {preset}")
    del out, runtime, model, tr
    if len(records) != n_steps:
        raise AssertionError(f"{preset}: {len(records)} steps")
    _finite(records, ("loss", "gn", "bpd"))
    if hps.test and not math.isfinite(report["test"]["loss"]):
        raise AssertionError(f"{preset}: test loss {report['test']}")
    _outlived(threads)
    if cuda and launches != expected:
        raise AssertionError(f"{preset}: launches {launches} != expected "
                             f"{expected}")
    report["logs"] = check_logs(logdir_run, hps, records, jsonl, hps.labels,
                                hps.test)
    if hps.debug_speed:
        report["trace"] = check_trace(logdir_run, cuda)
    return report


def check_trace(logdir, cuda):
    """debug_speed's trace under {logdir}/trace: one Chrome trace file
    whose events name the LayerNorm or flash kernels (on the card). Returns
    (path's bytes, kernel names found)."""
    d = os.path.join(logdir, "trace")
    files = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"debug_speed traces {files}")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = sorted({n for n in names if "layer_norm_" in n or "flash_" in n})
    if cuda and not found:
        raise AssertionError("the trace names no LayerNorm or flash kernel")
    return os.path.getsize(files[0]), found


def check_recipe_step(preset, seed, device, gen, **over):
    """Phase 9 (b): one full-depth step of a labelled or lyric recipe on
    one batch of random audio and the recipe's labels: loss and global
    gradient norm through the kernels against the plain path within
    RECIPE_TOL, the same with a planted LayerNorm fault (faulty_layer_norm:
    "row" read, "vector" refused), and for a prior with flash layers also
    against the path with flash alone plain within LOSS_TOL / GN_TOL
    (phase 5's method).
    Returns a report with the kernel path's launches."""
    hps = recipe_hps(preset, seed, **over)
    t = time.time()
    runtime = make_prior(hps, make_vqvae(hps, device), device)
    model = runtime.model
    tr = model.prior.transformer
    n_flash = n_flash_layers(runtime, hps)
    x = (0.3 * torch.randn((hps.bs, hps.sample_length, 1), generator=gen,
                           device=device)).clamp(-1, 1)
    meta = dict(artist=RECIPE_ARTIST, genre=RECIPE_GENRE, lyrics=LYRICS,
                total_length=hps.sample_length * 3, offset=0)
    y = torch.as_tensor(runtime.get_y(runtime.labeller.get_batch_labels(
        [meta] * hps.bs), 0), device=device)
    build_s = time.time() - t
    reset_training_launches()
    kernel = loss_and_grads(runtime, hps, x, y, False, [])
    launches = training_launches()
    plain = loss_and_grads(runtime, hps, x, y, True, [])
    gaps = step_gaps(kernel, plain)
    faults = {}
    for kind in ("row", "vector"):
        with faulty_layer_norm(kind):
            faults[kind] = step_gaps(loss_and_grads(runtime, hps, x, y, False,
                                                    []), plain)
    rep = dict(preset=preset, n_depth=tr.n_depth, width=tr.n_in,
               n_ctx=tr.n_ctx, n_flash_layers=n_flash, build_s=build_s,
               loss=kernel[0], gn=kernel[1], full=gaps, faults=faults,
               launches=launches,
               n_params=sum(p.numel() for p in runtime.params.values()))
    if not all(gaps[k] <= RECIPE_TOL[k] for k in gaps):
        raise AssertionError(f"{preset}: the kernel path's step disagrees "
                             f"with the plain path: {gaps}")
    if all(faults["vector"][k] <= RECIPE_TOL[k] for k in gaps):
        raise AssertionError(f"{preset}: the step check passes a LayerNorm "
                             f"forward that leaves the last 16 bytes of "
                             f"every row out: {faults['vector']}")
    if n_flash:
        with plain_flash():
            rep["flash"] = step_gaps(kernel, loss_and_grads(
                runtime, hps, x, y, False, []))
        if not (rep["flash"]["loss"] <= LOSS_TOL
                and rep["flash"]["grad norm"] <= GN_TOL):
            raise AssertionError(f"{preset}: the kernel path's step "
                                 f"disagrees with flash alone plain: "
                                 f"{rep['flash']}")
    want = dict(expected_flash(n_flash, 1),
                **expected_layer_norms(runtime, 1), adam_update=0)
    if x.is_cuda and launches != want:
        raise AssertionError(f"{preset}: launches {launches} != {want}")
    del runtime, model, tr, x
    return rep


def check_c_attn(runtime, hps, x, y):
    """Phase 9 (c): phase 5's full-width step again with c_attn = c_mlp = 1
    on every block (as make_prior sets them from hps), against the same
    step under c_res alone: the loss and every gradient equal bit for bit
    where the c_res step itself repeats to the bit (a second c_res step
    tells), else within FULL_TOL; peak memory of both. Returns a report."""
    cuda = x.is_cuda
    tr = runtime.model.prior.transformer
    names = list(runtime.params)

    def step(flags):
        for blk in tr.blocks:
            blk.checkpoint_attn = blk.checkpoint_mlp = flags
        _peak_reset(cuda)
        t0 = time.time()
        loss, gn, grads = loss_and_grads(runtime, hps, x, y, False, names)
        if cuda:
            torch.cuda.synchronize()
        return loss, gn, grads, time.time() - t0, _peak_gb(cuda)
    try:
        base = step(0)
        again = step(0)
        flagged = step(1)
    finally:
        for blk in tr.blocks:
            blk.checkpoint_attn = blk.checkpoint_mlp = 0
    repeats = {n for n in names if torch.equal(base[2][n], again[2][n])}
    differ = [n for n in names if not torch.equal(base[2][n],
                                                  flagged[2][n])]
    rep = dict(loss=(base[0], flagged[0]), gn=(base[1], flagged[1]),
               wall_s=(base[3], flagged[3]), peak_gb=(base[4], flagged[4]),
               repeat_equal=len(repeats), n=len(names),
               differ=differ, equal=len(names) - len(differ))
    # where c_res alone does not repeat to the bit, FULL_TOL's limits
    if (flagged[0] != base[0] if base[0] == again[0] else
            abs(flagged[0] - base[0]) > FULL_TOL["loss"] * abs(base[0])):
        raise AssertionError(f"c_attn / c_mlp loss {flagged[0]} != "
                             f"{base[0]}")
    for n in differ:
        # a gradient that c_res alone does not repeat to the bit (the
        # embedding backward's atomic adds) is held to FULL_TOL's
        # gradient limit instead
        gap = (torch.linalg.vector_norm((flagged[2][n] - base[2][n]).float())
               / torch.linalg.vector_norm(base[2][n].float())).item()
        if n in repeats or gap > FULL_TOL["c_attn"]:
            raise AssertionError(f"c_attn / c_mlp: {n} differs from the "
                                 f"c_res step's ({gap:.3e})")
    return rep


def trace_kernels(prof, name):
    """Kernels whose name holds `name` in a torch.profiler run's Chrome
    trace (its CUPTI kernel records: a CUDA graph's replays too)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel"
               and name in e.get("name", ""))


def check_decode_graph(runtime, x, y, n_tokens, what):
    """The fp32 layer-module decode (the in-training sample's) as a CUDA
    graph a token against op by op (DecodeGraph.wanted refusing), from the
    same caches at temp 0 for n_tokens: equal tokens; on the card the
    LayerNorm wrapper's launches, op by op two a layer a token, graphed
    the same less the replayed steps' and plus the capture's (ar.GRAPHS);
    the walls of both. On the card the graphed decode of PROFILED_TOKENS
    runs again under torch.profiler, and its trace must hold two
    layer_norm_fwd kernels a layer a token, less fewer than one a replay
    (records the trace lost): what the replays ran, which no wrapper
    counts. x: audio [N, T, 1] for the levels above, y: labels or None.
    Returns a report."""
    model = runtime.model
    cuda = x.is_cuda
    per_step = 2 * model.prior.transformer.n_depth
    z_conds = runtime.encode(x[:1], bs_chunks=1)[1:] or None
    y = None if y is None else y[:1]
    enc = (model.encoder_kv_from_y(y) if y is not None
           and model.prime_prior is not None else None)
    t0 = model.sample_prefix_len(None)
    n_tokens = min(n_tokens, model.prior.input_dims - t0)

    def decode(n, around=contextlib.nullcontext()):
        with torch.no_grad():
            caches, x_tok, x_cond, y_cond = model.sample_init(
                1, z_conds=z_conds, y=y, encoder_kv=enc)
            reset_training_launches()
            before = dict(ar.GRAPHS)
            if cuda:
                torch.cuda.synchronize()
            t = time.time()
            with around:
                toks, _ = model.sample_segment(
                    caches, x_tok, t0, n, None, x_cond, y_cond, temp=0.0)
                if cuda:
                    torch.cuda.synchronize()
        return (toks, time.time() - t, ln.LAUNCHES["layer_norm_fwd"],
                {k: ar.GRAPHS[k] - before[k] for k in before})
    wanted = ar.DecodeGraph.wanted
    ar.DecodeGraph.wanted = staticmethod(lambda *a: False)
    try:
        eager = decode(n_tokens)
    finally:
        ar.DecodeGraph.wanted = wanted
    graph = decode(n_tokens)
    g = graph[3]
    rep = dict(n=n_tokens, eager_s=eager[1], graph_s=graph[1],
               same=bool(torch.equal(eager[0], graph[0])),
               launches=(eager[2], graph[2]), graphs=g, profiled=None)
    if cuda:
        n_prof = min(PROFILED_TOKENS, n_tokens)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        replays = decode(n_prof, prof)[3]["replays"]
        rep["profiled"] = (n_prof, trace_kernels(prof, "layer_norm_fwd"),
                           replays)
    log(f"  {what}: fp32 decode of {n_tokens} tokens at temp 0, op by op "
        f"{eager[1]:.2f}s, as a CUDA graph a token {graph[1]:.2f}s; tokens "
        f"equal {rep['same']}; layer_norm_fwd wrapper launches {eager[2]} "
        f"and {graph[2]} (graphs {g})" + (
            f"; the graphed decode of {rep['profiled'][0]} tokens "
            f"({rep['profiled'][2]} replays) ran {rep['profiled'][1]} "
            f"layer_norm_fwd kernels of {per_step * rep['profiled'][0]} "
            f"(profiler trace)" if cuda else ""))
    if not rep["same"]:
        diff = int((eager[0] != graph[0]).sum())
        raise AssertionError(f"{what}: the graphed decode's tokens differ "
                             f"at {diff} of {eager[0].numel()}")
    if cuda and (eager[2] != per_step * n_tokens or graph[2] != per_step * (
            n_tokens - g["replays"] + g["captures"])):
        raise AssertionError(f"{what}: layer_norm_fwd wrapper launches "
                             f"{eager[2]} op by op, {graph[2]} graphed "
                             f"({g}), {per_step} a token step")
    if cuda and not (g["captures"] == 1 and g["replays"] > 0):
        raise AssertionError(f"{what}: the decode graph {g}")
    # the trace may lose kernel records (an H100 smoke run read 2303 of
    # 2304 and 1533 of 1536): fewer lost than the run's replays, so a graph
    # one LayerNorm short is still refused
    if cuda and not (per_step * rep["profiled"][0] - rep["profiled"][2]
                     < rep["profiled"][1] <= per_step * rep["profiled"][0]):
        raise AssertionError(f"{what}: the graphed decode of "
                             f"{rep['profiled'][0]} tokens ran "
                             f"{rep['profiled'][1]} layer_norm_fwd kernels, "
                             f"expected {per_step} a token")
    return rep


def run_recipes(seed, device, gen, songs, vq_ckpt, logdir):
    """Phase 9 (a), (b) and (d) (the trace of (a)). Returns {"a", "b"}:
    (a)'s report, and per labelled / lyric preset its full-depth step's
    and its cut run's."""
    cuda = torch.device(device).type == "cuda"
    log(f"phase 9 (a) upsampler: {UPS_HPS} at full depth for {UPS_STEPS} "
        f"steps over phase 8 (a)'s checkpoint, sampling at step 1, step 3 "
        f"traced")
    a = run_recipe("small_upsampler", seed, device, songs, logdir, UPS_STEPS,
                   graph_check=GRAPH_TOKENS, restore_vqvae=vq_ckpt)
    log_recipe("(a)", a)
    if cuda:
        torch.cuda.empty_cache()
    b = {}
    for preset in LABELLED_LENGTH:
        step = check_recipe_step(preset, seed, device, gen)
        log(f"phase 9 (b) {preset}: {step['n_depth']} layers at width "
            f"{step['width']}, n_ctx {step['n_ctx']}, "
            f"{step['n_params'] / 1e6:.1f} M params, "
            f"{step['n_flash_layers']} flash layers, built in "
            f"{step['build_s']:.1f}s; one step: loss {step['loss']:.6f} gn "
            f"{step['gn']:.6g}; against all plain: " + ", ".join(
                f"{k} {v:.3e}" for k, v in step["full"].items())
            + (" (tol " + ", ".join(f"{k} {RECIPE_TOL[k]:g}"
                                    for k in step["full"]) + ")")
            + "".join(f"; planted LayerNorm fault ({kind}): " + ", ".join(
                f"{k} {v:.3e}" for k, v in gaps.items())
                for kind, gaps in step["faults"].items())
            + ("; against flash alone plain: " + ", ".join(
                f"{k} {v:.3e}" for k, v in step["flash"].items())
               + f" (tol {LOSS_TOL:g}, {GN_TOL:g})" if "flash" in step
               else "") + f"; launches {step['launches']}")
        if cuda:
            torch.cuda.empty_cache()
        run = run_recipe(preset, seed, device, songs, logdir, LABELLED_STEPS,
                         prior_depth=CUT_DEPTH[preset])
        log_recipe(f"(b) {preset}", run)
        b[preset] = dict(step=step, run=run)
        if cuda:
            torch.cuda.empty_cache()
    return dict(a=a, b=b)


def log_recipe(label, r):
    for rec in r["records"]:
        log(f"  {label} step {rec['it']}: " + " ".join(
            f"{pk} {rec[k]:.5g}" for pk, k in train_mod.PRIOR_KEYS.items()
            if k in rec) + f" step_ok {rec['step_ok']} wall "
            f"{rec['wall_s']:.3f}s"
            + (f"; sample {rec['sample_s']:.1f}s" if "sample_s" in rec
               else ""))
    s = r["samples"][0]
    log(f"  {label} {r['n_depth']} layers at width {r['width']}, n_ctx "
        f"{r['n_ctx']}, {r['n_params'] / 1e6:.1f} M params"
        + (f", lyric encoder {r['encoder'][0]} layers at {r['encoder'][1]}"
           if r["encoder"] else "")
        + (f", conditioner {r['cond'][0]} layers at {r['cond'][1]}"
           if r["cond"] else "")
        + f"; run {r['wall_s']:.1f}s, peak memory {_gb(r['peak_mem_gb'])}"
        f", test loss {r['test']['loss']:.5g}; sample {s['wall_s']:.1f}s "
        f"({s['shape'][0]} x {s['shape'][1]} codes in [{s['codes'][0]}, "
        f"{s['codes'][1]}], {s['launches']['layer_norm_fwd']} LayerNorm "
        f"wrapper launches, decode graph {s['graphs']}); launches "
        f"{r['launches']} == expected {r['expected']}; "
        f"logs {r['logs']}"
        + (f"; trace {r['trace'][0]} bytes naming {r['trace'][1][:4]}"
           if "trace" in r else ""))


# LayerNorm shapes of phase 2c: the top prior's training rows (n_ctx 6144
# + 384 lyric tokens) in the training dtype, the upsamplers' width, a
# ragged shape, the 5b priors' width, a width whose rows the kernels read
# element by element (1001 fp16: 2002 bytes), and the widest row in fp32
# (four 16-byte vectors a thread)
LN_SHAPES = [(6528, 2048, torch.bfloat16), (6528, 1920, torch.float32),
             (1000, 1000, torch.bfloat16), (1024, 4800, torch.bfloat16),
             (1000, 1001, torch.float16), (2, 12288, torch.float32)]
SOURCES = {"decode_stack": ds, "flash_attention": fa, "layer_norm": ln,
           "adam": ad}
REPLACES = dict(
    dict.fromkeys(ds.LAUNCHES, "jukebox_tpu/ops/pallas/decode_stack.py:1092"),
    flash_fwd="jukebox_tpu/ops/pallas/flash_attention.py:202",
    flash_dq="jukebox_tpu/ops/pallas/flash_attention.py:260",
    flash_dkv="jukebox_tpu/ops/pallas/flash_attention.py:260",
    layer_norm_fwd="jukebox_tpu/ops/pallas/layer_norm.py:63",
    layer_norm_bwd="jukebox_tpu/ops/pallas/layer_norm.py:98",
    adam_update="jukebox_tpu/ops/pallas/adam.py:36")


# phase 2b at head dim 128: small_single_enc_dec_prior's f0 layer at its
# recipe's batch (bs 4 x 2 heads, n_ctx 6144 + 384 lyric tokens, width 1024,
# so n_state 256)
FLASH128 = dict(B=4, L=6528, S=256, H=2)


def check_flash_hd128(rows, device, gen):
    """Phase 2b at head dim 128 (FLASH128): the flash kernels' checks of
    check_flash, planted faults included, and their times; each kernel's
    row gets them under "hd128" and its max_abs_err the worse of both."""
    log(f"phase 2b flash kernels at head dim 128 "
        f"(small_single_enc_dec_prior's f0 layer, bs {FLASH128['B']})")
    for k, row in check_flash(device=device, gen=gen, **FLASH128).items():
        if k in rows:
            rows[k]["hd128"] = row
            rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"],
                                         row["max_abs_err"])
        else:
            rows[k] = row


# phase 2 at f4 (the summary pattern of attn orders 3 and 5) at the 1b top's
# widths: 64 blocks of 96, A 512 in 2 heads, so [B, 65, 512] caches
SUMMARY = dict(A=512, H=2, blocks=64, bc=96)


def summary_positions(sh):
    """f4 positions: just before, at and after a block's last token, and
    the last block's (the last token writes a summary nothing reads)."""
    bc, n = sh["bc"], sh["blocks"] * sh["bc"]
    return [0, bc - 2, bc - 1, bc, 2 * bc - 1, 5 * bc - 1, 5 * bc,
            n - bc - 1, n - bc, n - 2, n - 1]


def check_summary_attn(rows, B, device, gen, time_it=True, sh=SUMMARY):
    """ring_attn_decode at f4 against its plain version on [B, blocks + 1,
    A] caches at summary_positions: output and caches (the summary row
    written at a block's last token, nothing else); at every block end a
    planted fault, the summary written one row off, that the check must
    refuse; timed at the last block's last token (blocks live rows)
    beside its bound, the plain version and SDPA, under
    rows["ring_attn_decode"]["f4"]."""
    A, H, bc = sh["A"], sh["H"], sh["bc"]
    shape = (B, sh["blocks"] + 1, A)
    bf = torch.bfloat16
    rep = KernelReport()

    def rnd(*sz, dtype=bf):
        return torch.randn(sz, generator=gen, device=device).to(dtype)
    kc, vc = rnd(*shape), rnd(*shape)
    kc[:, 0] = vc[:, 0] = 0  # the zero pad
    for t in summary_positions(sh):
        geom = ds.ring_geometry(4, t, shape, bc)
        qkv32 = rnd(B, 3 * A, dtype=torch.float32)
        qkv = qkv32.to(bf)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out = ds.ring_attn_decode(qkv, k1, v1, geom, H, qkv32)
        ref = ds.ring_attn_decode_plain(qkv, k2, v2, geom, H, qkv32)
        what = f"f4 t={t} write {geom[1]} rows {geom[2]}+{geom[3]}"
        rep.check("ring_attn_decode", out, ref, what)
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise AssertionError(f"f4 t={t}: cache write differs")
        if geom[1] < 0:
            continue
        # the fault: the summary one row past its own (before it at the
        # last block's, whose row is the cache's last)
        off = 1 if geom[1] + 1 < geom[0] else -1
        bad = (geom[0], geom[1] + off, geom[2], geom[3])
        k3, v3 = kc.clone(), vc.clone()
        out3 = ds.ring_attn_decode(qkv, k3, v3, bad, H, qkv32)
        refuse("ring_attn_decode", torch.cat([out3, k3.flatten(1)], 1),
               torch.cat([ref, k2.flatten(1)], 1), f"{what} one row off")
    row = rep.rows["ring_attn_decode"]
    if time_it:
        # the last token: its summary written past the rows read
        t = sh["blocks"] * bc - 1
        geom = ds.ring_geometry(4, t, shape, bc)
        n, live = geom[3], B * geom[3] * A * 2 * 2

        def ring_set():
            q32 = rnd(B, 3 * A, dtype=torch.float32)
            return (q32.to(bf), rnd(*shape), rnd(*shape), geom, H, q32)
        sets = [ring_set() for _ in range(_copies(live))]
        lib_sets = [(heads(q_[:, :A], H),
                     heads(k_, H)[:, :, :n].contiguous(),
                     heads(v_, H)[:, :, :n].contiguous())
                    for q_, k_, v_, *_ in sets]
        row.update(rep.timed(
            "ring_attn_decode", f"f4 t={t} ({n} rows of {list(shape)})",
            device_ms(ds.ring_attn_decode, sets),
            device_ms(ds.ring_attn_decode_plain, sets),
            device_ms(F.scaled_dot_product_attention, lib_sets),
            live + B * A * 4 + B * 2 * A * 2 + 2 * B * A * 2 + B * A * 2,
            4 * B * n * A, "bf16"))
    main = rows.setdefault("ring_attn_decode", {"max_abs_err": 0.0})
    main["f4"] = row
    main["max_abs_err"] = max(main["max_abs_err"], row["max_abs_err"])
    return row


# ---------------------------------------------------------------------------
# phase 11: the summary pattern sampled (attn orders 3 and 5)
# ---------------------------------------------------------------------------

# the 1b_lyrics top at its widths (2048, 2 heads, n_ctx 6144 in 64 blocks of
# 96) under attn order 3 ([1, 4]) at 8 layers, one scan (1, 4) x 4 that the
# JAX package does not pack, and order 5 ([1, 4, 1, 1]) at 9, whose plan
# (flat 0, flat 1, scan (1,) x 3, flat 5, scan (1,) x 3) packs the seven f1
# layers and not the two f4 ones: int8 caches there, bf16 on the f4
# layers; conditioned on artist, genre and timing, no lyrics (orders 3 and
# 5 have no f7 layer): a context of P11_CONTEXT blocks prefilled,
# P11_DECODE blocks sampled, in bf16 and in the int8 mode
P11_PRIORS = {3: 8, 5: 9}
P11_HPS = "vqvae,prior_1b_lyrics"
P11_KW = dict(level=2, levels=3, labels=True, use_tokens=False,
              single_enc_dec=False, n_tokens=0, prime_loss_fraction=0.0,
              sample_length=6144 * 128, restore_prior="")
P11_CONTEXT, P11_DECODE = 2, 4
P11_META = dict(artist="unknown", genre="unknown", lyrics="",
                total_length=6144 * 128 * 3, offset=0)


def p11_logits(arm, dec, caches, x_tok, t, x_cond, y_cond, plain):
    """The logits [B, 1, bins] of one staged decode step at t (the decode
    loop's _decode_one), through the kernels or their plain versions."""
    h, cond = arm._emb_at(t, x_tok, x_cond, y_cond, x_tok.shape[0])
    h = arm.transformer.decode_step(dec, caches, h, t, fp16=True,
                                    plain=plain)
    if arm.add_cond_after_transformer:
        h = h + cond
    return arm._logits(h)


def p11_step_check(arm, dec, caches, x_tok, t, x_cond, y_cond, what):
    """The kernel path against the plain path at t on twin copies of the
    caches (left as they are), within STEP_TOL; its launches are put back
    out of the counts. Returns the relative error."""
    saved = dict(ds.LAUNCHES)
    twins = [[{k: c.clone() for k, c in cache.items()} for cache in caches]
             for _ in range(2)]
    lk = p11_logits(arm, dec, twins[0], x_tok, t, x_cond, y_cond, False)
    lp = p11_logits(arm, dec, twins[1], x_tok, t, x_cond, y_cond, True)
    ds.LAUNCHES.update(saved)
    e, rel = _err(lk, lp)
    log(f"  {what} t={t}: kernel path against plain, max logit err "
        f"{e:.3e} (rel {rel:.2e}, tol {STEP_TOL:g})")
    if not (torch.isfinite(lk).all() and rel <= STEP_TOL):
        raise AssertionError(f"phase 11 {what} t={t}: kernel-path decode "
                             f"step disagrees with the plain path ({e:.3e})")
    return rel


def p11_sample(runtime, ctx, y, quantize, seed, what):
    """One window through the PriorRuntime pieces: sample_init (the
    context prefilled, one block a chunk), sample_segment to just before
    the first sampled block's last token, the kernel path held to the
    plain path there and at the first step, the rest of P11_DECODE
    blocks, sample_finish. The decode and LayerNorm kernels' launches are
    counted from 0 over the window and must equal the steps' and chunks'
    expected counts; the int8 mode's caches int8 on the packed layers
    alone."""
    m = runtime.model
    arm, tr = m.prior, m.prior.transformer
    B, t0 = ctx.shape
    bc = arm.block_ctx
    n = P11_DECODE * bc
    cuda = ctx.is_cuda
    quant, cache_int8 = runtime.stage_decode(quantize=quantize)
    dec = runtime.staged
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    rep = {"checks": 0}

    def sync():
        if cuda:
            torch.cuda.synchronize()
    ds.reset_launches()
    ln.reset_launches()
    sync()
    w0 = time.time()
    caches, x_tok, x_cond, y_cond = m.sample_init(
        B, z=ctx, y=y, fp16=True, dec_params=dec, int8=cache_int8)
    sync()
    rep["prefill_s"] = time.time() - w0
    int8_layers = {d for d, c in enumerate(caches)
                   if c["k"].dtype == torch.int8}
    if int8_layers != (set(tr.packed) if cache_int8 else set()):
        raise AssertionError(f"phase 11 {what}: int8 caches on layers "
                             f"{sorted(int8_layers)}, packed "
                             f"{sorted(tr.packed)}")
    rep["int8_layers"] = sorted(int8_layers)
    rep["rel"] = [p11_step_check(arm, dec, caches, x_tok, t0, x_cond,
                                 y_cond, what)]
    w1 = time.time()
    first, _ = m.sample_segment(caches, x_tok, t0, bc - 1, gen, x_cond,
                                y_cond, fp16=True, temp=TEMP,
                                dec_params=dec)
    x_tok = first[:, -1:]
    rep["rel"].append(p11_step_check(arm, dec, caches, x_tok,
                                     t0 + bc - 1, x_cond, y_cond, what))
    rest, _ = m.sample_segment(caches, x_tok, t0 + bc - 1, n - bc + 1, gen,
                               x_cond, y_cond, fp16=True, temp=TEMP,
                               dec_params=dec)
    sync()
    rep["decode_s"] = time.time() - w1
    rep["checks"] = 2
    out = m.sample_finish(torch.cat([first, rest], 1), z=ctx)
    if not (out.shape == (B, t0 + n) and torch.equal(out[:, :t0], ctx)
            and int(out.min()) >= 0 and int(out.max()) < m.l_bins):
        raise AssertionError(f"phase 11 {what}: the window's codes are "
                             f"wrong: {tuple(out.shape)}")
    per = step_launches(tr, bool(quant), cache_int8)
    rep["expected"] = {k: n * v for k, v in per.items()}
    rep["ln_expected"] = {"layer_norm_fwd": 2 * tr.n_depth * (t0 // bc),
                          "layer_norm_bwd": 0}
    rep["launches"] = dict(ds.LAUNCHES)
    rep["ln_launches"] = dict(ln.LAUNCHES)
    if cuda and (rep["launches"] != rep["expected"]
                 or rep["ln_launches"] != rep["ln_expected"]):
        raise AssertionError(f"phase 11 {what}: launches "
                             f"{rep['launches']}, {rep['ln_launches']} "
                             f"against {rep['expected']}, "
                             f"{rep['ln_expected']}")
    rep["tokens"] = n
    return rep


def run_phase11(seed, device, B=N_SAMPLES, cases=None, **over):
    """Phase 11: each prior of P11_PRIORS (order: depth) drawn from seed at
    the 1b top's widths (over: hparams over them), one window sampled in
    bf16 and in the int8 mode (p11_sample). Returns {what: report} and
    their launches summed."""
    cases = P11_PRIORS if cases is None else cases
    out = {"launches": dict.fromkeys(ds.LAUNCHES, 0),
           "ln_launches": dict.fromkeys(ln.LAUNCHES, 0)}
    vq = None
    for order, depth in cases.items():
        hps = setup_hparams(P11_HPS, dict(P11_KW, attn_order=order,
                                          prior_depth=depth, seed=seed,
                                          **over))
        vq = vq or make_vqvae(hps, device)
        runtime = make_prior(hps, vq, device)
        tr = runtime.model.prior.transformer
        bc = tr.blocks[0].attn.block_ctx
        gen = torch.Generator(device=device).manual_seed(seed + order)
        ctx = torch.randint(0, runtime.l_bins, (B, P11_CONTEXT * bc),
                            generator=gen, device=device)
        y = torch.as_tensor(runtime.get_y(runtime.labeller.get_batch_labels(
            [P11_META] * B), 0), device=device)
        funcs = [tr.attn_func(d) for d in range(tr.n_depth)]
        log(f"phase 11 attn order {order} at {depth} layers (width "
            f"{tr.n_in}, {tr.n_head} heads, n_ctx {tr.n_ctx}, {bc}-token "
            f"blocks): funcs {funcs}, plan {tr.decode_plan}, packed "
            f"{sorted(tr.packed)}")
        for quantize in (None, "int8"):
            what = f"order {order} {quantize or 'bf16'}"
            r = p11_sample(runtime, ctx, y, quantize, seed + order, what)
            for k in ("launches", "ln_launches"):
                for name, v in r[k].items():
                    out[k][name] += v
            log(f"  {what}: prefill {ctx.shape[1]} tokens x {B} in "
                f"{r['prefill_s']:.3f}s, {r['tokens']} tokens x {B} in "
                f"{r['decode_s']:.3f}s "
                f"({r['decode_s'] / r['tokens'] * 1e3:.2f} ms a step), int8 "
                f"caches on layers {r['int8_layers']}; "
                f"launches {({k: v for k, v in r['launches'].items() if v})}"
                f" == expected; LayerNorm "
                f"{r['ln_launches']['layer_norm_fwd']}")
            out[what] = r
        runtime.release()
        del runtime
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: training and decoding across ranks (parallel/)
# ---------------------------------------------------------------------------

P10_BS = 2           # the data-parallel parts' global batch (1 a rank)
# phase 10's depth: 48 of the top's 72 layers at its width, the f0 layer
# (flash) at 47 kept: (b)'s time grows with the depth (gloo's collectives
# through the host, ~1.6 s a layer at 72), and with it the whole smoke
# stays near 1000 s of its 1200
P10_DEPTH = 48
P10_TOKENS = 64      # forced tokens of the tensor-parallel decode, bf16
P10_INT8_TOKENS = 16  # and int8
P10_DECODE_B = 2     # its batch
P10_SAMPLE = 256     # elements compared of each updated tensor
# a placed step against world 1's on the same weights and global batch:
# the loss and the gradient norm relative, the updated params normwise
# over the compared elements against how far the step moved them (Adam's
# first step moves an element by about lr whatever its gradient's size, so
# an element whose gradient the bf16 noise of another batch split flips
# moves the other way)
P10_TOL = {"loss": 1e-4, "gn": 1e-3, "params": 2e-2}
P10_TIMEOUT = 300
P10_BIAS = 0.3       # std of the biases drawn (p10_biases)
# the dp step with dropout and aug_blend on (part dp_drop): the dropout
# rates of the priors' training hparams, and the step's seed
P10_DROP = dict(attn_dropout=0.1, resid_dropout=0.1, emb_dropout=0.1)
P10_DROP_SEED = 5
# the 1-head upsampler of parts up_mp and up_decode (mp does not divide its
# heads: each rank runs its attention whole): upsampler_level_1 at its
# widths (1920, 1 head, its 16-layer conditioner at 1024, n_ctx 8192), cut
# to P10_UP_DEPTH layers
P10_UP_HPS = "vqvae,upsampler_level_1,all_fp16,cpu_ema"
P10_UP_KW = dict(level=1, levels=3, prior=True, train=True, labels=True,
                 sample_length=8192 * 32, restore_prior="")
P10_UP_DEPTH = 8
# the parts of (b), each across its two ranks, and the mesh axis the ranks
# split
P10_PARTS = {"dp": "dp", "fsdp": "dp", "mp": "mp", "decode": "mp",
             "decode_int8": "mp", "dp_drop": "dp", "up_mp": "mp",
             "up_decode": "mp"}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def p10_biases(model, seed):
    """Every bias of model drawn from seed, N(0, P10_BIAS^2) on the host in
    name order: the init leaves them 0, and a bias of 0 hides where a
    row-split product's bias is added (once, after the all-reduce)."""
    gen = torch.Generator().manual_seed(seed + 11)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=gen) * P10_BIAS)


def p10_runtime(seed, bs, device, **over):
    """(hps, runtime): phase 5's top prior drawn from seed (its biases
    too, p10_biases), bs a process."""
    hps = train_hps(seed, bs=bs, **over)
    runtime = make_prior(hps, make_vqvae(hps, device), device)
    p10_biases(runtime.model, seed)
    return hps, runtime


def p10_up_hps(**up_over):
    """The upsampler's hparams: P10_UP_KW at P10_UP_DEPTH layers, up_over
    over them."""
    return setup_hparams(P10_UP_HPS, {**P10_UP_KW,
                                      "prior_depth": P10_UP_DEPTH,
                                      **up_over})


def p10_up_runtime(seed, bs, device, **up_over):
    """(hps, runtime): the P10_UP_HPS upsampler drawn from seed (its biases
    too), bs a process."""
    hps = p10_up_hps(bs=bs, seed=seed, **up_over)
    runtime = make_prior(hps, make_vqvae(hps, device), device)
    p10_biases(runtime.model, seed)
    return hps, runtime


def p10_batch(runtime, hps, device, seed, stereo=False):
    """Phase 10's global batch of P10_BS rows, the same in every process;
    stereo: the audio [P10_BS, T, 2] before audio_preprocess blends it."""
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    x, y = train_batch(runtime, Hyperparams(dict(hps), bs=P10_BS), device,
                       gen)
    if stereo:
        x = torch.cat([x, (0.3 * torch.randn(x.shape, generator=gen,
                                             device=device)).clamp(-1, 1)],
                      -1)
    return x, y


def p10_blend(x, hps, seed, rows=None):
    """audio_preprocess of P10_BS rows of stereo audio (x: those in rows,
    or all) with aug_blend's mix drawn for the global batch from seed."""
    gen = torch.Generator(device=x.device).manual_seed(seed + 12)
    return audio_preprocess(x, hps, gen=gen, rows=rows,
                            total=None if rows is None else P10_BS)


def p10_samples(named):
    """{name: P10_SAMPLE evenly spaced elements of the tensor} on the
    host."""
    out = {}
    for n, t in named.items():
        flat = t.detach().reshape(-1)
        idx = torch.linspace(0, flat.numel() - 1, min(flat.numel(),
                                                      P10_SAMPLE),
                             device=flat.device).long()
        out[n] = flat[idx].float().cpu()
    return out


def p10_state_bytes(runtime, opt):
    return sum(t.numel() * t.element_size() for d in
               (runtime.params, opt["m"], opt["v"]) for t in d.values())


def p10_step(runtime, hps, x, y, seed=None):
    """One train step (loss scale 1, fresh Adam state; seed: its dropout
    seed) of the runtime, placed or not: its loss, gradient norm, wall,
    the bytes of params + m + v the rank holds, its kernel launches, and
    samples of the updated tensors (the rank's pieces)."""
    opt = train_mod.adam_init(runtime.params, fp16_state=hps.fp16_opt)
    step = train_mod.make_prior_train_step(
        runtime, hps, train_mod.make_lr_schedule(hps))
    cuda = x.is_cuda
    reset_training_launches()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss, m = step(opt, (x, y), seed, 1, 1.0)
    if cuda:
        torch.cuda.synchronize()
    return dict(loss=float(loss), gn=float(m["gn"]), ok=bool(m["step_ok"]),
                wall_s=time.time() - t0,
                state_bytes=p10_state_bytes(runtime, opt),
                peak_gb=_peak_gb(cuda), launches=training_launches(),
                samples=p10_samples(runtime.params))


def p10_layout(runtime):
    """How the rank's pieces lie in the whole tensors (p10_piece)."""
    pl = runtime.placement
    mesh = pl.mesh
    return dict(split=dict(pl.split), dp_axes=dict(pl.dp_axes),
                mesh=(mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank))


def p10_piece(full, name, layout):
    """The piece of a whole tensor that the rank of `layout` holds."""
    from jukebox_tpu_torch.parallel.dist import mp_slice
    dp, mp, dp_rank, mp_rank = layout["mesh"]
    t = full
    if name in layout["split"]:
        axis, parts = layout["split"][name]
        t = mp_slice(t, axis, parts, mp, mp_rank)
    ax = layout["dp_axes"][name]
    if ax is not None:
        t = t.chunk(dp, ax)[dp_rank]
    return t


def p10_gaps(out, ref, start, moved_ref, layout=None):
    """out's loss, gn and sampled params against world 1's (ref: its
    result, moved_ref: its updated params whole, start: the weights
    before the step, both on the host)."""
    gaps = {"loss": abs(out["loss"] - ref["loss"]) / abs(ref["loss"]),
            "gn": abs(out["gn"] - ref["gn"]) / ref["gn"]}
    diff = moved = 0.0
    equal = 0
    for n, got in out["samples"].items():
        want, w0 = moved_ref[n], start[n]
        if layout is not None:
            want, w0 = p10_piece(want, n, layout), p10_piece(w0, n, layout)
        want, w0 = p10_samples({n: want})[n], p10_samples({n: w0})[n]
        diff += float(((got - want) ** 2).sum())
        moved += float(((want - w0) ** 2).sum())
        equal += bool(torch.equal(got, want))
    gaps["params"] = math.sqrt(diff) / max(math.sqrt(moved), 1e-30)
    gaps["equal tensors"] = (equal, len(out["samples"]))
    return gaps


def p10_check(what, gaps):
    log(f"  {what}: loss {gaps['loss']:.3e} (tol {P10_TOL['loss']:g}), gn "
        f"{gaps['gn']:.3e} (tol {P10_TOL['gn']:g}), params "
        f"{gaps['params']:.3e} of the step's move (tol "
        f"{P10_TOL['params']:g}); {gaps['equal tensors'][0]} of "
        f"{gaps['equal tensors'][1]} tensors' compared elements equal bit "
        f"for bit")
    bad = [k for k in P10_TOL if not gaps[k] <= P10_TOL[k]]
    if bad:
        raise AssertionError(f"phase 10 {what} disagrees with world 1: {bad}")


def p10_decode(runtime, y, device, quantize=None, x=None):
    """Logits [B, n, bins] of the prior's kernel path (bf16 staged, or
    with quantize="int8" int8 weights and caches; one decode step a token)
    on its stream's first n tokens forced (P10_TOKENS, int8
    P10_INT8_TOKENS), and the decode kernels' launches; under a Megatron
    split every rank's staged pieces, heads and caches. The top's stream
    is y's lyrics, then zeros; an upsampler's the codes of audio x [B, T,
    1] at its level, conditioned on those of the level above."""
    m = runtime.model
    arm = m.prior
    B = y.shape[0]
    with torch.no_grad():
        if m.single_enc_dec:
            x_cond, y_cond, prime = m.get_cond(None, y)
            z = torch.zeros((B, m.n_ctx), dtype=torch.long, device=device)
            stream, x_cond = m.prior_preprocess([prime, z], [None, x_cond])
        else:
            stream, *z_conds = runtime.encode(x, end_level=m.level + 2)
            x_cond, y_cond, _ = m.get_cond(z_conds, y)
        x_cond = x_cond.to(torch.bfloat16)
        dec = arm.transformer.prepare_decode_params(torch.bfloat16,
                                                    quantize=quantize)
        caches = arm.init_decode_caches(B, device, fp16=True,
                                        dec_params=dec, int8=bool(quantize))
        cache_bytes = sum(t.numel() * t.element_size() for c in caches
                          for t in c.values())
        kv_bytes = sum(c[k].numel() * c[k].element_size() for c in caches
                       for k in ("k", "v"))
        ds.reset_launches()
        x_tok = torch.zeros((B, 1), dtype=torch.long, device=device)
        logits = []
        t0 = time.time()
        for t in range(P10_INT8_TOKENS if quantize else P10_TOKENS):
            logits.append(arm._decode_one(dec, caches, x_tok, t, x_cond,
                                          y_cond, True, B)[:, 0].float())
            x_tok = stream[:, t:t + 1]
        if stream.is_cuda:
            torch.cuda.synchronize()
    return dict(logits=torch.stack(logits, 1).cpu(), cache_bytes=cache_bytes,
                kv_bytes=kv_bytes, launches=dict(ds.LAUNCHES),
                wall_s=time.time() - t0)


@contextlib.contextmanager
def p10_world_one(device):
    """A process group of one rank in this process (NCCL on the card,
    gloo on the CPU), through setup_dist's variables."""
    import torch.distributed as dist
    from jukebox_tpu_torch.parallel.dist import make_mesh, setup_dist
    env = dict(JAX_COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        setup_dist(device)
        yield make_mesh(1, 1, device), dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def p10_rank(spec_path):
    """One rank of phase 10 (b) (`chip_smoke.py --p10-rank`): every part
    of spec, each on a fresh prior from the seed; writes rank_<r>.pt beside
    spec. A collective that fails fails the rank, and with it the
    phase."""
    from jukebox_tpu_torch.parallel.dist import (dp_rows, make_mesh,
                                                 setup_dist)
    from jukebox_tpu_torch.parallel.placement import Placement
    faulthandler.dump_traceback_later(P10_TIMEOUT, exit=True)
    with open(spec_path) as f:
        spec = json.load(f)
    device, seed, over = spec["device"], spec["seed"], spec["over"]
    up_over = spec["up_over"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    rank, world = setup_dist(device)
    device = f"cuda:{torch.cuda.current_device()}" if device == "cuda" \
        else device
    out = {"rank": rank, "world": world, "start_s": time.time() - t0,
           "parts": {}}
    meshes = {"dp": make_mesh(world, 1, device),
              "mp": make_mesh(1, world, device)}
    for part in spec["parts"]:
        t1 = time.time()
        mesh = meshes[P10_PARTS[part]]
        drop = part == "dp_drop"
        if part.startswith("up"):
            hps, runtime = p10_up_runtime(seed, 1, device, **up_over)
        else:
            hps, runtime = p10_runtime(seed, 1, device, **over,
                                       **(P10_DROP if drop else {}))
        x, y = p10_batch(runtime, hps, device, seed, stereo=drop)
        # a data-parallel rank's row as the loader deals it; bs 1 at mp
        rows = dp_rows(1, mesh) if P10_PARTS[part] == "dp" else [0]
        runtime.placement = Placement(runtime.model, mesh,
                                      fsdp=part == "fsdp")
        if "decode" in part:
            r = p10_decode(runtime, y[:P10_DECODE_B], device,
                           "int8" if part == "decode_int8" else None,
                           x=x[:P10_DECODE_B])
        else:
            xr = p10_blend(x[rows], hps, seed, rows) if drop else x[rows]
            r = p10_step(runtime, hps, xr, y[rows],
                         P10_DROP_SEED if drop else None)
            r["layout"] = p10_layout(runtime)
        r["part_s"] = time.time() - t1
        out["parts"][part] = r
        del runtime
        if device != "cpu":
            torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.destroy_process_group()
    torch.save(out, os.path.join(os.path.dirname(spec_path),
                                 f"rank_{rank}.pt"))
    faulthandler.cancel_dump_traceback_later()


def p10_launch(workdir, world, device):
    """Run `world` ranks of p10_rank over gloo (JUKEBOX_DIST_BACKEND) and
    read their results; any rank failing or outliving P10_TIMEOUT fails
    the phase, and every rank is stopped."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r),
                   JUKEBOX_DIST_BACKEND="gloo")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--p10-rank",
             os.path.join(workdir, "spec.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=P10_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 10 rank {r} failed "
                                 f"({p.returncode}):\n{text[-3000:]}")
    return [torch.load(os.path.join(workdir, f"rank_{r}.pt"),
                       weights_only=False) for r in range(world)]


def run_phase10(seed, device, world=2, up_over=None, **over):
    """Phase 10: world 1's references on one set of weights (phase 5's top
    prior drawn from seed, bs 2 and bs 1 steps, the bf16 decode of
    P10_TOKENS forced tokens; the bs 2 step with dropout and aug_blend;
    the P10_UP_HPS upsampler's bs 1 step and decode, up_over its hparams
    over P10_UP_KW's), (a) the ZeRO-3 step at dp=1 in this process over a
    process group of one (NCCL on the card), (b) `world` ranks over gloo
    started from here: dp, ZeRO-3 dp, dp with dropout and aug_blend and mp
    steps against world 1, the tensor-parallel decode's logits (bf16,
    int8) within STEP_TOL, and the upsampler split over mp (its heads
    whole on every rank) likewise. Returns the report (its kernel
    launches among it)."""
    up_over = dict(up_over or {})
    from jukebox_tpu_torch.parallel.placement import Placement
    t0 = time.time()
    cuda = torch.device(device).type == "cuda"

    def host(named):
        return {n: t.detach().float().cpu().clone() for n, t in
                named.items()}

    def free():
        if cuda:
            torch.cuda.empty_cache()
    rep = {"launches": {}}
    hps, runtime = p10_runtime(seed, P10_BS, device, **over)
    x, y = p10_batch(runtime, hps, device, seed)
    start = host(runtime.params)
    ref2 = p10_step(runtime, hps, x, y)
    moved2 = host(runtime.params)
    del runtime
    free()
    hps1, runtime = p10_runtime(seed, 1, device, **over)
    ref1 = p10_step(runtime, hps1, x[:1], y[:1])
    moved1 = host(runtime.params)
    del runtime
    free()
    _, runtime = p10_runtime(seed, 1, device, **over)
    dec_refs = {"decode": p10_decode(runtime, y[:P10_DECODE_B], device),
                "decode_int8": p10_decode(runtime, y[:P10_DECODE_B], device,
                                          "int8")}
    dec_ref = dec_refs["decode"]
    del runtime
    free()
    # dropout and aug_blend: the global batch's masks and mix
    hps_d, runtime = p10_runtime(seed, P10_BS, device, **over, **P10_DROP)
    xs, y_d = p10_batch(runtime, hps_d, device, seed, stereo=True)
    start_d = host(runtime.params)
    ref_d = p10_step(runtime, hps_d, p10_blend(xs, hps_d, seed), y_d,
                     P10_DROP_SEED)
    moved_d = host(runtime.params)
    del runtime
    free()
    # the 1-head upsampler
    hps_u, runtime = p10_up_runtime(seed, 1, device, **up_over)
    xu, yu = p10_batch(runtime, hps_u, device, seed)
    start_u = host(runtime.params)
    ref_u = p10_step(runtime, hps_u, xu[:1], yu[:1])
    moved_u = host(runtime.params)
    del runtime
    free()
    _, runtime = p10_up_runtime(seed, 1, device, **up_over)
    dec_refs["up_decode"] = p10_decode(runtime, yu[:P10_DECODE_B], device,
                                       x=xu[:P10_DECODE_B])
    del runtime
    free()
    up_desc = p10_up_hps(**up_over)
    log(f"phase 10 world 1, the dropout step (rates {P10_DROP}, aug_blend, "
        f"bs {P10_BS}): loss {ref_d['loss']:.6f} gn {ref_d['gn']:.6g} "
        f"{ref_d['wall_s'] * 1e3:.1f} ms; the upsampler "
        f"({up_desc.prior_depth} layers, width {up_desc.prior_width}, "
        f"{up_desc.heads} head, n_ctx {up_desc.n_ctx}): bs 1 step loss "
        f"{ref_u['loss']:.6f} gn {ref_u['gn']:.6g} "
        f"{ref_u['wall_s'] * 1e3:.1f} ms; decode of {P10_TOKENS} tokens "
        f"bf16 {dec_refs['up_decode']['wall_s']:.2f}s, caches "
        f"{_gb(dec_refs['up_decode']['cache_bytes'] / 1e9)}")
    tr_desc = train_hps(seed, **over)
    log(f"phase 10 world 1 on one set of weights ({tr_desc.prior_depth} "
        f"layers, width {tr_desc.prior_width}, n_ctx {tr_desc.n_ctx}): bs "
        f"{P10_BS} step loss "
        f"{ref2['loss']:.6f} gn {ref2['gn']:.6g} {ref2['wall_s'] * 1e3:.1f} "
        f"ms; bs 1 step loss {ref1['loss']:.6f} gn {ref1['gn']:.6g} "
        f"{ref1['wall_s'] * 1e3:.1f} ms, params + m + v "
        f"{_gb(ref1['state_bytes'] / 1e9)}; decode of {P10_TOKENS} tokens "
        f"bf16 {dec_ref['wall_s']:.2f}s, caches "
        f"{_gb(dec_ref['cache_bytes'] / 1e9)}; {P10_INT8_TOKENS} int8 "
        f"{dec_refs['decode_int8']['wall_s']:.2f}s, caches "
        f"{_gb(dec_refs['decode_int8']['cache_bytes'] / 1e9)}")

    # (a) ZeRO-3 at dp=1 over a process group of one, in this process
    with p10_world_one(device) as (mesh, backend):
        _, runtime = p10_runtime(seed, 1, device, **over)
        runtime.placement = Placement(runtime.model, mesh, fsdp=True)
        out_a = p10_step(runtime, hps1, x[:1], y[:1])
        del runtime
        free()
    gaps = p10_gaps(out_a, ref1, start, moved1)
    log(f"phase 10 (a) fsdp=True, mesh_dp=1 over {backend} (world 1): loss "
        f"{out_a['loss']:.6f} gn {out_a['gn']:.6g}, "
        f"{out_a['wall_s'] * 1e3:.1f} ms against {ref1['wall_s'] * 1e3:.1f};"
        f" params + m + v {_gb(out_a['state_bytes'] / 1e9)}, peak "
        f"{_gb(out_a['peak_gb'])} against {_gb(ref1['peak_gb'])}; launches "
        f"{out_a['launches']}")
    p10_check("(a) against the unsharded step", gaps)
    rep["a"] = dict(out_a, gaps=gaps)
    rep["launches"] = dict(out_a["launches"])

    # (b) world ranks over gloo
    workdir = tempfile.mkdtemp(prefix="jukebox_p10_")
    try:
        with open(os.path.join(workdir, "spec.json"), "w") as f:
            json.dump(dict(device=device, seed=seed, over=over,
                           up_over=up_over, parts=list(P10_PARTS)), f)
        t1 = time.time()
        ranks = p10_launch(workdir, world, device)
        rep["b_wall_s"] = time.time() - t1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 10 (b) {world} ranks over gloo on {device}: "
        f"{rep['b_wall_s']:.1f}s (rank start {ranks[0]['start_s']:.1f}s)")
    refs = {"dp": (ref2, moved2, start), "fsdp": (ref2, moved2, start),
            "mp": (ref1, moved1, start), "dp_drop": (ref_d, moved_d, start_d),
            "up_mp": (ref_u, moved_u, start_u)}
    rep["b"] = {}
    for part in P10_PARTS:
        got = [r["parts"][part] for r in ranks]
        for r in got:
            for k, v in r["launches"].items():
                rep["launches"][k] = rep["launches"].get(k, 0) + v
        if "decode" in part:
            dec_ref = dec_refs[part]
            e, rel = _err(got[0]["logits"], dec_ref["logits"])
            same = all(torch.equal(g["logits"], got[0]["logits"])
                       for g in got)
            log(f"phase 10 (b) {part} at mp={world}: "
                f"{dec_ref['logits'].shape[1]} forced "
                f"tokens x {P10_DECODE_B} rows, max logit err {e:.3e} (rel "
                f"{rel:.2e}, tol {STEP_TOL:g}) against world 1's kernel "
                f"path; ranks equal {same}; caches a rank "
                f"{_gb(got[0]['cache_bytes'] / 1e9)} against "
                f"{_gb(dec_ref['cache_bytes'] / 1e9)}; "
                f"{got[0]['wall_s']:.2f}s against {dec_ref['wall_s']:.2f}s;"
                f" launches a rank "
                + "; ".join(str({k: v for k, v in g["launches"].items()
                                 if v}) for g in got))
            if not (torch.isfinite(got[0]["logits"]).all() and same
                    and rel <= STEP_TOL):
                raise AssertionError("phase 10 tensor-parallel decode "
                                     "disagrees with world 1")
            # the heads split: 1/mp of the caches; the upsampler's one
            # head runs whole on every rank, its caches whole
            share = 1 if part == "up_decode" else world
            if any(g["kv_bytes"] * share != dec_ref["kv_bytes"]
                   for g in got):
                raise AssertionError(f"phase 10 {part}: a rank's K/V caches "
                                     f"are not 1/{share} of world 1's")
            kinds = (("ring_attn_int8", "gemv_int8", "ln_gemv_int8")
                     if part == "decode_int8" else
                     ("ring_attn_decode", "gemv_bf16", "ln_gemv_bf16"))
            if cuda and not all(g["launches"][k] for g in got
                                for k in kinds):
                raise AssertionError("phase 10: the decode kernels did not "
                                     "run on every rank")
            rep["b"][part] = dict(err=e, rel=rel, cache_bytes=[
                g["cache_bytes"] for g in got], wall_s=got[0]["wall_s"],
                launches=[g["launches"] for g in got])
            continue
        ref, moved, start_p = refs[part]
        ref_bytes = (ref_u if part == "up_mp" else ref1)["state_bytes"]
        log(f"phase 10 (b) {part}: " + "; ".join(
            f"rank {i}: loss {g['loss']:.6f} gn {g['gn']:.6g} step "
            f"{g['wall_s'] * 1e3:.1f} ms, params + m + v "
            f"{_gb(g['state_bytes'] / 1e9)} ({g['state_bytes'] / ref_bytes:.3f} "
            f"of world 1's), peak {_gb(g['peak_gb'])}"
            for i, g in enumerate(got)))
        for i, g in enumerate(got):
            p10_check(f"(b) {part} rank {i} against world 1 at global bs "
                      f"{P10_BS if P10_PARTS[part] == 'dp' else 1}",
                      p10_gaps(g, ref, start_p, moved, g["layout"]))
        if part == "fsdp" and not all(
                g["state_bytes"] <= 0.55 * ref_bytes for g in got):
            raise AssertionError("phase 10: fsdp ranks hold more than 0.55 "
                                 "of world 1's params + m + v")
        rep["b"][part] = dict(loss=[g["loss"] for g in got],
                              gn=[g["gn"] for g in got],
                              wall_s=[g["wall_s"] for g in got],
                              state_bytes=[g["state_bytes"] for g in got],
                              ref_bytes=ref_bytes)
    rep["wall_s"] = time.time() - t0
    log(f"phase 10 done in {rep['wall_s']:.1f}s; launches {rep['launches']}")
    return rep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of sampling")
    p.add_argument("--p10-rank", metavar="SPEC", default=None,
                   help="run one rank of phase 10 (b) (started by phase 10)")
    args = p.parse_args(argv)
    if args.p10_rank is not None:
        return p10_rank(args.p10_rank)
    name, count = phase_device()
    phase_build()
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t = time.time()
    hps = Hyperparams(n_samples=N_SAMPLES, sample_length=SAMPLE_LENGTH,
                      sr=44100, hop_fraction=HOPS, seed=args.seed,
                      name=tempfile.mkdtemp(prefix="jukebox_smoke_"))
    vqvae, priors = make_model("1b_lyrics", hps, device, prior_overrides=[
        {"prior_depth": UPS_DEPTH}, {"prior_depth": UPS_DEPTH}, {}])
    n_fp16 = round_dense_fp16(priors)
    torch.cuda.synchronize()
    log(f"models: 1b_lyrics drawn from seed {args.seed} in "
        f"{time.time() - t:.1f}s, depths "
        f"{[p.model.prior.transformer.n_depth for p in priors]}, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; {n_fp16} dense "
        f"weights rounded to fp16 values (phase 4c)")

    skw = [dict(temp=TEMP, fp16=True, chunk_size=256,
                max_batch_size=N_SAMPLES) for _ in priors]
    top = priors[-1]
    shapes = {"top": prior_shapes(top), "upsampler": prior_shapes(priors[0]),
              "5b top": preset_shapes("prior_5b_lyrics")}
    last_t = {"top": top.n_tokens + hps.sample_length // top.raw_to_tokens - 1,
              "upsampler": priors[0].n_ctx - 1,
              "5b top": shapes["5b top"]["n_ctx"] - 1}
    log("phase 2 kernels against their plain versions")
    rows = check_kernels(shapes, N_SAMPLES, last_t, device, gen)
    log("phase 2 ring_attn_decode at f4 (the summary pattern) against its "
        "plain version")
    check_summary_attn(rows, N_SAMPLES, device, gen)
    log("phase 2e int8 and cross-attention kernels against their plain "
        "versions")
    rows.update(check_int8_kernels(
        {k: shapes[k] for k in ("5b top", "upsampler", "top")}, N_SAMPLES,
        last_t, device, gen))
    log("phase 2b flash kernels against their plain versions")
    tr = top.model.prior.transformer
    rows.update(check_flash(1, tr.n_ctx, tr.blocks[0].attn.n_state,
                            tr.n_head, device, gen))
    check_flash_hd128(rows, device, gen)
    log("phase 2c LayerNorm kernels against their plain versions")
    rows.update(check_layer_norm(LN_SHAPES, device, gen))

    for prior in (top, priors[0]):
        check_stack_step(prior, N_SAMPLES, device, gen)
    log(f"phase 11 the summary pattern sampled: attn orders "
        f"{sorted(P11_PRIORS)} at the 1b top's widths, {P11_CONTEXT} blocks "
        f"of context, {P11_DECODE} sampled, bf16 and int8")
    r11 = run_phase11(args.seed, device)
    torch.cuda.empty_cache()

    log(f"phase 4 cascade: hop fractions {HOPS}, {N_SAMPLES} x "
        f"{hps.sample_length} samples "
        f"({hps.sample_length / hps.sr:.2f} s), temp {TEMP}, the sequential "
        f"scheduler with the inline finalize")
    rep = run_cascade(priors, hps, skw, sequential=True)
    log_cascade(rep, "1b_lyrics")
    log("phase 4c upstream: phase 4's models as upstream .pth.tar files")
    rep4c = run_upstream(vqvae, priors, hps, rep, args.seed, device)
    rep4b = run_primed(priors, hps, args.seed)

    shutil.rmtree(hps.name, ignore_errors=True)
    del vqvae, priors, top, tr, prior
    torch.cuda.empty_cache()
    run_golden(args.seed, device)
    torch.cuda.empty_cache()
    rep5 = run_5b_lyrics(args.seed, device, gen)

    log("phase 2d Adam kernel against its plain version (on the top "
        "prior's parameters), then phase 5")
    p5 = check_train_step(args.seed, device, gen, rows=rows)
    torch.cuda.empty_cache()
    log(f"phase 6 train.run: {TRAIN_STEPS} steps of the top prior, "
        f"{TRAIN_HPS}, host EMA every {CPU_EMA_FREQ} steps, a checkpoint "
        f"and a sample at step 1")
    logdir = tempfile.mkdtemp(prefix="jukebox_ckpt_")
    try:
        tr_rep = run_training(args.seed, device, logdir=logdir)
        for r in tr_rep["records"]:
            log(f"  step {r['it']}: loss {r['loss']:.6f} bpd {r['bpd']:.6f} "
                f"gn {r['gn']:.6g} loss scale {r['loss_scale']:.6g} step_ok "
                f"{r['step_ok']} wall {r['wall_s']:.3f}s"
                + (f"; saved in {r['save_s']:.1f}s" if "save_s" in r
                   else ""))
        log(f"  {tr_rep['n_depth']} layers; sample at step 1 "
            f"{tr_rep['samples'][0]['wall_s']:.1f}s, "
            f"{tr_rep['samples'][0]['launches']['layer_norm_fwd']} LayerNorm "
            f"wrapper launches, decode graph "
            f"{tr_rep['samples'][0]['graphs']}")
        log(f"  run {tr_rep['wall_s']:.1f}s; median step (steps 2-"
            f"{TRAIN_STEPS}) {tr_rep['median_step_s'] * 1e3:.1f} ms = "
            f"{tr_rep['tokens_per_s']:.1f} tokens/s; peak memory "
            f"{tr_rep['peak_mem_gb']:.2f} GB; {tr_rep['ema_updates']} host "
            f"EMA updates; flash launches {tr_rep['launches']} == expected "
            f"{tr_rep['expected']}; {tr_rep['kernel_launches']} == expected "
            f"{tr_rep['kernel_expected']}")
        torch.cuda.empty_cache()
        ckpt = tr_rep["records"][0]["checkpoint"]
        res = check_resume(args.seed, device, ckpt)
        log(f"  checkpoint {res['bytes']} bytes ({res['bytes'] / 1e9:.2f} "
            f"GB) at step {res['step']}: saved in "
            f"{tr_rep['records'][0]['save_s']:.1f}s, loaded in "
            f"{res['load_s']:.1f}s; restored bit for bit into train.setup "
            f"({res['setup_s']:.1f}s, two reads) and into a sampling "
            f"make_prior ({res['sample_restore_s']:.1f}s) as fp16_params "
            f"casts it: {res['sampling_dtypes']} tensors")
        for r in res["records"]:
            log(f"  resumed step {r['it']}: loss {r['loss']:.6f} gn "
                f"{r['gn']:.6g} step_ok {r['step_ok']} wall "
                f"{r['wall_s']:.3f}s")
        log(f"  resumed launches {res['launches']} == expected "
            f"{res['expected']}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    torch.cuda.empty_cache()
    log(f"phase 8 Quick start: {VQ_HPS} for {VQ_STEPS} steps, the vqvae "
        f"preset's step, then {PRIOR_HPS} for {PRIOR_STEPS} steps")
    tmp = tempfile.mkdtemp(prefix="jukebox_quick_start_")
    try:
        songs, logdir = quick_start_songs(tmp, args.seed)
        qs = run_quick_start(args.seed, device, gen, songs, logdir)
        torch.cuda.empty_cache()
        r9 = run_recipes(args.seed, device, gen, songs,
                         qs["a"]["checkpoint"], logdir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    torch.cuda.empty_cache()
    log("phase 10 parallel: phase 5's top prior trained and decoded across "
        "ranks (ZeRO-3 at dp=1 here, then 2 ranks over gloo)")
    r10 = run_phase10(args.seed, device, prior_depth=P10_DEPTH)

    cascades = (rep, rep4c, rep4b, rep5)
    launches = dict({k: sum(r["launches"][k] for r in cascades)
                     for k in ds.LAUNCHES}, **tr_rep["launches"],
                    **tr_rep["kernel_launches"])
    # phase 8's and phase 9's runs, the full-depth steps of phases 5 and 9
    for r in (qs["a"], qs["b"], qs["c"], r9["a"], p5) + tuple(
            r[k] for r in r9["b"].values() for k in ("step", "run")):
        for k, n in r["launches"].items():
            launches[k] += n
    # phase 8's checks at its own shapes: the worst error over every check
    for k, row in [("adam_update", qs["b"]["adam"])] + list(
            qs["c"]["rows"].items()):
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"],
                                     row["max_abs_err"])
    for k, n in r10["launches"].items():  # phase 10's ranks
        launches[k] += n
    for k, n in dict(r11["launches"], **r11["ln_launches"]).items():
        launches[k] += n  # phase 11's windows
    for r in cascades:  # the prefill's LayerNorms, the alignment forwards
        launches["flash_fwd"] += r["fa_launches"]["flash_fwd"]
        launches["layer_norm_fwd"] += r["ln_launches"]["layer_norm_fwd"]
    sources = {k: f"jukebox_tpu_torch/csrc/{stem}.cu"
               for stem, mod in SOURCES.items() for k in mod.LAUNCHES}
    kernels = [dict(name=k, route="cuda", source=sources[k],
                    replaces=REPLACES[k], launches=launches[k], **rows[k])
               for k in rows]
    log(f"decode graph replays (the fp32 decode of the in-training samples "
        f"and of the graph checks): {ar.GRAPHS}; a replay runs two "
        f"layer_norm_fwd kernels a layer that no wrapper counts (measured "
        f"in check_decode_graph's profiler trace), so the kernels line's "
        f"launches leave them out")
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    log(f"done in {time.time() - T0:.1f}s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
