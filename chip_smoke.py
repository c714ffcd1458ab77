"""Drive the PyTorch port (jukebox_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases, each printing timestamped lines:
  0 device   the card's name and power limit (nvidia-smi); TF32 off; a
             watchdog turns a hang into an exit with a stack dump
  1 build    nvcc builds the CUDA kernels from jukebox_tpu_torch/csrc
  2 kernels  every decode kernel against its plain PyTorch version at the
             shapes of the 1b_lyrics priors (top: S 2048, A 512, 2 heads;
             upsamplers: S 1920, A 480, 1 head), every attention pattern at
             positions that cross block and prime boundaries; times per
             launch beside the bound, the plain version and one library call
  3 step     one full-width decode step per prior, kernel path against the
             plain path on the same caches after a one-block prefill
  2b flash   the flash-attention kernels (forward, dq, dk/dv) against their
             plain versions at the top prior's f0 shape (B 1, L 6528, S 512,
             2 heads) and a ragged L, at dropout rates 0 and 0.1, and a
             planted fault (one tile skipped) that the check must refuse;
             times per launch beside the bound, the plain version and SDPA
  2c ln      the LayerNorm kernels (forward, backward) against their plain
             versions at the top's training rows [6528, 2048] bf16, at
             [6528, 1920] fp32 and a ragged [1000, 1000] bf16, and a planted
             fault (the last row skipped); times beside the bound, the plain
             version and F.layer_norm (and its autograd backward)
  4 cascade  the 1b_lyrics ancestral cascade (labels -> top codes -> two
             upsamplers -> 44.1 kHz wav) from random weights drawn from
             --seed; checks codes, audio and that every decode step of every
             prior went through the kernels, and every LayerNorm of the
             prefill and the conditioners (launch counts)
  2d adam    the Adam kernel against its plain loop on the top prior's
             871 parameter tensors, fp32 and fp16 moments, three updates,
             and a planted fault (the last chunk of the largest tensor left
             out); the update's time beside the bound and the plain loop
  5 train    one full-width train step of the 1b_lyrics top prior (72
             layers, all_fp16): loss and gradients through the flash and
             LayerNorm kernels against the plain path on one batch, against
             the path with flash alone plain, and a planted flash fault that
             the checks must refuse; the launch counts; one step timed by
             parts and one under torch.profiler
  6 run      train.run: six optimizer steps of the top prior from two
             synthetic 40 s wavs (labelled dataset, aug_shift, aug_blend,
             loss scaling, fp16 Adam, host EMA every 2 steps), saving
             checkpoint_latest.jkb at step 1; checks finite losses, launch
             counts of every training kernel, and that no thread outlives
             the run; then a run restored from the checkpoint holds its
             params, optimizer state and step bit for bit and takes two
             more steps, and a sampling make_prior restored from it holds
             its params; the checkpoint's size, save and load times
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed check raises: exit code != 0.
It runs on the GPU only; without one it exits with an error.
"""

import argparse
import contextlib
import faulthandler
import json
import math
import multiprocessing
import os
import pickle
import shutil
import subprocess
import tempfile
import threading
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

from jukebox_tpu_torch import sample as sample_mod
from jukebox_tpu_torch import train as train_mod
from jukebox_tpu_torch.data.files_dataset import FixedMetadataDataset
from jukebox_tpu_torch.hparams import Hyperparams, setup_hparams
from jukebox_tpu_torch.models.make_models import (make_model, make_prior,
                                                  make_vqvae)
from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.ops import adam as ad
from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.ops import flash_attention as fa
from jukebox_tpu_torch.ops import layer_norm as ln
from jukebox_tpu_torch.utils.checkpoints import load_checkpoint
from jukebox_tpu_torch.utils.convert import named_leaves
from jukebox_tpu_torch.utils.sample_utils import get_starts

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense, data sheet
ROTATE_BYTES = 256 << 20     # inputs rotated per timing: > 2x the 50 MB L2
KERNEL_TOL = 1e-2            # kernel vs plain, relative to max(1, |plain|)
STEP_TOL = 5e-2              # full-stack logits, relative to max(1, |plain|)
# the cascade: 4 samples of 262144 audio samples (5.94 s), the shortest
# cascade whose upsamplers get a full window of conditioning codes; the
# upsamplers run 8 of their 72 layers so the whole run stays near 10 minutes
# (their decode loop is bound by the host's launch rate)
N_SAMPLES, SAMPLE_LENGTH, UPS_DEPTH, TEMP = 4, 262144, 8, 0.99
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
LOSS_TOL, GN_TOL = 1e-5, 1e-4
GRAD_TOL = {"c_attn": 5e-3, "c_proj": 2e-3}
FULL_TOL = {"loss": 1e-5, "grad norm": 1e-4, "c_attn": 5e-3, "c_proj": 5e-3}
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
                funcs=sorted({tr.attn_func(d) for d in range(tr.n_depth)}))


def attn_positions(sh, last_t):
    bc = sh["bc"]
    ts = {0, bc - 1, bc, 2 * bc + 1, last_t}
    if sh["prime"]:
        ts |= {sh["prime"] - 1, sh["prime"]}
    return sorted(t for t in ts if t <= last_t)


def check_kernels(shapes, B, last_t, device, gen, time_it=True):
    """Hold every kernel against its plain version at each prior shape in
    `shapes` ({label: prior_shapes(...)}), the attention at every pattern
    and at positions crossing block and prime boundaries; time every shape
    (attention at last_t[label]). Returns KernelReport.rows: the worst
    error of each kernel and the times of its representative shape (the
    first label's LayerNorm, qkv GEMV and f0 attention)."""
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
        # -- ln_rows
        x, g, b = rnd(B, S), rnd(S, dtype=torch.float32), rnd(S, dtype=torch.float32)
        rep.check("ln_rows", ds.ln_rows(x, g, b), ds.ln_rows_plain(x, g, b),
                  f"{label} [{B},{S}]")
        gb, bb = g.to(bf), b.to(bf)
        sets = copies(lambda: (rnd(B, S), g, b), B * S * 4)
        time3("ln_rows", f"{label} [{B},{S}]", ds.ln_rows, ds.ln_rows_plain,
              lambda x_: F.layer_norm(x_, (S,), gb, bb, 1e-5),
              sets, [(x_,) for x_, _, _ in sets], 2 * B * S * 2 + 2 * S * 4,
              8 * B * S, "fp32", main)
        # -- gemv_bf16, the four products of a layer
        for what, K, N, epi in (("c_attn", S, 3 * A, None),
                                ("c_proj", A, S, "residual"),
                                ("mlp.c_fc", S, Sm, "gelu"),
                                ("mlp.c_proj", Sm, S, "residual")):
            x, w, b = rnd(B, K), rnd(K, N, scale=0.02), rnd(N, scale=0.02)
            res = rnd(B, N) if epi == "residual" else None
            what = f"{label} {what} [{B},{K}]x[{K},{N}]"
            rep.check("gemv_bf16", ds.gemv_bf16(x, w, b, epi, res),
                      ds.gemv_bf16_plain(x, w, b, epi, res), what)
            sets = copies(lambda: (rnd(B, K), rnd(K, N, scale=0.02), b, epi,
                                   res), K * N * 2)
            # the library call: the product and bias in one cuBLAS call
            time3("gemv_bf16", what, ds.gemv_bf16, ds.gemv_bf16_plain,
                  lambda x_, w_, b_: torch.addmm(b_, x_, w_), sets,
                  [a[:3] for a in sets],
                  K * N * 2 + B * K * 2 + N * 2 + B * N * 2 * (2 if res is not None else 1),
                  2 * B * K * N, "bf16", main and epi is None)
        # -- ring_attn_decode, every pattern of this prior
        for f in sh["funcs"]:
            shape = {0: (B, sh["n_ctx"], A), 1: (B, sh["bc"], A),
                     2: (B, sh["bc"], sh["blocks"], A), 3: (B, 2 * sh["bc"], A),
                     7: (B, sh["prime"] or 1, A)}[f]
            kc, vc = rnd(*shape), rnd(*shape)
            for t in attn_positions(sh, last_t[label]):
                geom = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])
                qkv = rnd(B, 3 * A)
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                out = ds.ring_attn_decode(qkv, k1, v1, geom, H)
                ref = ds.ring_attn_decode_plain(qkv, k2, v2, geom, H)
                rep.check("ring_attn_decode", out, ref,
                          f"{label} f{f} t={t} rows {geom[2]}+{geom[3]}")
                if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                    raise AssertionError(f"f{f} t={t}: cache write differs")
            # time the same work (n live rows read, one slot written) on
            # caches holding just those rows, so the rotated copies stay small
            t = last_t[label]
            _, w, _, n = ds.ring_geometry(f, t, shape, sh["bc"], sh["prime"])
            geom = (n, n - 1 if w >= 0 else -1, 0, n)
            hd, live = A // H, B * n * A * 2 * 2
            sets = copies(lambda: (rnd(B, 3 * A), rnd(B, n, A), rnd(B, n, A),
                                   geom, H), live)
            lib_sets = [tuple(z.reshape(B, -1, H, hd).transpose(1, 2).contiguous()
                              for z in (qkv_[:, :A], k_, v_))
                        for qkv_, k_, v_, _, _ in sets]
            time3("ring_attn_decode", f"{label} f{f} t={t} ({n} rows)",
                  ds.ring_attn_decode, ds.ring_attn_decode_plain,
                  F.scaled_dot_product_attention, sets, lib_sets,
                  live + B * 3 * A * 2 + (2 * B * A * 2 if w >= 0 else 0)
                  + B * A * 2, 4 * B * n * A, "bf16", main and f == 0)
    for name, row in rep.rows.items():
        row.update(timings.get(name, {}))
    return rep.rows


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


def check_flash(B, L, S, H, device, gen, time_it=True, ragged=2500,
                seed=1234):
    """Hold flash_fwd (out, lse), flash_dq and flash_dkv against their plain
    versions (fa.agreement) on random heads at [B*H, L, S/H] and a ragged
    L, at dropout rates 0 and 0.1, and check that each kernel fed the
    planted fault of skip_tile fails the same comparison; time the main
    shape at rate 0 beside the bound, the plain version and SDPA (causal
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
            check("flash_dq", fa.flash_dq(*args), fa.flash_dq_plain(*args),
                  fa.flash_dq(q, k, skip_tile(v), *args[3:]), what)
            bad = fa.flash_dkv(q, k, v, skip_tile(g), ref_lse, skip_tile(dd),
                               *args[6:])
            for n, a, b, f in zip(("dk", "dv"), fa.flash_dkv(*args),
                                  fa.flash_dkv_plain(*args), bad):
                check("flash_dkv", a, b, f, f"{n} {what}")
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
def check_adam(start, fp16, device, seed=7, time_it=True):
    """Phase 2d: ADAM_STEPS updates of the tensors `start` ({name: fp32
    parameter}, left unchanged) through the Adam kernel against the plain
    version from one state, with gradients of ~1e3 drawn per step (one
    tensor's gradient None) and a loss scale x clip divisor on the card;
    then the same with a planted fault, the last chunk of the largest
    tensor left out of the launch, which the check must refuse. Times one
    update beside the bound and the plain version (no single PyTorch call
    computes this update: torch's fused AdamW places eps and the weight
    decay elsewhere). Returns the kernel's row."""
    shapes = {n: p.shape for n, p in start.items()}
    none_at = min(shapes, key=lambda n: start[n].numel())
    scale = torch.tensor(2.0 ** 16 * 1.7, device=device)
    cuda = torch.device(device).type == "cuda"
    what = "fp16 moments" if fp16 else "fp32 moments"

    def clone():
        params = {n: p.detach().clone() for n, p in start.items()}
        return params, train_mod.adam_init(params, fp16_state=fp16)

    def run(update, params, opt):
        for step in range(ADAM_STEPS):
            update(params, _adam_grads(shapes, step, device, seed, none_at),
                   opt, scale=scale, **ADAM_HYPER)
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
        # the planted fault: the last chunk of the largest tensor left out
        params, opt = clone()
        sizes = [p.numel() for p in start.values()]
        big = max(range(len(sizes)), key=sizes.__getitem__)
        chunks = ad.AdamTable(params, opt).chunks
        last = max(i for i, c in enumerate(chunks) if c[0] == big)
        faulty = ad.AdamTable(params, opt, chunks[:last] + chunks[last + 1:])
        run(lambda p, g, o, **kw: ad.adam_update_kernel(faulty, g, o, **kw),
            params, opt)
        bad = _adam_gaps(params, opt, ref_params, ref_opt, start)
        log(f"  planted fault (chunk {chunks[last]} left out): " + ", ".join(
            f"{k} {v:.3e} ({n})" for k, (v, n) in bad.items()))
        if _adam_ok(bad, fp16):
            raise AssertionError("the Adam check passes a kernel that skips "
                                 "a chunk")
        del params, opt, faulty
    del ref_params, ref_opt
    log(f"  largest normwise param gap {err:.3e}")
    if not (time_it and cuda):
        return row
    params, opt = clone()
    table = ad.AdamTable(params, opt)
    grads = _adam_grads(shapes, 0, device, seed, none_at)
    args = (grads, opt)
    ms = device_ms(lambda g, o: ad.adam_update_kernel(table, g, o, scale=scale,
                                                      **ADAM_HYPER),
                   [args], reps=10)
    plain_ms = device_ms(lambda g, o: ad.adam_update_plain(
        params, g, o, scale=scale, **ADAM_HYPER), [args], reps=2)
    del params, opt, table, grads, args
    torch.cuda.empty_cache()
    nbytes, flops = adam_work([p.numel() for p in start.values()], fp16)
    row.update(KernelReport().timed("adam_update", what, ms, plain_ms, None,
                                    nbytes, flops, "fp32"))
    return row


# ---------------------------------------------------------------------------
# phase 3: one full-width decode step, kernel path against plain path
# ---------------------------------------------------------------------------

def check_stack_step(prior, B, device, gen):
    tr = prior.model.prior.transformer
    bc = tr.blocks[0].attn.block_ctx
    dec = tr.prepare_decode_params(torch.bfloat16)
    caches = tr.init_cache(B, torch.bfloat16, device)
    x0 = torch.randn((B, bc, tr.n_in), generator=gen, device=device)
    tr.prefill_chunk(caches, x0, 0, 1, fp16=True)
    twin = [{k: c.clone() for k, c in cache.items()} for cache in caches]
    x = torch.randn((B, 1, tr.n_in), generator=gen, device=device)
    h_k = tr.decode_step(dec, caches, x, bc, fp16=True)
    h_p = tr.decode_step(dec, twin, x, bc, fp16=True, plain=True)
    lk, lp = prior.model.prior._logits(h_k), prior.model.prior._logits(h_p)
    e, rel = _err(lk, lp)
    log(f"phase 3 level {prior.level}: {tr.n_depth} layers at t={bc}, max "
        f"logit err {e:.3e} (rel {rel:.2e}, tol {STEP_TOL:g})")
    if not (torch.isfinite(lk).all() and rel <= STEP_TOL):
        raise AssertionError(f"level {prior.level}: kernel-path decode step "
                             f"disagrees with the plain path ({e:.3e})")
    if x.is_cuda:
        time_decode_step(tr, dec, caches, x, bc + 1, prior.level)


def time_decode_step(tr, dec, caches, x, t, level, reps=20):
    """Wall time of a kernel-path decode step (host clock, synchronised)
    against the device time of its kernels (torch.profiler, summed)."""
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
    launches = tr.n_depth * sum(ds.LAUNCHES_PER_LAYER.values())
    busy = (f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.0%})"
            if busy_ms > 0 else "device busy not measured (no profiler "
                                "device time)")
    log(f"phase 3 level {level}: decode step {wall_ms:.2f} ms wall, {busy}, "
        f"{launches} launches = {wall_ms / launches * 1e3:.1f} us wall each")


# ---------------------------------------------------------------------------
# phase 4: the cascade
# ---------------------------------------------------------------------------

def decode_steps(priors, hps, sampling_kwargs):
    """Token steps each prior decodes in the cascade (sampled tokens plus
    the lyric prefix's prefill tail), for windows without context tokens."""
    steps = []
    for level, prior in enumerate(priors):
        total = hps.sample_length // prior.raw_to_tokens
        hop = int(hps.hop_fraction[level] * prior.n_ctx)
        if total >= prior.n_ctx:
            starts = get_starts(total, prior.n_ctx, hop)
            assert all(b - a >= prior.n_ctx for a, b in zip(starts, starts[1:])), \
                "the smoke's windows carry no context tokens"
            n = len(starts) * prior.n_ctx
        else:
            n = total
        if prior.single_enc_dec:
            bc = prior.model.prior.block_ctx
            chunk = max(1, sampling_kwargs[level]["chunk_size"] // bc) * bc
            n += prior.n_tokens - (prior.n_tokens // chunk) * chunk
        steps.append(n)
    return steps


def cascade_layer_norms(priors, hps, sampling_kwargs):
    """LayerNorm kernel launches of the cascade: per window and batch, the
    conditioner's LayerNorm (upsamplers) and two per layer for each whole
    prefill chunk of the top's lyric prefix (chunk_size rounded to blocks;
    the decode steps, the prefix's tail included, run ln_rows instead)."""
    n = 0
    for level, prior in enumerate(priors):
        total = hps.sample_length // prior.raw_to_tokens
        hop = int(hps.hop_fraction[level] * prior.n_ctx)
        windows = (len(get_starts(total, prior.n_ctx, hop))
                   if total >= prior.n_ctx else 1)
        skw = sampling_kwargs[level]
        batches = -(-hps.n_samples // skw["max_batch_size"])
        chunks = 0
        if prior.single_enc_dec:
            bc = prior.model.prior.block_ctx
            chunks = prior.n_tokens // (max(1, skw["chunk_size"] // bc) * bc)
        per_call = (int(prior.model.x_cond)
                    + 2 * prior.model.prior.transformer.n_depth * chunks)
        n += windows * batches * per_call
    return {"layer_norm_fwd": n, "layer_norm_bwd": 0}


def run_cascade(priors, hps, sampling_kwargs):
    """ancestral_sample + checks. Returns a report dict: the decode
    kernels' launches against their expected counts (launches, expected)
    and the LayerNorm kernels' (ln_launches, ln_expected)."""
    metas = [dict(artist="unknown", genre="unknown", lyrics=LYRICS,
                  total_length=hps.sample_length, offset=0)] * hps.n_samples
    labels = [p.labeller.get_batch_labels(metas) for p in priors]
    steps = decode_steps(priors, hps, sampling_kwargs)
    depths = [p.model.prior.transformer.n_depth for p in priors]
    expected = {k: sum(d * s for d, s in zip(depths, steps)) * per
                for k, per in ds.LAUNCHES_PER_LAYER.items()}
    cuda = next(priors[0].model.parameters()).is_cuda
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ds.reset_launches()
    ln.reset_launches()
    t0 = time.time()
    zs = sample_mod.ancestral_sample(labels, sampling_kwargs, priors, hps)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ds.LAUNCHES)
    report = dict(wall_s=wall, steps=steps, expected=expected,
                  launches=launches, ln_launches=dict(ln.LAUNCHES),
                  ln_expected=cascade_layer_norms(priors, hps,
                                                  sampling_kwargs),
                  levels={})
    for level, prior in enumerate(priors):
        z = zs[level]
        want = hps.sample_length // prior.raw_to_tokens
        if z.shape != (hps.n_samples, want) or z.min() < 0 \
                or z.max() >= prior.l_bins:
            raise AssertionError(f"level {level}: codes {z.shape} "
                                 f"[{z.min()}, {z.max()}] out of range")
        with open(os.path.join(hps.name, f"level_{level}", "data.jkb"),
                  "rb") as f:
            x = pickle.load(f)["x"]
        if x.shape != (hps.n_samples, hps.sample_length, 1) \
                or not np.isfinite(x).all():
            raise AssertionError(f"level {level}: audio {x.shape} not finite")
        sec = sample_mod.STAGE_SECONDS.get(f"windows_l{level}", float("nan"))
        report["levels"][level] = dict(tokens=int(z.shape[1]),
                                       decode_steps=steps[level],
                                       seconds=sec,
                                       tokens_per_s=steps[level] / sec,
                                       audio_rms=float(np.sqrt((x ** 2).mean())))
    report["vqvae_decode_s"] = sample_mod.STAGE_SECONDS.get("vqvae_decode")
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if launches != expected:
            raise AssertionError(f"kernel launches {launches} != expected "
                                 f"{expected}: a decode step missed a kernel")
        if report["ln_launches"] != report["ln_expected"]:
            raise AssertionError(f"LayerNorm launches {report['ln_launches']}"
                                 f" != expected {report['ln_expected']}")
    return report


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


def expected_layer_norms(runtime, n_steps):
    """LayerNorm kernel launches of n_steps train steps of the prior: the
    transformer's two per block (under checkpoint_res the forward runs
    again in the recompute) and the conditioner's, forward and backward
    once each."""
    tr = runtime.model.prior.transformer
    n_tr = 2 * tr.n_depth
    n_cond = int(runtime.model.x_cond)
    fwd_per = ln.LAUNCHES_PER_STEP["layer_norm_fwd"] \
        if tr.checkpoint_res == 1 else 1
    return {"layer_norm_fwd": (fwd_per * n_tr + n_cond) * n_steps,
            "layer_norm_bwd": (n_tr + n_cond) * n_steps}


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
    return launches


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
        if logdir is None:
            kw.update(save=False)
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
        out = train_mod.run(TRAIN_HPS, device=device, dataset=dataset,
                            **dict(TRAIN_KW, seed=seed, **kw))
        wall = time.time() - t0
        launches = dict(fa.LAUNCHES)
        kernel_launches = dict(**ln.LAUNCHES, **ad.LAUNCHES)
    runtime, records = out["runtime"], out["records"]
    n_flash = n_flash_layers(runtime, hps)
    walls = [r["wall_s"] for r in records[1:]]
    step_s = float(np.median(walls)) if walls else float("nan")
    report = dict(records=records, launches=launches, wall_s=wall,
                  expected=expected_flash(n_flash, len(records)),
                  kernel_launches=kernel_launches,
                  kernel_expected=dict(
                      expected_layer_norms(runtime, len(records)),
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
    restored from it holds its params. Returns a report dict (checkpoint
    bytes, load and restore seconds, the resumed records, launches)."""
    cuda = torch.device(device).type == "cuda"
    t = time.time()
    file = load_checkpoint(ckpt)
    load_s = time.time() - t
    step = int(file["step"])
    with tempfile.TemporaryDirectory(prefix="jukebox_train_") as wavs:
        kw = dict(over, audio_files_dir=wavs, max_steps=step + n_more,
                  cpu_ema_freq=CPU_EMA_FREQ, log_steps=1, save=False,
                  restore_prior=ckpt)
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
    assert_same(sampler.params, named_leaves(sampler.model, file["params"]),
                "sampling params")
    if sampler.step != step:
        raise AssertionError(f"sampling runtime step {sampler.step}")
    del sampler, file
    return dict(bytes=os.path.getsize(ckpt), load_s=load_s, setup_s=setup_s,
                sample_restore_s=sample_s, step=step, records=records,
                launches=launches, expected=expected)


# LayerNorm shapes of phase 2c: the top prior's training rows (n_ctx 6144
# + 384 lyric tokens) in the training dtype, the upsamplers' width, and a
# ragged shape
LN_SHAPES = [(6528, 2048, torch.bfloat16), (6528, 1920, torch.float32),
             (1000, 1000, torch.bfloat16)]
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of sampling")
    args = p.parse_args(argv)
    name, count = phase_device()
    phase_build()
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t = time.time()
    hps = Hyperparams(n_samples=N_SAMPLES, sample_length=SAMPLE_LENGTH,
                      sr=44100, hop_fraction=(1.0, 1.0, 0.125), seed=args.seed,
                      name=tempfile.mkdtemp(prefix="jukebox_smoke_"))
    vqvae, priors = make_model("1b_lyrics", hps, device, prior_overrides=[
        {"prior_depth": UPS_DEPTH}, {"prior_depth": UPS_DEPTH}, {}])
    torch.cuda.synchronize()
    log(f"models: 1b_lyrics drawn from seed {args.seed} in "
        f"{time.time() - t:.1f}s, depths "
        f"{[p.model.prior.transformer.n_depth for p in priors]}, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")

    skw = [dict(temp=TEMP, fp16=True, chunk_size=256,
                max_batch_size=N_SAMPLES) for _ in priors]
    top = priors[-1]
    shapes = {"top": prior_shapes(top), "upsampler": prior_shapes(priors[0])}
    last_t = {"top": top.n_tokens + hps.sample_length // top.raw_to_tokens - 1,
              "upsampler": priors[0].n_ctx - 1}
    log("phase 2 kernels against their plain versions")
    rows = check_kernels(shapes, N_SAMPLES, last_t, device, gen)
    log("phase 2b flash kernels against their plain versions")
    tr = top.model.prior.transformer
    rows.update(check_flash(1, tr.n_ctx, tr.blocks[0].attn.n_state,
                            tr.n_head, device, gen))
    log("phase 2c LayerNorm kernels against their plain versions")
    rows.update(check_layer_norm(LN_SHAPES, device, gen))

    for prior in (top, priors[0]):
        check_stack_step(prior, N_SAMPLES, device, gen)

    log(f"phase 4 cascade: {N_SAMPLES} x {hps.sample_length} samples "
        f"({hps.sample_length / hps.sr:.2f} s), temp {TEMP}")
    rep = run_cascade(priors, hps, skw)
    for level, lv in sorted(rep["levels"].items(), reverse=True):
        log(f"  level {level}: {lv['tokens']} codes, {lv['decode_steps']} "
            f"decode steps in {lv['seconds']:.1f}s = "
            f"{lv['tokens_per_s']:.1f} steps/s (x{N_SAMPLES} samples), "
            f"audio rms {lv['audio_rms']:.3f}")
    log(f"  cascade {rep['wall_s']:.1f}s, vqvae decode "
        f"{rep['vqvae_decode_s']:.1f}s, peak memory "
        f"{rep['peak_mem_gb']:.1f} GB; launches {rep['launches']} == "
        f"expected {rep['expected']}; LayerNorm {rep['ln_launches']} == "
        f"expected {rep['ln_expected']}")

    shutil.rmtree(hps.name, ignore_errors=True)
    del vqvae, priors, top, tr, prior
    torch.cuda.empty_cache()

    log("phase 2d Adam kernel against its plain version (on the top "
        "prior's parameters), then phase 5")
    check_train_step(args.seed, device, gen, rows=rows)
    torch.cuda.empty_cache()
    log(f"phase 6 train.run: {TRAIN_STEPS} steps of the top prior, "
        f"{TRAIN_HPS}, host EMA every {CPU_EMA_FREQ} steps, a checkpoint "
        f"at step 1")
    logdir = tempfile.mkdtemp(prefix="jukebox_ckpt_")
    try:
        tr_rep = run_training(args.seed, device, logdir=logdir)
        for r in tr_rep["records"]:
            log(f"  step {r['it']}: loss {r['loss']:.6f} bpd {r['bpd']:.6f} "
                f"gn {r['gn']:.6g} loss scale {r['loss_scale']:.6g} step_ok "
                f"{r['step_ok']} wall {r['wall_s']:.3f}s"
                + (f"; saved in {r['save_s']:.1f}s" if "save_s" in r
                   else ""))
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
            f"make_prior ({res['sample_restore_s']:.1f}s)")
        for r in res["records"]:
            log(f"  resumed step {r['it']}: loss {r['loss']:.6f} gn "
                f"{r['gn']:.6g} step_ok {r['step_ok']} wall "
                f"{r['wall_s']:.3f}s")
        log(f"  resumed launches {res['launches']} == expected "
            f"{res['expected']}")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    launches = dict(rep["launches"], **tr_rep["launches"],
                    **tr_rep["kernel_launches"])
    sources = {k: f"jukebox_tpu_torch/csrc/{stem}.cu"
               for stem, mod in SOURCES.items() for k in mod.LAUNCHES}
    kernels = [dict(name=k, route="cuda", source=sources[k],
                    replaces=REPLACES[k], launches=launches[k], **rows[k])
               for k in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    log(f"done in {time.time() - T0:.1f}s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
