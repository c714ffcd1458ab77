"""Windowed sampling cascade of the PyTorch port (counterpart of
jukebox_tpu/sample.py, sequential scheduler): the top level's codes first,
then each upsampler level, window by window; after each level its VQ-VAE
decode, data.jkb and wav into {hps.name}/level_{level}, after the first of
them the top prior's lyric alignment (once), then that level's html with
it. Everything runs in the calling thread, in the order of the JAX
package's inline finalize (JUKEBOX_ASYNC_FINALIZE=0). Each window's
conditioning (a 5b_lyrics top's lyric encoder included, run once per
window) and its decode mode (bf16, or int8 under JUKEBOX_INT8_DECODE=1 /
stage_decode(quantize="int8")) belong to PriorRuntime.sample. Modes:
ancestral, continue, upsample and primed; the CLI

    python -m jukebox_tpu_torch.sample 1b_lyrics --name=out --n_samples=4 \
        --sample_length_in_seconds=24 --total_sample_length_in_seconds=240 \
        --sr=44100 --hop_fraction=0.5,0.5,0.125 [--mode=primed \
        --audio_file=prompt.wav --prompt_length_in_seconds=12] [--device=cpu]

runs save_samples on the card unless --device says otherwise (continue and
upsample take --codes_file=<a run's data.jkb>).

Randomness: window i of a level at `start` samples with a torch.Generator
seeded (seed, level, start * 131 + i) on the sampling device; the JAX
package folds its key the same way but draws other numbers, so token
streams match it only at temp == 0 (argmax).
"""

import os
import pickle
import time

import numpy as np
import torch

from jukebox_tpu_torch.align import get_alignment
from jukebox_tpu_torch.data.labels import EmptyLabeller
from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.models.make_models import make_model
from jukebox_tpu_torch.save_html import save_html
from jukebox_tpu_torch.utils.audio_utils import save_wav
from jukebox_tpu_torch.utils.io import load_prompt
from jukebox_tpu_torch.utils.cli import fire
from jukebox_tpu_torch.utils.sample_utils import get_starts, split_batch

STAGE_SECONDS = {}  # per-stage wall seconds of the last _sample


def _generator(device, *key):
    seed = int(np.random.SeedSequence(list(key)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def sample_partial_window(zs, labels, sampling_kwargs, level, prior,
                          tokens_to_sample, hps):
    """Sample a window shorter than n_ctx (sample.py:17-28)."""
    current_tokens = zs[level].shape[1]
    n_ctx = prior.n_ctx
    if current_tokens < n_ctx - tokens_to_sample:
        sampling_kwargs["sample_tokens"] = int(current_tokens + tokens_to_sample)
        start = 0
    else:
        sampling_kwargs["sample_tokens"] = n_ctx
        start = current_tokens - n_ctx + tokens_to_sample
    return sample_single_window(zs, labels, sampling_kwargs, level, prior,
                                start, hps)


def sample_single_window(zs, labels, sampling_kwargs, level, prior, start,
                         hps):
    """Sample one n_ctx window at `start`, conditioning on the overlap with
    already-sampled tokens (sample.py:31-78). zs holds int64 numpy arrays."""
    n_samples = hps.n_samples
    end = start + prior.n_ctx
    z = zs[level][:, start:end]
    sample_tokens = sampling_kwargs.get("sample_tokens", end - start)
    new_tokens = sample_tokens - z.shape[1]
    if new_tokens <= 0:
        return zs
    device = next(prior.model.parameters()).device
    z_conds = prior.get_z_conds(zs, start, end)
    y = prior.get_y(labels, start)
    kwargs = dict(sampling_kwargs)
    max_batch_size = kwargs.pop("max_batch_size")
    kwargs.setdefault("sample_tokens", sample_tokens)

    def to_dev(a):
        return None if a is None else torch.as_tensor(a, device=device)
    t0 = time.time()
    z_samples = []
    for i, (z_i, zc_i, y_i) in enumerate(zip(
            split_batch(z, n_samples, max_batch_size),
            split_batch(z_conds, n_samples, max_batch_size),
            split_batch(y, n_samples, max_batch_size))):
        gen = _generator(device, hps.get("seed", 0), level, start * 131 + i)
        out = prior.sample(n_samples=z_i.shape[0], z=to_dev(z_i),
                           z_conds=None if zc_i is None else
                           [to_dev(c) for c in zc_i],
                           y=to_dev(y_i), gen=gen, **kwargs)
        z_samples.append(out.cpu().numpy())
    key = f"windows_l{level}"
    STAGE_SECONDS[key] = STAGE_SECONDS.get(key, 0.0) + time.time() - t0
    z = np.concatenate(z_samples, axis=0)
    zs[level] = np.concatenate([zs[level], z[:, -new_tokens:]], axis=1)
    return zs


def sample_level(zs, labels, sampling_kwargs, level, prior, total_length,
                 hop_length, hps):
    """Sample total_length tokens at one level by hopping windows."""
    if total_length >= prior.n_ctx:
        for start in get_starts(total_length, prior.n_ctx, hop_length):
            zs = sample_single_window(zs, labels, sampling_kwargs, level,
                                      prior, start, hps)
    else:
        zs = sample_partial_window(zs, labels, sampling_kwargs, level, prior,
                                   total_length, hps)
    return zs


def _decode_save_level(zs, labels, sampling_kwargs, priors, level, hps):
    """VQ-VAE decode of one level's codes, then data.jkb and one wav per
    sample into {hps.name}/level_{level}. Returns the audio [N, T, 1]."""
    prior = priors[level]
    prior.release()  # the level's staged decode weights are done
    t0 = time.time()
    device = next(prior.model.parameters()).device
    bs = zs[level].shape[0]
    x = prior.decode([torch.as_tensor(z, device=device) for z in zs[level:]],
                     start_level=level, bs_chunks=max(1, -(-bs // 8)))
    x_np = x.float().cpu().numpy()
    STAGE_SECONDS["vqvae_decode"] = (STAGE_SECONDS.get("vqvae_decode", 0.0)
                                     + time.time() - t0)
    logdir = os.path.join(hps.name, f"level_{level}")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "data.jkb"), "wb") as f:
        pickle.dump(dict(zs=[np.asarray(z) for z in zs], labels=labels,
                         sampling_kwargs=sampling_kwargs, x=x_np), f)
    save_wav(logdir, x_np, hps.sr)
    return x_np


def _compute_alignments(zs, labels, sampling_kwargs, priors, hps):
    """Lyric alignment from the top prior's recorded attention
    (sample.py:118-119); None when the model has no lyric conditioning or
    no alignment taps, or under JUKEBOX_SKIP_ALIGN=1. A failure raises."""
    top = priors[-1]
    if (top is None or top.n_tokens == 0
            or isinstance(top.labeller, EmptyLabeller)
            or getattr(top, "alignment_layer", None) is None
            or getattr(top, "alignment_head", None) is None
            or os.environ.get("JUKEBOX_SKIP_ALIGN") == "1"):
        return None
    t0 = time.time()
    alignments = get_alignment(None, zs, labels[-1], top,
                               sampling_kwargs[-1].get("fp16", False), hps)
    STAGE_SECONDS["align"] = STAGE_SECONDS.get("align", 0.0) + time.time() - t0
    return alignments


def _html_level(x, zs, labels, level, hps, alignments):
    t0 = time.time()
    save_html(f"{hps.name}/level_{level}", x, zs, labels[-1], alignments, hps)
    STAGE_SECONDS["html"] = STAGE_SECONDS.get("html", 0.0) + time.time() - t0


def _sample_sequential(zs, labels, sampling_kwargs, priors, sample_levels,
                       hps):
    STAGE_SECONDS.clear()
    alignments, aligned = None, False
    for level in reversed(sample_levels):
        prior = priors[level]
        assert hps.sample_length % prior.raw_to_tokens == 0, \
            f"sample_length {hps.sample_length} not a multiple of {prior.raw_to_tokens}"
        total_length = hps.sample_length // prior.raw_to_tokens
        hop_length = int(hps.hop_fraction[level] * prior.n_ctx)
        zs = sample_level(zs, labels[level], sampling_kwargs[level], level,
                          prior, total_length, hop_length, hps)
        # decode and save first: it releases the level's staged decode
        # weights before the alignment's forward
        x = _decode_save_level(zs, labels, sampling_kwargs, priors, level,
                               hps)
        if not aligned:
            alignments = _compute_alignments(zs, labels, sampling_kwargs,
                                             priors, hps)
            aligned = True
        _html_level(x, zs, labels, level, hps, alignments)
    return zs


def _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps):
    """Top-to-bottom cascade over sample_levels: sample a level, decode,
    save, align, html (sample.py:91-121), with the sequential scheduler.
    The JAX package's pipelined scheduler gives the same tokens and is not
    ported: asking for it (hps.pipeline_cascade=True or
    JUKEBOX_PIPELINE=1) raises."""
    env = os.environ.get("JUKEBOX_PIPELINE")
    if (hps.get("pipeline_cascade", env is not None and env != "0")
            and len(sample_levels) > 1):
        raise NotImplementedError(
            "the pipelined cascade scheduler is not ported (ROADMAP queue 1 "
            "item 4); the sequential scheduler samples the same tokens: set "
            "pipeline_cascade=False")
    return _sample_sequential(zs, labels, sampling_kwargs, priors,
                              sample_levels, hps)


def ancestral_sample(labels, sampling_kwargs, priors, hps):
    """Sample every level from scratch, top first. Returns the codes zs
    (one int64 array [n_samples, tokens] per level)."""
    sample_levels = list(range(len(priors)))
    zs = [np.zeros((hps.n_samples, 0), dtype=np.int64) for _ in priors]
    return _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps)


def continue_sample(zs, labels, sampling_kwargs, priors, hps):
    """Extend the codes zs of every level."""
    sample_levels = list(range(len(priors)))
    return _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps)


def upsample(zs, labels, sampling_kwargs, priors, hps):
    """Sample the levels below the top from the top's codes zs[-1]."""
    sample_levels = list(range(len(priors) - 1))
    return _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps)


def primed_sample(x, labels, sampling_kwargs, priors, hps):
    """Continue the prompt audio x [n_samples, T, 1]: its codes at every
    level, then every level sampled from them."""
    sample_levels = list(range(len(priors)))
    device = next(priors[-1].model.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    zs = priors[-1].encode(x, start_level=0, end_level=len(priors),
                           bs_chunks=x.shape[0])
    zs = [z.cpu().numpy().astype(np.int64) for z in zs]
    return _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps)


def load_prompts(audio_files, duration, hps):
    """The first `duration` samples at hps.sr of each prompt file (any format
    utils/io.py reads, at any rate), as float32 [n_samples, duration, 1] on
    the CPU: the channel mean (io.load_prompt), the files repeated to
    n_samples (sample.py:150-161)."""
    xs = []
    for audio_file in audio_files:
        xs.append(load_prompt(audio_file, hps.sr, duration)[:, None])
    while len(xs) < hps.n_samples:
        xs.extend(xs)
    xs = xs[: hps.n_samples]
    return torch.from_numpy(np.stack(xs))


def load_codes(codes_file, duration, priors, hps):
    """Codes of a previous run's data.jkb, cut to `duration` samples when
    given (sample.py:164-175)."""
    with open(codes_file, "rb") as f:
        data = pickle.load(f)
    zs = [np.asarray(z) for z in data["zs"]]
    assert zs[-1].shape[0] == hps.n_samples
    if duration is not None:
        top_raw_to_tokens = priors[-1].raw_to_tokens
        assert duration % top_raw_to_tokens == 0
        zs = [z[:, : duration // prior.raw_to_tokens]
              for z, prior in zip(zs, priors)]
    return zs


def save_samples(model, device, hps, sample_hps):
    """Default metas, sampling kwargs and the mode's dispatch
    (sample.py:178-266); the chunk and batch sizes are the JAX package's
    defaults, each overridable through hps."""
    from jukebox_tpu_torch.lyricdict import gpt_2_lyrics, poems
    print(dict(hps))
    vqvae, priors = make_model(model, hps, device)

    assert hps.sample_length // priors[-2].raw_to_tokens >= priors[-2].n_ctx, \
        "Upsampling needs at least one ctx in get_z_conds; choose a longer sample length"

    total_length = hps.total_sample_length_in_seconds * hps.sr
    offset = 0
    metas = [
        dict(artist="Alan Jackson", genre="Country", lyrics=poems["ozymandias"],
             total_length=total_length, offset=offset),
        dict(artist="Joe Bonamassa", genre="Blues Rock", lyrics=gpt_2_lyrics["hottub"],
             total_length=total_length, offset=offset),
        dict(artist="Frank Sinatra", genre="Classic Pop", lyrics=gpt_2_lyrics["alone"],
             total_length=total_length, offset=offset),
        dict(artist="Ella Fitzgerald", genre="Jazz", lyrics=gpt_2_lyrics["count"],
             total_length=total_length, offset=offset),
        dict(artist="Céline Dion", genre="Pop", lyrics=gpt_2_lyrics["darkness"],
             total_length=total_length, offset=offset),
    ]
    while len(metas) < hps.n_samples:
        metas.extend(metas)
    metas = metas[: hps.n_samples]

    labels = [prior.labeller.get_batch_labels(metas) for prior in priors]

    lower_level_chunk_size = hps.get("lower_level_chunk_size", 256)
    lower_level_max_batch_size = hps.get("lower_level_max_batch_size", 16)
    if model == "1b_lyrics":
        chunk_size, max_batch_size = hps.get("chunk_size", 256), \
            hps.get("max_batch_size", 16)
    else:
        int8_staging = os.environ.get("JUKEBOX_INT8_DECODE", "") not in ("", "0")
        chunk_size, max_batch_size = hps.get("chunk_size", 128), \
            hps.get("max_batch_size", 4 if int8_staging else 3)
    sampling_kwargs = [
        dict(temp=0.99, fp16=True, chunk_size=lower_level_chunk_size,
             max_batch_size=lower_level_max_batch_size),
        dict(temp=0.99, fp16=True, chunk_size=lower_level_chunk_size,
             max_batch_size=lower_level_max_batch_size),
        dict(temp=0.99, fp16=True, chunk_size=chunk_size,
             max_batch_size=max_batch_size),
    ]

    if sample_hps.mode == "ancestral":
        ancestral_sample(labels, sampling_kwargs, priors, hps)
    elif sample_hps.mode in ("continue", "upsample"):
        assert sample_hps.codes_file is not None
        top_raw_to_tokens = priors[-1].raw_to_tokens
        if sample_hps.prompt_length_in_seconds is not None:
            duration = (int(sample_hps.prompt_length_in_seconds * hps.sr)
                        // top_raw_to_tokens) * top_raw_to_tokens
        else:
            duration = None
        zs = load_codes(sample_hps.codes_file, duration, priors, hps)
        if sample_hps.mode == "continue":
            continue_sample(zs, labels, sampling_kwargs, priors, hps)
        else:
            upsample(zs, labels, sampling_kwargs, priors, hps)
    elif sample_hps.mode == "primed":
        assert sample_hps.audio_file is not None
        assert sample_hps.prompt_length_in_seconds is not None
        audio_files = sample_hps.audio_file.split(",")
        top_raw_to_tokens = priors[-1].raw_to_tokens
        duration = (int(sample_hps.prompt_length_in_seconds * hps.sr)
                    // top_raw_to_tokens) * top_raw_to_tokens
        x = load_prompts(audio_files, duration, hps)
        primed_sample(x, labels, sampling_kwargs, priors, hps)
    else:
        raise ValueError(f"Unknown sample mode {sample_hps.mode}.")


def run(model, mode="ancestral", codes_file=None, audio_file=None,
        prompt_length_in_seconds=None, port=29500, device="cuda", **kwargs):
    hps = Hyperparams(**kwargs)
    sample_hps = Hyperparams(mode=mode, codes_file=codes_file,
                             audio_file=audio_file,
                             prompt_length_in_seconds=prompt_length_in_seconds)
    save_samples(model, device, hps, sample_hps)


if __name__ == "__main__":
    fire(run)
