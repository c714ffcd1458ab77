"""Windowed ancestral sampling cascade of the PyTorch port (counterpart of
jukebox_tpu/sample.py, sequential scheduler): the top level's codes first,
then each upsampler level, window by window, then VQ-VAE decode, data.jkb
and wav per level into hps.name. Everything runs in the calling thread.
Each window's conditioning (a 5b_lyrics top's lyric encoder included, run
once per window) and its decode mode (bf16, or int8 under
JUKEBOX_INT8_DECODE=1 / stage_decode(quantize="int8")) belong to
PriorRuntime.sample.

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

from jukebox_tpu_torch.utils.audio_utils import save_wav
from jukebox_tpu_torch.utils.sample_utils import get_starts, split_batch

STAGE_SECONDS = {}  # per-stage wall seconds of the last _sample_sequential


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


def _sample_sequential(zs, labels, sampling_kwargs, priors, sample_levels,
                       hps):
    STAGE_SECONDS.clear()
    for level in reversed(sample_levels):
        prior = priors[level]
        assert hps.sample_length % prior.raw_to_tokens == 0, \
            f"sample_length {hps.sample_length} not a multiple of {prior.raw_to_tokens}"
        total_length = hps.sample_length // prior.raw_to_tokens
        hop_length = int(hps.hop_fraction[level] * prior.n_ctx)
        zs = sample_level(zs, labels[level], sampling_kwargs[level], level,
                          prior, total_length, hop_length, hps)
        _decode_save_level(zs, labels, sampling_kwargs, priors, level, hps)
    return zs


def ancestral_sample(labels, sampling_kwargs, priors, hps):
    """Sample every level from scratch, top first. Returns the codes zs
    (one int64 array [n_samples, tokens] per level)."""
    sample_levels = list(range(len(priors)))
    zs = [np.zeros((hps.n_samples, 0), dtype=np.int64) for _ in priors]
    return _sample_sequential(zs, labels, sampling_kwargs, priors,
                              sample_levels, hps)
