"""Windowed sampling cascade of the PyTorch port (counterpart of
jukebox_tpu/sample.py): the top level's codes first, then each upsampler
level, window by window; after each level its VQ-VAE decode, data.jkb and
wav into {hps.name}/level_{level}, after the first of them the top prior's
lyric alignment (once), then that level's html with it. By default, as in
the JAX package, the pipelined scheduler interleaves a lower level's
windows with the level above as soon as their conditioning codes exist,
the next level's decode weights are staged on a worker thread, and each
level's tail (decode and save, alignment, html) runs on worker threads
while the cascade samples on. JUKEBOX_PIPELINE=0 (or
hps.pipeline_cascade=False) takes the sequential scheduler,
JUKEBOX_ASYNC_FINALIZE=0 the inline tail, JUKEBOX_ASYNC_STAGE=0/1 turns
the staging thread off or on; tokens and files are the same either way.
Each window's conditioning (a 5b_lyrics top's lyric encoder included, run
once per window) and its decode mode (bf16, or int8 under
JUKEBOX_INT8_DECODE=1 / stage_decode(quantize="int8")) belong to
PriorRuntime.sample. Modes:
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

import functools
import os
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jukebox_tpu_torch.align import get_alignment
from jukebox_tpu_torch.data.labels import EmptyLabeller
from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.models.make_models import make_model
from jukebox_tpu_torch.save_html import save_html
from jukebox_tpu_torch.utils.audio_utils import save_wav
from jukebox_tpu_torch.utils.io import load_prompt
from jukebox_tpu_torch.utils import profiler
from jukebox_tpu_torch.utils.cli import fire
from jukebox_tpu_torch.utils.sample_utils import get_starts, split_batch


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
    z_samples = []
    with profiler.span(f"windows_l{level}"):
        for i, (z_i, zc_i, y_i) in enumerate(zip(
                split_batch(z, n_samples, max_batch_size),
                split_batch(z_conds, n_samples, max_batch_size),
                split_batch(y, n_samples, max_batch_size))):
            gen = _generator(device, hps.get("seed", 0), level,
                             start * 131 + i)
            out = prior.sample(n_samples=z_i.shape[0], z=to_dev(z_i),
                               z_conds=None if zc_i is None else
                               [to_dev(c) for c in zc_i],
                               y=to_dev(y_i), gen=gen, **kwargs)
            z_samples.append(out.cpu().numpy())
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
    device = next(prior.model.parameters()).device
    bs = zs[level].shape[0]
    with profiler.span("vqvae_decode"):
        x = prior.decode([torch.as_tensor(z, device=device)
                          for z in zs[level:]],
                         start_level=level, bs_chunks=max(1, -(-bs // 8)))
        x_np = x.float().cpu().numpy()
    with profiler.span("save"):
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
    with profiler.span("align"):
        return get_alignment(None, zs, labels[-1], top,
                             sampling_kwargs[-1].get("fp16", False), hps)


def _html_level(x, zs, labels, level, hps, alignments):
    with profiler.span("html"):
        save_html(f"{hps.name}/level_{level}", x, zs, labels[-1], alignments,
                  hps)


def _align_deferred(prior):
    """Whether the alignment waits until every level has sampled and
    decoded (the JAX package's rule: the top prior's parameters over 6e9
    bytes, the 5b tops), rather than overlapping the lower levels.
    JUKEBOX_ALIGN_DEFER=1/0 forces either way."""
    env = os.environ.get("JUKEBOX_ALIGN_DEFER")
    if env is not None:
        return env != "0"
    return sum(p.numel() * p.element_size()
               for p in prior.model.parameters()) > 6e9


def _on_device(fn, device):
    """fn for a worker thread: grad mode and the current CUDA device are
    per thread, so it runs under no_grad with `device` current. Every
    thread launches on the device's default stream: the decode and flash
    kernels' workspaces and counters are kept per device, and one stream
    runs their launches one after another."""
    def call(*args):
        with torch.no_grad():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            return fn(*args)
    return call


class _FinalizePipe:
    """The per-level tail (decode and save, the alignment, the html) on
    worker threads while the remaining levels sample, as jukebox_tpu's
    _FinalizePipe (sample.py:252): a level's decode/save runs on one
    worker in submit order; the alignment (one recording forward of the top
    prior, needed by every level's html) on a second pool after the top
    level's decode/save, once, or, deferred (_align_deferred), after every
    level has sampled and decoded; each level's html waits on its own
    decode and on the alignment. JUKEBOX_ASYNC_FINALIZE=0 runs it inline,
    in the caller's thread: decode and save, after the first level the
    alignment, then the html. A worker's failure raises in join; close()
    stops every worker, also after a failure.

    Each submit snapshots the codes and the sampling kwargs at the same
    logical point as the sequential scheduler's inline finalize: the level
    and the levels above as sampled, the levels below as they were before
    the run (the pipelined scheduler has started some of them by then), so
    every file is the same under either scheduler."""

    def __init__(self, zs, sample_levels, device):
        self._before = list(zs)
        self._sample_levels = set(sample_levels)
        self._device = device
        self._dec_pool = self._aux_pool = None
        if os.environ.get("JUKEBOX_ASYNC_FINALIZE", "1") != "0":
            self._dec_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="finalize")
            self._aux_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="align")
        self._align_fut = None
        self._tails, self._dec_futs = [], []
        self._inline_alignments, self._inline_done = None, False
        self._sampling_done = threading.Event()

    def _snapshot(self, zs, level):
        return [self._before[l] if l < level and l in self._sample_levels
                else zs[l] for l in range(len(zs))]

    def submit(self, zs, labels, sampling_kwargs, priors, level, hps):
        zs_snap = self._snapshot(zs, level)
        skw = [dict(s) for s in sampling_kwargs]
        if self._dec_pool is None:
            # decode and save first: it releases the level's staged decode
            # weights before the alignment's forward
            x = _decode_save_level(zs_snap, labels, skw, priors, level, hps)
            if not self._inline_done:
                self._inline_alignments = _compute_alignments(
                    zs_snap, labels, skw, priors, hps)
                self._inline_done = True
            _html_level(x, zs_snap, labels, level, hps,
                        self._inline_alignments)
            return
        run = functools.partial(_on_device, device=self._device)
        dec_fut = self._dec_pool.submit(run(_decode_save_level), zs_snap,
                                        labels, skw, priors, level, hps)
        self._dec_futs.append(dec_fut)
        if self._align_fut is None:
            # the first level finalized is the top, whose codes the
            # alignment reads
            top_dec, defer = dec_fut, _align_deferred(priors[-1])

            def align_work():
                top_dec.result()
                if defer:
                    # after sampling and every level's decode/save: by then
                    # every decode future exists
                    self._sampling_done.wait()
                    for f in list(self._dec_futs):
                        f.result()
                return _compute_alignments(zs_snap, labels, skw, priors, hps)
            self._align_fut = self._aux_pool.submit(run(align_work))
        align_fut = self._align_fut

        def html_work():
            _html_level(dec_fut.result(), zs_snap, labels, level, hps,
                        align_fut.result())
        self._tails.append(self._aux_pool.submit(run(html_work)))

    def join(self):
        """Wait for every level's tail; a worker's failure raises here."""
        self._sampling_done.set()
        for f in self._tails:
            f.result()

    def close(self):
        """Stop the workers (cancelling what has not started) and wait for
        them: no thread outlives the run."""
        self._sampling_done.set()
        for pool in (self._dec_pool, self._aux_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


class _StagePipe:
    """Stage the next level's decode weights (PriorRuntime.stage_decode) on
    one worker thread while the current level samples, one level ahead, as
    jukebox_tpu's _StagePipe (sample.py:357): ensure(level) waits until
    that level is staged, then starts the level below. On under the
    pipelined scheduler, which keeps every staged level on the card
    anyway; off under the sequential one (one level's weights at a time).
    JUKEBOX_ASYNC_STAGE=1/0 overrides either way. Only levels sampled in
    fp16 are staged (the fp32 path reads the parameters), and a level
    already staged keeps its mode, as PriorRuntime.sample does."""

    def __init__(self, priors, sample_levels, sampling_kwargs, device,
                 prestage=True):
        self._priors, self._skw = priors, sampling_kwargs
        self._order = list(reversed(sample_levels))  # top first
        self._futs = {}
        self._pool = None
        self._device = device
        env = os.environ.get("JUKEBOX_ASYNC_STAGE")
        if (env != "0") if env is not None else prestage:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="stager")

    def _stage(self, level):
        prior = self._priors[level]
        if self._skw[level].get("fp16", False) and prior.staged is None:
            prior.stage_decode()

    def ensure(self, level):
        """Wait until `level` is staged; start staging the next one."""
        with profiler.span("stage_wait"):
            fut = self._futs.get(level)
            if fut is not None:
                fut.result()
            else:
                self._stage(level)
        i = self._order.index(level)
        if self._pool is not None and i + 1 < len(self._order):
            nxt = self._order[i + 1]
            if nxt not in self._futs:
                self._futs[nxt] = self._pool.submit(
                    _on_device(self._stage, self._device), nxt)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def _level_plan(prior, level, hps):
    assert hps.sample_length % prior.raw_to_tokens == 0, \
        f"sample_length {hps.sample_length} not a multiple of {prior.raw_to_tokens}"
    total = hps.sample_length // prior.raw_to_tokens
    return total, int(hps.hop_fraction[level] * prior.n_ctx)


def _sample_sequential(zs, labels, sampling_kwargs, priors, sample_levels,
                       hps, device):
    fin = _FinalizePipe(zs, sample_levels, device)
    stager = _StagePipe(priors, sample_levels, sampling_kwargs, device,
                        prestage=False)
    try:
        for level in reversed(sample_levels):
            prior = priors[level]
            stager.ensure(level)
            total_length, hop_length = _level_plan(prior, level, hps)
            zs = sample_level(zs, labels[level], sampling_kwargs[level], level,
                              prior, total_length, hop_length, hps)
            fin.submit(zs, labels, sampling_kwargs, priors, level, hps)
        fin.join()
    finally:
        fin.close()
        stager.close()
    return zs


def _sample_pipelined(zs, labels, sampling_kwargs, priors, sample_levels,
                      hps, device):
    """The window-pipelined cascade (jukebox_tpu sample.py:433): an
    upsampler window [start, start + n_ctx) needs only the codes
    [0, (start + n_ctx) // cond_downsample) of the level above
    (get_z_conds), so it runs as soon as they exist instead of after the
    whole upper level; a partial window (a level shorter than n_ctx) waits
    for the whole upper level. The loop runs the deepest eligible window
    first. Each level's windows run in their sequential order with their
    own generators (keyed by seed, level and start), so the tokens equal
    the sequential scheduler's."""
    fin = _FinalizePipe(zs, sample_levels, device)
    stager = _StagePipe(priors, sample_levels, sampling_kwargs, device)
    state = {}
    for level in reversed(sample_levels):
        total, hop = _level_plan(priors[level], level, hps)
        n_ctx = priors[level].n_ctx
        windows = (list(get_starts(total, n_ctx, hop)) if total >= n_ctx
                   else [None])  # None: the partial window
        state[level] = dict(windows=windows, next=0, total=total,
                            staged=False, done=False)
    top = sample_levels[-1]

    def eligible(level):
        st = state[level]
        if st["next"] >= len(st["windows"]):
            return False
        if level == top:
            return True
        up = state[level + 1]
        start = st["windows"][st["next"]]
        if start is None:
            return up["next"] >= len(up["windows"])
        need = (start + priors[level].n_ctx) // priors[level].cond_downsample
        return zs[level + 1].shape[1] >= need

    def run_next(level):
        st, prior = state[level], priors[level]
        if not st["staged"]:
            stager.ensure(level)
            st["staged"] = True
        start = st["windows"][st["next"]]
        if start is None:
            new_zs = sample_partial_window(zs, labels[level],
                                           sampling_kwargs[level], level,
                                           prior, st["total"], hps)
        else:
            new_zs = sample_single_window(zs, labels[level],
                                          sampling_kwargs[level], level,
                                          prior, start, hps)
        st["next"] += 1
        return new_zs

    try:
        while any(st["next"] < len(st["windows"]) for st in state.values()):
            level = next((l for l in sample_levels if eligible(l)), None)
            assert level is not None, "pipeline stalled (no eligible window)"
            zs = run_next(level)
            for l in reversed(sample_levels):
                st = state[l]
                if st["next"] == len(st["windows"]) and not st["done"]:
                    st["done"] = True
                    fin.submit(zs, labels, sampling_kwargs, priors, l, hps)
        fin.join()
    finally:
        fin.close()
        stager.close()
    return zs


def _sample(zs, labels, sampling_kwargs, priors, sample_levels, hps):
    """Top-to-bottom cascade over sample_levels: sample a level, decode,
    save, align, html (sample.py:91-121). The pipelined scheduler by
    default, as the JAX package (sample.py:515-530); the sequential one
    with hps.pipeline_cascade=False or JUKEBOX_PIPELINE=0, or with one
    level to sample. Both give the same tokens and files. Each stage is
    a coarse span (utils/profiler.py totals(): windows_l<level>,
    vqvae_decode, save, align, html, stage_wait); those on worker threads
    overlap the sampling, so their sum can exceed the wall."""
    env = os.environ.get("JUKEBOX_PIPELINE")
    pipelined = hps.get("pipeline_cascade",
                        env != "0" if env is not None else True)
    device = next(priors[sample_levels[-1]].model.parameters()).device
    run = (_sample_pipelined if pipelined and len(sample_levels) > 1
           else _sample_sequential)
    return run(zs, labels, sampling_kwargs, priors, sample_levels, hps,
               device)


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
