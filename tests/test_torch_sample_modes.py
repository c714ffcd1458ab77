"""The port's sampling modes, loaders and sample CLI against jukebox_tpu on
the CPU, on the tiny family of tests/_torch_tiny.py (its top with lyric
alignment taps), the same weights on both sides:

* continue_sample, upsample and primed_sample at temp 0 (argmax) in fp32,
  the JAX side on its sequential scheduler (pipeline_cascade=False): the
  codes of every level equal; every level directory holds data.jkb, the
  wavs and the html with the alignment's PNG and JSON, the JSON within
  2e-3 of the JAX package's (both round the fp16 head to 3 decimals after
  dividing by its max);
* load_codes (with and without a duration cut) and load_prompts (a mono and
  a stereo wav that the port wrote) equal the JAX package's;
* the CLI: argv through both packages' fire and run, make_model patched to
  the tiny family, reaches the same mode function with the same codes or
  prompt, labels, sampling kwargs and hps; the port's run then samples the
  ancestral and the primed mode end to end on the CPU;
* the alignment's rules (none without taps or under JUKEBOX_SKIP_ALIGN=1,
  a failure raises) and the pipelined scheduler as the default.
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from _torch_tiny import META, TAPS, TOP, VQ, family
from jukebox_tpu import sample as jsample
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.utils import cli as jcli
from jukebox_tpu_torch import sample as tsample
from jukebox_tpu_torch.hparams import Hyperparams as THyperparams
from jukebox_tpu_torch.utils import cli as tcli
from jukebox_tpu_torch.utils import profiler
from jukebox_tpu_torch.utils.audio_utils import save_wav

torch.set_num_threads(1)
N = 2
PROMPT = 160  # samples: 10 top codes, 20 and 40 below


@pytest.fixture(scope="module")
def fam():
    return family(dict(TOP, **TAPS))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("JUKEBOX_SKIP_ALIGN", "JUKEBOX_PIPELINE", "JUKEBOX_INT8_DECODE"):
        monkeypatch.delenv(k, raising=False)


def codes(seed, lengths=(4 * PROMPT // 16, 2 * PROMPT // 16, PROMPT // 16)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VQ["l_bins"], (N, n)) for n in lengths]


def hps_pair(tmp_path):
    kw = dict(n_samples=N, sample_length=VQ["sample_length"], sr=VQ["sr"],
              hop_fraction=(0.5, 0.5, 0.125), seed=0)
    return (JHyperparams(levels=3, n_tokens=TOP["n_tokens"],
                         pipeline_cascade=False, name=str(tmp_path / "jax"),
                         **kw),
            THyperparams(name=str(tmp_path / "torch"), **kw))


def prompt_wav(tmp_path, channels=1, n=400):
    x = np.random.RandomState(3).uniform(-0.8, 0.8, (1, n, channels))
    save_wav(str(tmp_path / "prompt"), x, VQ["sr"])
    return str(tmp_path / "prompt" / "item_0.wav")


def check_outputs(name, levels=range(3), aligned=True):
    for level in levels:
        d = f"{name}/level_{level}"
        want = {"data.jkb"} | {f"item_{i}{ext}" for i in range(N)
                               for ext in (".wav", ".html")}
        if aligned:
            want |= {f"item_{i}_align{ext}" for i in range(N)
                     for ext in (".png", ".json")}
        assert want <= set(os.listdir(d)), d


@pytest.mark.parametrize("mode", ["continue", "upsample", "primed"])
def test_mode_codes_match_jax(fam, tmp_path, mode):
    _, jps, _, tps = fam
    jh, th = hps_pair(tmp_path)
    labels = [p.labeller.get_batch_labels([META] * N) for p in jps]
    skw = [dict(temp=0.0, fp16=False, chunk_size=8, max_batch_size=N)
           for _ in tps]
    if mode == "continue":
        first = codes(0)
        args_j = args_t = first
    elif mode == "upsample":
        top = codes(1, (VQ["sample_length"] // 16,))[0]
        first = [np.zeros((N, 0), np.int64)] * 2 + [top]
        args_j = args_t = first
    else:
        x = tsample.load_prompts([prompt_wav(tmp_path)], PROMPT, th)
        args_j, args_t = x.numpy(), x
    jfn, tfn = {"continue": (jsample.continue_sample, tsample.continue_sample),
                "upsample": (jsample.upsample, tsample.upsample),
                "primed": (jsample.primed_sample, tsample.primed_sample)}[mode]
    jzs = jfn([np.copy(a) for a in args_j] if mode != "primed" else args_j,
              labels, [dict(s) for s in skw], jps, jh)
    tzs = tfn([np.copy(a) for a in args_t] if mode != "primed" else args_t,
              labels, [dict(s) for s in skw], tps, th)
    for level in range(3):
        np.testing.assert_array_equal(tzs[level], np.asarray(jzs[level]),
                                      err_msg=f"level {level}")
        if mode != "primed":
            # the given codes stay where they were
            n = first[level].shape[1]
            np.testing.assert_array_equal(tzs[level][:, :n], first[level])
    assert tzs[0].shape == (N, VQ["sample_length"] // 4)
    levels = range(2) if mode == "upsample" else range(3)
    check_outputs(th.name, levels)
    for level in levels:
        for i in range(N):
            f = f"level_{level}/item_{i}_align.json"
            with open(f"{th.name}/{f}") as t, open(f"{jh.name}/{f}") as j:
                np.testing.assert_allclose(json.load(t), json.load(j),
                                           atol=2e-3)


def test_primed_keeps_prompt_codes(fam, tmp_path):
    _, _, _, tps = fam
    _, th = hps_pair(tmp_path)
    x = tsample.load_prompts([prompt_wav(tmp_path)], PROMPT, th)
    prompt = tps[-1].encode(x, start_level=0, end_level=3, bs_chunks=N)
    labels = [p.labeller.get_batch_labels([META] * N) for p in tps]
    skw = [dict(temp=0.99, fp16=False, chunk_size=8, max_batch_size=N)
           for _ in tps]
    zs = tsample.primed_sample(x, labels, skw, tps, th)
    for z, p in zip(zs, prompt):
        np.testing.assert_array_equal(z[:, :p.shape[1]], p.numpy())


@pytest.mark.parametrize("duration", [None, PROMPT])
def test_load_codes_matches_jax(fam, tmp_path, duration):
    _, jps, _, tps = fam
    path = str(tmp_path / "data.jkb")
    with open(path, "wb") as f:
        pickle.dump(dict(zs=codes(5, (128, 64, 32))), f)
    want = jsample.load_codes(path, duration, jps, JHyperparams(n_samples=N))
    got = tsample.load_codes(path, duration, tps, THyperparams(n_samples=N))
    assert [z.shape[1] for z in got] == (
        [128, 64, 32] if duration is None else [40, 20, 10])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("channels", [1, 2])
def test_load_prompts_matches_jax(tmp_path, channels):
    wav = prompt_wav(tmp_path, channels)
    want = jsample.load_prompts([wav], PROMPT, JHyperparams(sr=VQ["sr"],
                                                            n_samples=3))
    got = tsample.load_prompts([wav], PROMPT, THyperparams(sr=VQ["sr"],
                                                           n_samples=3))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, PROMPT, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _patch_models(monkeypatch, fam, jax_side=True):
    jvq, jps, tvq, tps = fam

    def tmake(model, hps, device="cuda", prior_overrides=None, levels=None):
        assert (model, device) == ("1b_lyrics", "cpu")
        hps.sample_length = VQ["sample_length"]
        return tvq, tps
    monkeypatch.setattr(tsample, "make_model", tmake)
    if jax_side:
        def jmake(model, device, hps, levels=None):
            hps.sample_length = VQ["sample_length"]
            return jvq, jps
        monkeypatch.setattr(jsample, "make_model", jmake)
        monkeypatch.setattr(jmm, "enable_warm_start", lambda: None)


def _argv(tmp_path, mode):
    argv = ["1b_lyrics", f"--name={tmp_path / 'out'}", f"--n_samples={N}",
            f"--sr={VQ['sr']}", "--total_sample_length_in_seconds=1",
            "--hop_fraction=0.5,0.5,0.125", "--levels=3", f"--mode={mode}"]
    if mode in ("continue", "upsample"):
        path = str(tmp_path / "codes.jkb")
        zs = codes(6, (128, 64, 32))
        if mode == "upsample":
            zs = [np.zeros((N, 0), np.int64)] * 2 + zs[2:]
        with open(path, "wb") as f:
            pickle.dump(dict(zs=zs), f)
        argv.append(f"--codes_file={path}")
        if mode == "continue":
            argv.append(f"--prompt_length_in_seconds={PROMPT / VQ['sr']}")
    if mode == "primed":
        argv += [f"--audio_file={prompt_wav(tmp_path)}",
                 f"--prompt_length_in_seconds={PROMPT / VQ['sr']}"]
    return argv


MODES = {"ancestral": "ancestral_sample", "continue": "continue_sample",
         "upsample": "upsample", "primed": "primed_sample"}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_dispatch_matches_jax(fam, tmp_path, monkeypatch, mode):
    _patch_models(monkeypatch, fam)
    calls = {}
    for pkg, mod in (("jax", jsample), ("torch", tsample)):
        for fn in MODES.values():
            def rec(*args, _pkg=pkg, _fn=fn):
                *first, labels, skw, _, hps = args
                calls[_pkg] = dict(fn=_fn, first=[np.asarray(a) for a in
                                                  (first[0] if first else [])],
                                   labels=labels, skw=skw, hps=dict(hps))
            monkeypatch.setattr(mod, fn, rec)
    argv = _argv(tmp_path, mode)
    jcli.fire(jsample.run, argv)
    tcli.fire(tsample.run, argv + ["--device=cpu"])
    j, t = calls["jax"], calls["torch"]
    assert t["fn"] == j["fn"] == MODES[mode]
    assert t["hps"] == j["hps"] and t["skw"] == j["skw"]
    assert t["skw"][-1]["chunk_size"] == 256  # the 1b_lyrics defaults
    assert t["skw"][-1]["max_batch_size"] == 16
    assert len(t["first"]) == len(j["first"])
    for a, b in zip(t["first"], j["first"]):
        np.testing.assert_array_equal(a, b)
    for tl, jl in zip(t["labels"], j["labels"]):
        np.testing.assert_array_equal(tl["y"], jl["y"])
        assert tl["info"] == jl["info"]


@pytest.mark.parametrize("mode", ["ancestral", "primed"])
def test_cli_runs_on_the_port(fam, tmp_path, monkeypatch, mode):
    _patch_models(monkeypatch, fam, jax_side=False)
    profiler.reset()
    tcli.fire(tsample.run, _argv(tmp_path, mode) + ["--device=cpu"])
    check_outputs(str(tmp_path / "out"))
    assert profiler.totals()["align"]["seconds"] > 0


def test_alignment_rules(fam, tmp_path, monkeypatch):
    _, _, _, tps = fam
    top = tps[-1]
    zs = codes(7, (128, 64, 32))
    labels = [p.labeller.get_batch_labels([META] * N) for p in tps]
    skw = [dict(fp16=False)] * 3
    th = THyperparams(name=str(tmp_path), hop_fraction=(0.5, 0.5, 0.125))
    got = tsample._compute_alignments(zs, labels, skw, tps, th)
    assert len(got) == N and got[0].shape[0] == 32
    monkeypatch.setenv("JUKEBOX_SKIP_ALIGN", "1")
    assert tsample._compute_alignments(zs, labels, skw, tps, th) is None
    monkeypatch.delenv("JUKEBOX_SKIP_ALIGN")
    no_taps = types.SimpleNamespace(n_tokens=8, labeller=top.labeller,
                                    alignment_layer=None, alignment_head=0)
    assert tsample._compute_alignments(zs, labels, skw, [no_taps], th) is None

    def boom(*a, **k):
        raise RuntimeError("recording forward failed")
    monkeypatch.setattr(tsample, "get_alignment", boom)
    with pytest.raises(RuntimeError, match="recording forward failed"):
        tsample._compute_alignments(zs, labels, skw, tps, th)


@pytest.mark.parametrize("pipeline", [True, None])
def test_pipelined_scheduler_is_the_default(fam, tmp_path, monkeypatch,
                                            pipeline):
    """pipeline_cascade=True, and hps without it, take the pipelined
    scheduler (tests/test_torch_pipeline.py holds what it samples)."""
    _, _, _, tps = fam
    taken = []
    monkeypatch.setattr(tsample, "_sample_pipelined",
                        lambda *a: taken.append("pipelined"))
    monkeypatch.setattr(tsample, "_sample_sequential",
                        lambda *a: taken.append("sequential"))
    kw = {} if pipeline is None else dict(pipeline_cascade=pipeline)
    th = THyperparams(n_samples=N, name=str(tmp_path), **kw)
    tsample.ancestral_sample(None, None, tps, th)
    tsample.upsample(None, None, None, tps[1:], th)  # one level: sequential
    assert taken == ["pipelined", "sequential"]
