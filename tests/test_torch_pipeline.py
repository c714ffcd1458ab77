"""The port's cascade schedulers on the CPU, on the tiny 3-level family of
tests/_torch_tiny.py (its lyric top with alignment taps) at 1024 samples
and hop fractions 0.5, 0.5, 0.125, so that every level samples several
windows (4 at the top, 7 and 15 below):

* the pipelined scheduler (the default) gives the sequential scheduler's
  tokens at temp 0.99, and every level's data.jkb, wavs, html and
  alignment PNG / JSON byte for byte, under the async and the inline
  finalize (JUKEBOX_ASYNC_FINALIZE=0), with the staging thread
  (JUKEBOX_ASYNC_STAGE=1) and with the alignment deferred
  (JUKEBOX_ALIGN_DEFER=1);
* its window order interleaves the levels: a level-1 window runs before
  the top's last one, and a level-0 window before level 1's last;
* at temp 0 its codes equal the JAX package's pipelined cascade;
* a failure in a window, in a finalize worker or in the alignment raises in
  the caller;
* threading.enumerate() is the same before and after every run;
* the launch counts and stage seconds that the workers share lose no
  update under threads.
"""

import os
import threading

import numpy as np
import pytest
import torch

from _torch_tiny import META, TAPS, TOP, VQ, family
from jukebox_tpu import sample as jsample
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu_torch import sample as tsample
from jukebox_tpu_torch.hparams import Hyperparams as THyperparams
from jukebox_tpu_torch.utils import profiler

torch.set_num_threads(1)
N, LENGTH, HOPS = 2, 1024, (0.5, 0.5, 0.125)
ENV = ("JUKEBOX_PIPELINE", "JUKEBOX_ASYNC_FINALIZE", "JUKEBOX_ASYNC_STAGE",
       "JUKEBOX_ALIGN_DEFER", "JUKEBOX_SKIP_ALIGN", "JUKEBOX_INT8_DECODE")


@pytest.fixture(scope="module")
def fam():
    return family(dict(TOP, **TAPS))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def labels_of(priors):
    return [p.labeller.get_batch_labels([META] * N) for p in priors]


def skw(temp=0.99):
    return [dict(temp=temp, fp16=False, chunk_size=8, max_batch_size=N)
            for _ in range(3)]


def run_port(tps, name, temp=0.99, **hps):
    """The port's ancestral cascade; returns (zs, the threads it left)."""
    before = set(threading.enumerate())
    try:
        zs = tsample.ancestral_sample(
            labels_of(tps), skw(temp), tps,
            THyperparams(n_samples=N, sample_length=LENGTH, sr=VQ["sr"],
                         hop_fraction=HOPS, seed=0, name=name, **hps))
    finally:
        left = set(threading.enumerate()) - before
    return zs, left


def files(name):
    """{relative path: bytes} of every file a run wrote."""
    out = {}
    for root, _, fs in os.walk(name):
        for f in fs:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, name)] = fh.read()
    return out


@pytest.fixture(scope="module")
def reference(fam, tmp_path_factory):
    """The sequential scheduler with the inline finalize."""
    _, _, _, tps = fam
    name = str(tmp_path_factory.mktemp("ref") / "out")
    os.environ["JUKEBOX_ASYNC_FINALIZE"] = "0"
    try:
        zs, left = run_port(tps, name, pipeline_cascade=False)
    finally:
        del os.environ["JUKEBOX_ASYNC_FINALIZE"]
    assert not left
    return zs, files(name)


@pytest.mark.parametrize("pipeline,env", [
    (None, {}),
    (None, {"JUKEBOX_ASYNC_FINALIZE": "0"}),
    (None, {"JUKEBOX_ALIGN_DEFER": "1"}),
    (False, {}),
    (False, {"JUKEBOX_ASYNC_STAGE": "1", "JUKEBOX_ALIGN_DEFER": "1"}),
], ids=["pipelined-async", "pipelined-inline", "pipelined-defer",
        "sequential-async", "sequential-stage-defer"])
def test_schedulers_give_the_same_codes_and_files(fam, reference, tmp_path,
                                                  monkeypatch, pipeline,
                                                  env):
    _, _, _, tps = fam
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    order = []
    window = tsample.sample_single_window

    def record(zs, labels, sampling_kwargs, level, prior, start, hps):
        order.append(level)
        return window(zs, labels, sampling_kwargs, level, prior, start, hps)
    monkeypatch.setattr(tsample, "sample_single_window", record)
    hps = {} if pipeline is None else dict(pipeline_cascade=pipeline)
    name = str(tmp_path / "out")
    zs, left = run_port(tps, name, **hps)
    assert not left, left
    ref_zs, ref_files = reference
    assert [z.shape[1] for z in zs] == [LENGTH // 4, LENGTH // 8,
                                        LENGTH // 16]
    for level in range(3):
        np.testing.assert_array_equal(zs[level], ref_zs[level],
                                      err_msg=f"level {level}")
    got = files(name)
    assert sorted(got) == sorted(ref_files)
    assert len(got) == 3 * (1 + 4 * N)  # data.jkb, wav, html, png, json
    for path, data in ref_files.items():
        assert got[path] == data, path
    assert [order.count(level) for level in range(3)] == [15, 7, 4]
    last = {level: len(order) - 1 - order[::-1].index(level)
            for level in range(3)}
    interleaved = (order.index(1) < last[2] and order.index(0) < last[1])
    assert interleaved == (pipeline is None), order


def test_temp0_matches_jax_pipelined(fam, tmp_path):
    _, jps, _, tps = fam
    jzs = jsample.ancestral_sample(
        labels_of(jps), skw(0.0), jps,
        JHyperparams(n_samples=N, sample_length=LENGTH, sr=VQ["sr"],
                     hop_fraction=HOPS, seed=0, levels=3,
                     n_tokens=TOP["n_tokens"], pipeline_cascade=True,
                     name=str(tmp_path / "jax")))
    tzs, left = run_port(tps, str(tmp_path / "torch"), temp=0.0)
    assert not left
    for level in range(3):
        np.testing.assert_array_equal(tzs[level], np.asarray(jzs[level]),
                                      err_msg=f"level {level}")


def _fail_after(fn, n, exc):
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(1)
        if len(calls) > n:
            raise exc
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("where", ["window", "decode", "html", "align"])
@pytest.mark.parametrize("pipeline", [None, False])
def test_failures_raise_in_the_caller(fam, tmp_path, monkeypatch, where,
                                      pipeline):
    _, _, _, tps = fam
    err = RuntimeError(f"planted {where} failure")
    if where == "window":  # the second level-1 window
        monkeypatch.setattr(tps[1], "sample",
                            _fail_after(tps[1].sample, 1, err))
    elif where == "decode":  # the second level's wav
        monkeypatch.setattr(tsample, "save_wav",
                            _fail_after(tsample.save_wav, 1, err))
    elif where == "html":
        monkeypatch.setattr(tsample, "save_html",
                            _fail_after(tsample.save_html, 0, err))
    else:
        monkeypatch.setattr(tsample, "get_alignment",
                            _fail_after(tsample.get_alignment, 0, err))
    before = set(threading.enumerate())
    hps = {} if pipeline is None else dict(pipeline_cascade=pipeline)
    with pytest.raises(RuntimeError, match=f"planted {where} failure"):
        run_port(tps, str(tmp_path / "out"), **hps)
    assert set(threading.enumerate()) == before


def test_counts_are_exact_under_threads(monkeypatch):
    """Kernel launch counts (ops/_build.py count) and the recorder's coarse
    totals and counters (utils/profiler.py) are read-modify-writes shared
    by the sampling thread and the finalize and staging workers: with more
    threads than cores (and at least 8) and a short switch interval no
    update is lost."""
    import sys
    import types

    from jukebox_tpu_torch.ops import _build
    launches = {"k": 0}
    n_threads, n = max(8, 4 * (os.cpu_count() or 1)), 2000
    # each thread's clock reads 0, then 1 s, in turn: every span is 1 s
    local = threading.local()

    def time_ns():
        local.n = getattr(local, "n", 0) + 1
        return 0 if local.n % 2 else 10 ** 9
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(
        time_ns=time_ns))
    # fine counters record while torch.profiler records
    monkeypatch.setattr(profiler._autograd_profiler, "_is_profiler_enabled",
                        True)
    profiler.reset()

    def work():
        for _ in range(n):
            _build.count(launches, "k")
            with profiler.span("x"):
                pass
            profiler.add("c", 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launches["k"] == n_threads * n
    assert profiler.totals()["x"] == dict(calls=n_threads * n,
                                          seconds=n_threads * n, min=1.0,
                                          max=1.0)
    assert profiler.traced()["counters"]["c"] == dict(calls=n_threads * n,
                                                      ns=3 * n_threads * n)
    profiler.reset()
