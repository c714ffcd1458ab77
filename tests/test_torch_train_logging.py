"""The port's training loop with its logger (jukebox_tpu_torch/train.py,
utils/logger.py, utils/profiler.py) against jukebox_tpu/train.py run on the
CPU: a tiny labelled lyric prior (single_enc_dec, 2 layers at width 16,
n_ctx 16 after 8 lyric tokens, fp32, host EMA every step) restored in both
packages from the same .jkb checkpoints (a VQ-VAE with a random codebook,
the prior's weights), trained for two steps on the same wavs with one
evaluation, with JUKEBOX_TRAIN_JSONL set. The JAX run's dataset gets the
same fixed metadata as the port's FixedMetadataDataset.

* JSONL: the same steps and keys, each value within the train step's fp32
  tolerance (1e-5 absolute or relative, test_torch_train_step.py);
* events: the same tags at the same steps, and the scalars within the same
  tolerance; the port's file passes its CRCs;
* audio: the same file names (train_x_in at step 1, sample_x_T1 at step
  1), the port's sample of the right length;
* sample_prior samples under the EMA weights and leaves the params bit for
  bit as they were;
* debug_speed writes a Chrome trace of step 3.
"""

import glob
import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from jukebox_tpu import train as jtrain
from jukebox_tpu.data import files_dataset as jfd
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.utils import logger as jlog
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import train as ttrain
from jukebox_tpu_torch.data.files_dataset import FixedMetadataDataset
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils import logger as tlog

from test_torch_train import VQ

torch.set_num_threads(1)
ARTIST, GENRE, LYRICS = "dianne reeves", "bebop", "la la la, oh la la"
TOP = dict(level=2, n_ctx=16, prior_width=16, prior_depth=2, heads=2,
           attn_order=12, blocks=4, init_scale=0.7, labels=True,
           labels_v3=True, y_bins=(10, 100), t_bins=16, max_bow_genre_size=1,
           n_vocab=79, min_duration=0.0, max_duration=600.0, use_tokens=True,
           n_tokens=8, prime_loss_fraction=0.4, single_enc_dec=True, sr=8000,
           prior=True, train=True, lr=1e-3, lr_warmup=1.0, weight_decay=0.01)
# bs 8: the JAX package's batch shards over the tests' 8 CPU devices
RUN = dict(bs=8, max_steps=2, log_steps=1, save_iters=2, test=True,
           train_test_split=0.5, ema=True, cpu_ema=True, cpu_ema_freq=1,
           mu=0.99, name="run")


def _write_wavs(d, n=2, seconds=1.0):
    for i in range(n):
        t = np.arange(int(seconds * 8000)) / 8000
        sig = 0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        pcm = (np.stack([sig, 0.8 * sig], axis=1) * 32767).astype("<i2")
        with wave.open(str(d / f"f{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(pcm.tobytes())


def _kw(root, which, **over):
    kw = dict(VQ, **RUN, audio_files_dir=str(root / "wavs"),
              restore_vqvae=str(root / "checkpoint_vq.jkb"),
              restore_prior=str(root / "checkpoint_prior.jkb"),
              local_logdir=str(root / which))
    kw.update(TOP)
    kw.update(over)
    return kw


def _events(logdir):
    """[(tag, step, value or text)] of the event file under logdir/logs,
    its first record (the file version) left out; CRCs checked."""
    from tensorboardX.proto import event_pb2
    path, = glob.glob(os.path.join(logdir, "logs", "events.out.tfevents.*"))
    out = []
    for rec in tlog.read_records(path)[1:]:
        ev = event_pb2.Event()
        ev.ParseFromString(rec)
        for v in ev.summary.value:
            val = (v.simple_value if v.WhichOneof("value") == "simple_value"
                   else v.tensor.string_val[0].decode())
            out.append((v.tag, ev.step, val))
    return out


def _close(a, b):
    if isinstance(a, str):
        return a == b
    return abs(a - b) <= 1e-5 * max(1.0, abs(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    (root / "wavs").mkdir()
    _write_wavs(root / "wavs")
    # the shared start: a VQ-VAE with a random codebook and a prior
    hps = thp.setup_hparams("teeny", _kw(root, "init", restore_vqvae="",
                                         restore_prior=""))
    vq = tmm.make_vqvae(hps, "cpu")
    tmm.save_model_checkpoint(str(root), "vq", tmm.VQVAERuntime(vq), None, 0,
                              hps)
    tmm.save_model_checkpoint(str(root), "prior", tmm.make_prior(hps, vq,
                                                                 "cpu"),
                              None, 0, hps)
    out, loggers = {}, []

    class Logger(jlog.Logger):  # keeps the JAX run's writer to flush it
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loggers.append(self)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX Logger writes wavs without soundfile (hidden here, in case
        # another test file put a module of that name in sys.modules)
        mp.setitem(sys.modules, "soundfile", None)
        mp.setattr(jmm, "enable_warm_start", lambda *a, **k: None)
        mp.setattr(jlog, "Logger", Logger)
        mp.setattr(jfd.FilesAudioDataset, "get_metadata",
                   lambda self, filename, test: (ARTIST, GENRE, LYRICS))
        for which in ("jax", "port"):
            jsonl = root / f"{which}.jsonl"
            mp.setenv("JUKEBOX_TRAIN_JSONL", str(jsonl))
            kw = _kw(root, which)
            if which == "jax":
                jtrain.run("teeny", **kw)
                loggers[0].sw.close()
            else:
                h = thp.setup_hparams("teeny", kw)
                out["port"] = ttrain.run(
                    "teeny", device="cpu",
                    dataset=FixedMetadataDataset(h, ARTIST, GENRE, LYRICS),
                    **kw)
            out[which + "_jsonl"] = [json.loads(line) for line in
                                     jsonl.read_text().splitlines()]
            out[which + "_dir"] = str(root / which / "run")
    out["root"] = root
    return out


def test_jsonl_matches_jax(runs):
    j, t = runs["jax_jsonl"], runs["port_jsonl"]
    assert [r["it"] for r in t] == [r["it"] for r in j] == [1, 2]
    for rj, rt in zip(j, t):
        assert rt.keys() == rj.keys()
        assert set(rt) >= {"it", "wall_s", "window_s", "loss", "bpd", "gn",
                           "lr", "prime_loss", "gen_loss"}
        for k in rj:
            if k not in ("wall_s", "window_s"):
                assert _close(rt[k], rj[k]), (rt["it"], k, rt[k], rj[k])


def test_events_match_jax(runs):
    j, t = _events(runs["jax_dir"]), _events(runs["port_dir"])
    assert [(tag, step) for tag, step, _ in t] == \
        [(tag, step) for tag, step, _ in j]
    tags = {tag for tag, _, _ in t}
    assert {"loss", "gn", "lr", "test_loss", "test_bpd",
            "train_y_in/text_summary",
            "sample_x_T1/text_summary"} <= tags
    for (tag, step, a), (_, _, b) in zip(t, j):
        assert _close(a, b), (tag, step, a, b)
    # the labels' text names the artist and genre of the dataset
    txt = dict(((tag, s), v) for tag, s, v in t)[("train_y_in/text_summary",
                                                  1)]
    assert f"artist:{ARTIST}, genre:{GENRE}" in txt


def test_audio_and_argv_files(runs):
    names = {which: sorted(os.listdir(os.path.join(runs[which + "_dir"],
                                                   "audio")))
             for which in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert {f"sample_x_T1_{i}_it1.wav" for i in range(8)} <= set(
        names["port"])
    assert {f"train_x_in_{i}_it1.wav" for i in range(8)} <= set(
        names["port"])
    rt = runs["port"]["runtime"]
    with wave.open(os.path.join(runs["port_dir"], "audio",
                                "sample_x_T1_0_it1.wav")) as w:
        assert w.getnframes() == rt.n_ctx * rt.raw_to_tokens
        assert w.getsampwidth() == 2
    assert os.path.exists(os.path.join(runs["port_dir"], "argv.txt"))
    # the step record of step 1 times its sample
    assert runs["port"]["records"][0]["sample_s"] > 0


def test_sample_prior_under_ema_restores_params(runs, tmp_path):
    out = runs["port"]
    rt, ema = out["runtime"], out["ema"]
    hps = thp.setup_hparams("teeny", _kw(runs["root"], "swap"))
    hps.bs_sample = 2
    before = {n: p.detach().clone() for n, p in rt.params.items()}
    assert any(not np.array_equal(before[n].numpy(), ema.shadow[n])
               for n in before)
    seen = {}
    real = rt.sample

    def sample(*a, **k):
        seen.update({n: p.detach().clone() for n, p in rt.params.items()})
        return real(*a, **k)
    rt.sample = sample
    logger = tlog.Logger(str(tmp_path / "swap"))
    x = torch.rand((2, hps.sample_length, 1)) * 2 - 1
    y = torch.as_tensor(rt.get_y(rt.labeller.get_batch_labels(
        [dict(artist=ARTIST, genre=GENRE, lyrics=LYRICS,
              total_length=8000 * 30, offset=0)] * 2), 0))
    try:
        z, x_out = ttrain.sample_prior(rt, ema, logger, x, y, hps,
                                       torch.Generator().manual_seed(0))
    finally:
        del rt.sample
    assert z.shape == (2, rt.n_ctx) and int(z.min()) >= 0
    assert int(z.max()) < rt.l_bins
    assert x_out.shape == x.shape and bool(torch.isfinite(x_out).all())
    for n, p in rt.params.items():
        assert torch.equal(p, before[n]), n
        np.testing.assert_array_equal(seen[n].numpy(), ema.shadow[n])
    assert sorted(os.listdir(tmp_path / "swap" / "audio")) == [
        "sample_x_T1_0_it0.wav", "sample_x_T1_1_it0.wav"]


def test_debug_speed_writes_a_trace(runs, tmp_path):
    kw = _kw(runs["root"], "trace", max_steps=3, test=False, debug_speed=True,
             debug_iters=1)
    h = thp.setup_hparams("teeny", kw)
    out = ttrain.run("teeny", device="cpu",
                     dataset=FixedMetadataDataset(h, ARTIST, GENRE, LYRICS),
                     **kw)
    assert [r["it"] for r in out["records"]] == [1, 2, 3]
    traces = glob.glob(str(runs["root"] / "trace" / "run" / "trace" /
                           "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"aten::matmul", "BmmBackward0"} <= names  # a forward, a backward
