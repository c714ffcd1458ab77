"""The port's training logger (jukebox_tpu_torch/utils/logger.py), which
writes TensorBoard event files by hand, against jukebox_tpu's Logger
(tensorboardX) on the CPU: the same calls into both, then both event files
parsed record by record with tensorboardX's protobufs (tag, step and value:
scalars to the bit, text to the string; every record's bytes after its
wall time equal), the port's CRCs checked, the port's file read by
tensorboard's EventAccumulator; the audio wavs byte for byte (the JAX
Logger writes wavs where soundfile is absent: the tests hide any module of
that name, which another test file may have put in sys.modules); Metrics
and init_logging's argv.txt; the JAX profiler's StepTimer, the port's span
recorder and trace."""

import glob
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from jukebox_tpu.utils import logger as jlog
from jukebox_tpu.utils import profiler as jprof
from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.utils import logger as tlog
from jukebox_tpu_torch.utils import profiler as tprof

@pytest.fixture(autouse=True)
def no_soundfile(monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", None)


CALLS = {
    "scalars": [("step",), ("scalar", "loss", 1.5), ("scalar", "bpd", 0.0),
                ("step",), ("scalar", "gn", -3.25e-7),
                ("scalar", "lg_loss_scale", 16.0),
                ("scalar", "a b/c:d", float(np.float32(np.pi))),
                ("scalar", "/lead", 1e30), ("iters", 2 ** 40),
                ("scalar", "far", 7.0)],
    "text": [("step",), ("text", "train_y_in",
                         "0 artist:dianne reeves, genre:bebop, lyrics:ü\n"),
             ("text", "empty", ""), ("scalar", "loss", 2.0),
             ("text", "sample_x_T1", "x" * 300)],
    "audio": [("step",), ("audio", "train_x_in", 8000, None, 8, 3),
              ("audio", "sample_x_T1", 8000, 1, 2, 4),
              ("scalar", "loss", 0.5)],
}


def _drive(logger, calls):
    rng = np.random.RandomState(0)
    for call in calls:
        kind, args = call[0], call[1:]
        if kind == "step":
            logger.step()
        elif kind == "iters":
            logger.iters = args[0]
        elif kind == "scalar":
            logger.add_scalar(*args)
        elif kind == "text":
            logger.add_text(*args)
        else:
            tag, sr, max_len, max_log, n = args
            auds = (1.2 * rng.uniform(-1, 1, (n, 2 * sr, 1))).astype(
                np.float32)
            logger.add_audios(tag, auds, sr, max_len=max_len,
                              max_log=max_log)
    logger.flush()


def _parse(path):
    from tensorboardX.proto import event_pb2
    out = []
    for rec in tlog.read_records(path):
        ev = event_pb2.Event()
        ev.ParseFromString(rec)
        out.append((ev, rec))
    return out


@pytest.mark.parametrize("case", list(CALLS))
def test_events_and_audio_match_jax(tmp_path, case):
    jl = jlog.Logger(str(tmp_path / "jax"))
    tl = tlog.Logger(str(tmp_path / "port"))
    _drive(jl, CALLS[case])
    _drive(tl, CALLS[case])
    jl.sw.close()
    tl.close()
    jpath, = glob.glob(str(tmp_path / "jax" / "logs" / "events.out.*"))
    tpath, = glob.glob(str(tmp_path / "port" / "logs" / "events.out.*"))
    assert os.path.basename(tpath).split(".")[-1] == \
        os.path.basename(jpath).split(".")[-1]  # the host's name
    j, t = _parse(jpath), _parse(tpath)
    assert len(t) == len(j) > 1
    assert t[0][0].file_version == j[0][0].file_version == "brain.Event:2"
    for (ej, rj), (et, rt) in zip(j, t):
        assert et.step == ej.step
        assert [v.tag for v in et.summary.value] == \
            [v.tag for v in ej.summary.value]
        for vt, vj in zip(et.summary.value, ej.summary.value):
            if vj.WhichOneof("value") == "simple_value":
                assert struct.pack("<f", vt.simple_value) == \
                    struct.pack("<f", vj.simple_value)
            else:
                assert vt.tensor.string_val == vj.tensor.string_val
                assert vt.metadata == vj.metadata
        # the same bytes after the wall time (field 1, 9 bytes)
        assert rt[9:] == rj[9:]
    jaud = sorted(glob.glob(str(tmp_path / "jax" / "audio" / "*.wav")))
    taud = sorted(glob.glob(str(tmp_path / "port" / "audio" / "*.wav")))
    assert [os.path.basename(p) for p in taud] == \
        [os.path.basename(p) for p in jaud]
    if case == "audio":
        assert len(taud) == 5
    for a, b in zip(taud, jaud):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_crc_and_tensorboard_reads_the_port_file(tmp_path):
    tl = tlog.Logger(str(tmp_path))
    _drive(tl, CALLS["scalars"] + CALLS["text"])
    tl.close()
    path, = glob.glob(str(tmp_path / "logs" / "events.out.*"))
    # CRC-32C of the standard check string
    assert tlog.crc32c(b"123456789") == 0xE3069283
    recs = tlog.read_records(path)
    data = bytearray(open(path, "rb").read())
    data[20] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        tlog.read_records(str(bad))
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(tmp_path / "logs"))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [
        (1, 1.5), (2 ** 40 + 1, 2.0)]
    assert [e.step for e in acc.Scalars("far")] == [2 ** 40]
    text = acc.Tensors("train_y_in/text_summary")[0]
    assert text.tensor_proto.string_val[0].decode().startswith(
        "0 artist:dianne reeves")
    assert len(recs) == 1 + sum(c[0] in ("scalar", "text") for c in
                                CALLS["scalars"] + CALLS["text"])


def test_metrics_and_init_logging(tmp_path, monkeypatch):
    jm, tm = jlog.Metrics(), tlog.Metrics()
    for tag, val, n in [("loss", 1.0, 4), ("loss", 2.5, 2), ("gn", 3, 1)]:
        assert tm.update(tag, val, n) == jm.update(tag, val, n)
    assert (tm.sum, tm.n) == (jm.sum, jm.n)
    assert tm.avg("missing") == jm.avg("missing") == 0.0
    tm.reset()
    assert tm.sum == tm.n == {}
    monkeypatch.setattr(sys, "argv", ["train.py", "--hps=small_prior"])
    hps = Hyperparams(local_logdir=str(tmp_path), name="run")
    logger, metrics = tlog.init_logging(hps, 0, 0)
    assert (tmp_path / "run" / "argv.txt").read_text() == \
        "train.py --hps=small_prior"
    assert logger.logdir == str(tmp_path / "run")
    assert isinstance(metrics, tlog.Metrics)
    assert list(logger.get_range([5, 6], total=2)) == [(0, 5), (1, 6)]
    logger.close_range()
    assert tlog.get_range is not None and tlog.def_tqdm([1]) is not None


def test_step_timer_and_trace(tmp_path):
    timer = jprof.StepTimer(skip_first=1)
    for _ in range(3):
        with timer:
            pass
    assert len(timer.times) == 2 and timer.summary().startswith("steps=2 ")
    # the port times steps with the recorder's coarse spans
    tprof.reset()
    for _ in range(3):
        with tprof.span("step"):
            pass
    tot = tprof.totals()["step"]
    assert tot["calls"] == 3
    assert 0 <= tot["min"] <= tot["max"] <= tot["seconds"]
    path = None
    tprof.start_trace(str(tmp_path / "trace"))
    try:
        with tprof.span("traced"):
            torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    finally:
        path = tprof.stop_trace()
    assert glob.glob(str(tmp_path / "trace" / "*.json")) == [path]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert "aten::matmul" in {e.get("name") for e in events}
    assert any(e.get("name") == "traced"
               and e.get("cat") == "user_annotation" for e in events)
    # torch.profiler off: a fine span records nothing
    with tprof.fine("off"):
        pass
    assert [sp.name for sp in tprof.traced()["spans"]] == ["traced"]
    tprof.reset()


@pytest.mark.parametrize("case", list(CALLS))
def test_read_events_as_tensorboardx_parses(tmp_path, case):
    """utils/logger.py read_events, the reader chip_smoke.py checks event
    files with on the card (no protobuf package there), against
    tensorboardX's parse of the JAX Logger's file."""
    jl = jlog.Logger(str(tmp_path))
    _drive(jl, CALLS[case])
    jl.sw.close()
    path, = glob.glob(str(tmp_path / "logs" / "events.out.*"))
    want = []
    for ev, _ in _parse(path):
        for v in ev.summary.value:
            want.append((ev.step, v.tag, v.simple_value
                         if v.WhichOneof("value") == "simple_value"
                         else v.tensor.string_val[0].decode()))
    assert tlog.read_events(path) == want
