"""The per-layer metrics that read the port's own recorder
(benchmark/recorder.py over jukebox_tpu_torch/utils/profiler.py), from a
tiny traced CPU run of each driver: numbers where the CPU records them
(the token loop's spans, the prefill, the model builds), None where it
cannot (no wrapper launches a kernel on the CPU); and None from a port
that has no recorder, as the parent of the change that added it."""

import pytest

from benchmark import common, harness
from benchmark.tests import _tiny
from jukebox_tpu_torch.utils import profiler

NEW = ("launch_host_us.sample", "layers_host_ms.sample",
       "head_host_ms.sample", "prefill_s.sample", "model_build_s.sample",
       "model_build_s.train")


@pytest.fixture(autouse=True)
def fresh():
    profiler.reset()
    yield
    profiler.reset()


def _traced(tmp_path, cell, seed):
    base, bench = _tiny.tree(tmp_path)
    return harness.run(bench, cell, seed, 0.3, 1, "cpu", common.now(),
                       base=base)["metrics"]


def test_a_traced_decode_reads_the_program_spans(tmp_path):
    m = _traced(tmp_path, "top.tiny", 2 ** 33 + 4321)
    for name in ("layers_host_ms.sample", "head_host_ms.sample",
                 "prefill_s.sample", "model_build_s.sample"):
        assert m[name]["value"] > 0, name
    assert "launch_host_us.sample" not in m  # the CPU's plain paths
    assert "model_build_s.train" not in m
    steps = [s for s in profiler.traced()["spans"]
             if s.name == "sample.step"]
    assert steps and len(steps) == sum(
        1 for s in profiler.traced()["spans"] if s.name == "sample.layers")
    tot = profiler.totals()
    # set-up's first window and the window's: every prefill has its tail
    assert tot["sample.prefill"]["calls"] >= 1
    assert tot["sample.prefill_tail"]["calls"] == tot["sample.prefill"][
        "calls"]


def test_a_traced_training_step_reads_the_model_build(tmp_path):
    m = _traced(tmp_path, "train.tiny", 2 ** 33 + 8765)
    assert m["model_build_s.train"]["value"] > 0
    assert not set(NEW[:-1]) & set(m)


def test_without_the_recorder_every_new_metric_reads_none(monkeypatch):
    for name in ("traced", "totals"):
        monkeypatch.delattr(profiler, name)
    for name in NEW:
        assert common.load_module("metrics", name).read(None) is None, name
