"""The level-0 upsampler's cell on the CPU at a tiny size: the upsampler
reference (conditioner included) against the port's forward and its
Conditioner; the driver end to end across a window boundary, correct;
each planted fault (the conditioner's, the token loop's feed, a stale
cache at the boundary) not correct by the limit it fails; a traced run's
metrics, x_cond_s.up0 from the port's new sample.x_cond span among them.
tests/test_torch_upsampler_bench.py runs these in the port's CPU suite
too."""

import subprocess
import sys
import types

import pytest
import torch

from benchmark import common, harness, weights
from benchmark.drivers import upsampler_windows as uw
from benchmark.reference import upsampler as ref
from benchmark.tests import _tiny_up0
from jukebox_tpu_torch.models import prior as port_prior
from jukebox_tpu_torch.utils import profiler

SEED = 2 ** 34 + 97531


def _program_and_weights(seed):
    cfg = _tiny_up0.config()
    dev = torch.device("cpu")
    _, rt = uw.build_program(cfg, dev)
    uw.load_weights(rt, cfg, seed, dev)
    w = weights.draw(ref.layout(cfg), common.derive(seed, 1), dev,
                     cfg["hparams"]["init_scale"])
    return cfg, rt.model, w


def _inputs(hp, B=2):
    gen = torch.Generator().manual_seed(0)
    n_up = hp["n_ctx"] // uw.cond_downsample(hp)
    z = torch.randint(0, hp["l_bins"], (B, hp["n_ctx"]), generator=gen)
    z_up = torch.randint(0, hp["l_bins"], (B, n_up), generator=gen)
    y = torch.cat([torch.full((B, 1), 10_000_000), torch.full((B, 1), 0),
                   torch.full((B, 1), hp["n_ctx"] * 8),
                   torch.randint(0, hp["y_bins"][1], (B, 1), generator=gen),
                   torch.randint(0, hp["y_bins"][0], (B, 5), generator=gen)],
                  1)
    y[0, 6:] = -1
    return z, z_up, y


def test_upsampler_reference_x_cond_equals_the_port_conditioner():
    cfg, model, w = _program_and_weights(11)
    _, z_up, _ = _inputs(cfg["hparams"])
    with torch.no_grad():
        want = model.conditioner_blocks[0](z_up)
        got = ref.x_cond(w, cfg, z_up)
    assert got.shape == want.shape == (2, cfg["hparams"]["n_ctx"],
                                       cfg["hparams"]["prior_width"])
    assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()),
                          rtol=0)


def test_upsampler_reference_logits_equal_the_port_forward():
    cfg, model, w = _program_and_weights(7)
    z, z_up, y = _inputs(cfg["hparams"])
    with torch.no_grad():
        want = model.forward(z, [z_up], y)
        got = ref.logits(w, cfg, z, z_up, y)
        part = ref.logits(w, cfg, z[:, :-5], z_up, y)
    scale = float(want.abs().max())
    assert torch.allclose(got, want, atol=1e-5 * scale, rtol=0)
    # a padded stream leaves the logits before the padding as they were
    assert torch.allclose(part[:, :-5], got[:, :-5], atol=1e-6 * scale,
                          rtol=0)


def _run(tmp_path, **driver_kwargs):
    base, bench = _tiny_up0.tree(tmp_path)
    return harness.run(bench, "up0.tiny", SEED, 0.3, 0, "cpu", common.now(),
                       driver_kwargs=driver_kwargs, base=base)


def test_a_sound_upsampler_run_crosses_a_window_and_is_correct(tmp_path):
    profiler.reset()
    out = _run(tmp_path)
    assert out["correct"], out["checks"]
    # set-up's window and at least one the window started
    batch = _tiny_up0.UP0_TRAFFIC["batch"]
    assert out["attempted"] >= 2 * batch
    tot = profiler.totals()
    assert tot["sample.x_cond"]["calls"] == tot["sample.init"]["calls"] >= 2


def _stale_cache(monkeypatch):
    """Every window after the first decodes on the first window's caches,
    as that window left them, in place of its own prefilled ones."""
    real = port_prior.SimplePrior.sample_init
    first = []

    def sample_init(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if not first:
            first.append(out[0])
            return out
        return (first[0], *out[1:])
    monkeypatch.setattr(port_prior.SimplePrior, "sample_init", sample_init)


@pytest.mark.parametrize("fault,number", [("x_cond_late", "logit_err"),
                                          ("x_cond_no_ln", "logit_err"),
                                          ("tok_late", "logit_err"),
                                          (_stale_cache, "logit_err")])
def test_a_planted_upsampler_fault_is_not_correct(tmp_path, monkeypatch,
                                                  fault, number):
    if callable(fault):
        fault(monkeypatch)
        out = _run(tmp_path)
    else:
        out = _run(tmp_path, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_programs_int8_decode_is_not_correct_at_the_upsampler(tmp_path):
    out = _run(tmp_path, quantize="int8")
    assert not out["correct"], out["checks"]
    assert out["checks"]["int8_share"]["value"] > \
        out["checks"]["int8_share"]["limit"]


def test_a_traced_upsampler_run_reports_its_metrics(tmp_path):
    """Every metric that lists the cell, where the CPU records it: the
    decode's spans and rates, the prefill, the model builds and the
    conditioner's profiled run (0 s on the CPU: no device operations)."""
    profiler.reset()
    base, bench = _tiny_up0.tree(tmp_path)
    out = harness.run(bench, "up0.tiny", SEED + 1, 0.3, 1, "cpu",
                      common.now(), base=base)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in ("window_tokens_per_s.sample", "decode_step_ms.sample",
                 "mfu.sample", "layers_host_ms.sample", "head_host_ms.sample",
                 "prefill_s.sample", "model_build_s.sample"):
        assert m[name]["value"] > 0, name
    assert m["x_cond_s.up0"]["value"] == 0.0
    assert "launch_host_us.sample" not in m  # the CPU's plain paths
    profiler.reset()


def test_x_cond_reads_the_span_and_none_without_it(monkeypatch):
    read = common.load_module("metrics", "x_cond_s.up0").read
    r = types.SimpleNamespace(spans=common.Spans())
    r.spans.add("x_cond", 0.0, 1.0, device_s=0.25)
    profiler.reset()
    cfg, model, _ = _program_and_weights(5)
    _, z_up, y = _inputs(cfg["hparams"])
    with torch.no_grad():
        model.get_cond([z_up], y)  # not traced: nothing kept
    assert profiler.totals()["sample.x_cond"]["calls"] == 1
    assert read(r) is None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model.get_cond([z_up], y)
    assert read(r) == 0.25
    assert read(types.SimpleNamespace(spans=common.Spans())) is None
    for name in ("traced", "totals"):  # a port without the recorder
        monkeypatch.delattr(profiler, name)
    assert read(r) is None
    profiler.reset()


def test_the_upsampler_driver_loads_no_jax():
    code = ("import sys\n"
            "import benchmark.drivers.upsampler_windows\n"
            "import benchmark.reference.upsampler\n"
            "from benchmark import common\n"
            "print(common.foreign_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
