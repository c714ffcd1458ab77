"""The fp32 reference against the port's plain CPU forward at tiny widths
(this test imports both; the reference imports nothing of the port)."""

import ast

import pytest
import torch

from benchmark import common, weights
from benchmark.drivers import prior_windows as pw
from benchmark.reference import prior as ref
from benchmark.tests import _tiny


def test_reference_logits_equal_the_port_forward():
    cfg = _tiny.tiny_config("prior_1b_lyrics", _tiny.TOP)
    hp = cfg["hparams"]
    dev = torch.device("cpu")
    _, rt = pw.build_program(cfg, dev)
    pw.load_weights(rt, cfg, 7, dev)
    w = weights.draw(ref.layout(cfg), common.derive(7, 1), dev,
                     hp["init_scale"])
    gen = torch.Generator().manual_seed(0)
    B, g = 2, hp["max_bow_genre_size"]
    z = torch.randint(0, hp["l_bins"], (B, hp["n_ctx"]), generator=gen)
    y = torch.cat([torch.full((B, 1), 10_000_000),
                   torch.full((B, 1), 300_000),
                   torch.full((B, 1), hp["n_ctx"] * 128),
                   torch.randint(0, hp["y_bins"][1], (B, 1), generator=gen),
                   torch.randint(0, hp["y_bins"][0], (B, g), generator=gen)],
                  1)
    if g > 1:
        y[0, 6:] = -1
    lyr = torch.randint(0, hp["n_vocab"], (B, hp["n_tokens"]), generator=gen)
    y = torch.cat([y, lyr], 1)
    stream = torch.cat([lyr, z + hp["n_vocab"]], 1)
    with torch.no_grad():
        want = rt.model.forward(z, None, y)
        got = ref.logits(w, cfg, stream, y)
    scale = want.abs().max()
    assert torch.allclose(got, want, atol=1e-5 * float(scale), rtol=0)
    # a padded stream leaves the logits before the padding as they were
    with torch.no_grad():
        part = ref.logits(w, cfg, stream[:, :-5], y)
    assert torch.allclose(part[:, :-5], got[:, :-5], atol=1e-6 * float(scale),
                          rtol=0)


def test_the_reference_imports_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                ok = m.split(".")[0] in ("torch", "numpy", "math") or \
                    m.startswith("benchmark.reference")
                assert ok, (path.name, m)


def test_training_reference_equals_the_port_loss_and_encode():
    from benchmark.drivers import prior_train
    from benchmark.reference import train as rtrain
    cfg = _tiny.tiny_config("prior_1b_lyrics", _tiny.TOP)
    traffic = dict(common.load_json(common.find("traffic", "finetune.bs16")),
                   batch=2)
    drv = prior_train.Driver(cfg, traffic, 99, "cpu")
    hps = drv.recipe()
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    drv.vqvae = make_vqvae(hps, "cpu")
    drv.runtime = make_prior(hps, drv.vqvae, "cpu")
    drv._load_weights()
    w = drv._draw()
    x, y = drv._batch(1)
    with torch.no_grad():
        z = drv.vqvae.encode(x, start_level=2)[0]
        assert torch.equal(rtrain.encode(w, drv.vq, 2, x), z)
        want, _ = drv.runtime.model.z_forward(z, None, y)
        got = rtrain.loss(w, cfg, z, y, recompute=False)
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
