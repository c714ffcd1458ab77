"""The port's fine-tuning path (jukebox_tpu_torch/train.py setup / fit /
run, make_eval_step, evaluate, the checkpoint every save_iters, the CLI)
against jukebox_tpu on the CPU, on a 2-layer top prior without labels
(labels=False: no label conditioner, a learnt start token and zero
x_cond, as jukebox_tpu/models/prior.py builds it), fp32:

* z_forward: the loss within 1e-5 and every gradient within 1e-4 of its
  leaf's largest |gradient| against jax.grad (summation order only);
* one step of train.run from the same weights and batch as one
  jukebox_tpu.train.make_prior_train_step: the loss within 1e-5, params
  within 1e-3 x lr (test_torch_train_step.py's tolerances);
* make_eval_step against jukebox_tpu.train.make_eval_step: loss and
  metrics within 1e-5; evaluate averages eval_fn over the test split;
* the training loop saves checkpoint_latest.jkb at the steps i with
  i % save_iters == 1, with the EMA weights as params (device EMA and host
  EMA), the optimizer state and the step; a run restored from it resumes
  at that step with those numbers exactly; the EMA exchange used for
  evaluation puts the params back bit for bit;
* `python -m jukebox_tpu_torch.train` trains and saves from the command
  line."""

import os
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu import train as jtrain
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import train as ttrain
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils import checkpoints as tck
from jukebox_tpu_torch.utils import train_utils as ttu
from jukebox_tpu_torch.utils.convert import (flatten_tree, named_leaves,
                                             named_to_tree, opt_state_to_jax,
                                             to_jax_params)

from test_torch_train import VQ, jax_vqvae_runtime

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
TOP = dict(level=2, n_ctx=16, prior_width=16, prior_depth=2, heads=2,
           attn_order=2, blocks=4, init_scale=0.7, labels=False,
           use_tokens=False, n_tokens=0, single_enc_dec=False,
           min_duration=0.0, max_duration=600.0, sr=8000, prior=True,
           train=True, lr=LR, lr_warmup=1.0, weight_decay=0.01, bs=2)


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


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    _write_wavs(d)
    return str(d)


def _kw(tmp, **over):
    return dict(VQ, **TOP, local_logdir=str(tmp), name="ft", **over)


def _jax_prior(tvq, **over):
    jvq = jax_vqvae_runtime(tvq)
    hps = jhp.setup_hparams("teeny", dict(VQ, **TOP, **over))
    return jvq, jmm.make_prior(hps, jvq), hps


@pytest.fixture(scope="module")
def pair():
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(VQ, **TOP)), tvq,
                        "cpu")
    jvq, jp, hps = _jax_prior(tvq)
    jp.params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(tp.model))
    x = np.random.RandomState(0).uniform(
        -1, 1, (2, VQ["sample_length"], 1)).astype(np.float32)
    return jvq, jp, hps, tvq, tp, x


def test_labels_false_builds_like_jax(pair):
    jvq, jp, hps, tvq, tp, x = pair
    assert not hasattr(tp.model, "y_emb") and tp.model.get_y({}, 0) is None
    assert "start_token" in jp.params["prior"]
    assert tp.model.prior.start_token.shape == (1, TOP["prior_width"])


def test_labels_false_z_forward_matches_jax(pair):
    jvq, jp, hps, tvq, tp, x = pair
    zj = jvq.encode(jnp.asarray(x), start_level=2)[0]
    zt = tvq.encode(torch.from_numpy(x), start_level=2)[0]
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))

    def loss_fn(params):
        return jp.model.z_forward(params, zj, z_conds=[], y=None)[0]

    ref, jgrads = jax.value_and_grad(loss_fn)(jp.params)
    for p in tp.model.parameters():
        p.grad = None
    loss, _ = tp.model.z_forward(zt, None, None)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), abs=1e-5)
    ref_grads = named_leaves(tp.model, jax.tree_util.tree_map(np.asarray,
                                                              jgrads))
    for name, p in tp.model.named_parameters():
        r = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=name)
        p.grad = None


def test_labels_false_run_step_matches_jax(wavs, tmp_path):
    state = ttrain.setup("teeny", device="cpu", **_kw(
        tmp_path, audio_files_dir=wavs, max_steps=1, save=False))
    rt = state["runtime"]
    p0 = jax.tree_util.tree_map(np.copy, to_jax_params(rt.model))
    # the batch of step 1 as the loop makes it (epoch 0, aug_blend off)
    dp = state["data_processor"]
    dp.set_epoch(0)
    it = iter(dp.train_loader)
    x = ttrain._batch(next(it), state["hps"], torch.device("cpu"))[0]
    it.close()
    out = ttrain.fit(state)
    assert [r["it"] for r in out["records"]] == [1]
    jvq, jp, hps = _jax_prior(rt.vqvae)
    jstep = jtrain.make_prior_train_step(jp, hps, jtu.make_lr_schedule(hps))
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    params, _, _, jloss, _ = jstep(params, jtu.adam_init(params), None,
                                   (jnp.asarray(x.numpy()), None),
                                   jax.random.key(0), jnp.asarray(1), 1.0)
    assert out["records"][0]["loss"] == pytest.approx(float(jloss), abs=1e-5)
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    for k, a in flatten_tree(to_jax_params(rt.model)).items():
        np.testing.assert_allclose(a, ref[k], rtol=0, atol=1e-3 * LR,
                                   err_msg=k)


def test_eval_step_matches_jax(pair, wavs, tmp_path):
    jvq, jp, hps, tvq, tp, x = pair
    loss, metrics = ttrain.make_eval_step(tp, thp.setup_hparams(
        "teeny", dict(VQ, **TOP)))(torch.from_numpy(x), None)
    jloss, jmetrics = jtrain.make_eval_step(jp, hps)(jp.params,
                                                     jnp.asarray(x), None)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  abs=1e-5)
    state = ttrain.setup("teeny", device="cpu", **_kw(
        tmp_path, audio_files_dir=wavs, train_test_split=0.5))
    dp, rt = state["data_processor"], state["runtime"]
    got = ttrain.evaluate(state["eval_fn"], rt, dp, state["hps"])
    losses, n = 0.0, 0
    for batch in dp.test_loader:
        xb = ttrain._batch(batch, state["hps"], torch.device("cpu"))[0]
        losses += float(state["eval_fn"](xb, None)[0]) * xb.shape[0]
        n += xb.shape[0]
    assert got["loss"] == pytest.approx(losses / n, rel=1e-6)
    assert set(got) == {"loss", "bpd", "prime_loss", "gen_loss"}


@pytest.mark.parametrize("cpu_ema", [False, True])
def test_save_every_save_iters_with_ema(wavs, tmp_path, cpu_ema):
    out = ttrain.run("teeny", device="cpu", **_kw(
        tmp_path, audio_files_dir=wavs, max_steps=3, save_iters=2,
        cpu_ema=cpu_ema, cpu_ema_freq=1, test=True, train_test_split=0.5))
    saved = [r["it"] for r in out["records"] if "checkpoint" in r]
    assert saved == [1, 3]
    path = out["records"][-1]["checkpoint"]
    assert path == str(tmp_path / "ft" / "checkpoint_latest.jkb")
    ckpt = tck.load_checkpoint(path)
    rt, ema = out["runtime"], out["ema"]
    assert isinstance(ema, ttu.CPUEMA if cpu_ema else ttu.EMA)
    assert int(ckpt["step"]) == 3 and out["test"] is not None
    shadow = flatten_tree(named_to_tree(rt.model, ema.shadow))
    params = flatten_tree(to_jax_params(rt.model))
    moved = False
    for k, a in flatten_tree(ckpt["params"]).items():
        np.testing.assert_array_equal(a, shadow[k], err_msg=k)
        moved |= not np.array_equal(a, params[k])
    assert moved  # the EMA weights, not the trained ones
    opt = flatten_tree(opt_state_to_jax(rt.model, out["opt_state"]))
    for k, a in flatten_tree(ckpt["opt"]).items():
        np.testing.assert_array_equal(a, opt[k], err_msg=k)

    # resume: step, params and optimizer state from the file, then train on
    state = ttrain.setup("teeny", device="cpu", **_kw(
        tmp_path, audio_files_dir=wavs, max_steps=5, restore_prior=path,
        save=False))
    assert state["runtime"].step == 3 == state["opt_state"]["step"]
    for k, a in flatten_tree(to_jax_params(state["runtime"].model)).items():
        np.testing.assert_array_equal(a, flatten_tree(ckpt["params"])[k])
    out = ttrain.fit(state)
    assert [r["it"] for r in out["records"]] == [4, 5]


@pytest.mark.parametrize("cpu_ema", [False, True])
def test_ema_exchange_restores_params(cpu_ema):
    params = {n: torch.randn(5, 3) for n in "ab"}
    before = {n: p.clone() for n, p in params.items()}
    ema = (ttu.CPUEMA if cpu_ema else ttu.EMA)(params, mu=0.5, freq=1)
    for p in params.values():
        p.add_(1.0)
    ema.step(params)
    shadow = {n: torch.as_tensor(s).clone() for n, s in ema.shadow.items()}
    with ttu.ema_params(ema, params):
        for n in params:
            assert torch.equal(params[n], shadow[n])
    for n in params:
        assert torch.equal(params[n], before[n] + 1.0)
        assert torch.equal(torch.as_tensor(ema.shadow[n]), shadow[n])


def test_cli_trains_and_saves(wavs, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    args = [f"--{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in _kw(tmp_path, audio_files_dir=wavs, max_steps=1,
                            device="cpu").items()]
    proc = subprocess.run([sys.executable, "-m", "jukebox_tpu_torch.train",
                           "--hps=teeny", *args], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Train epoch 0:" in proc.stdout
    ckpt = tck.load_checkpoint(str(tmp_path / "ft" / "checkpoint_latest.jkb"))
    assert int(ckpt["step"]) == 1
