"""VQ-VAE training of the PyTorch port against jukebox_tpu on the CPU, fp32,
at the verify recipe's size (levels 2, downs_t 2,1, strides_t 2,2,
emb_width 16, l_bins 32, width 8, depth 2, sample_length 2048), on the same
weights (bridged with utils/convert.py) and audio drawn from a numpy seed.

The codebooks start from an initialised state in which every code is in
use (restore_state with a large num_tokens: usage all ones, the restart
candidates, which the packages draw differently, not taken), seeded from
the encoders' own latents so that the codes are ties-free and equal.

* forward (VQVAE.forward, train=True) for each loss_fn and both
  use_nonrelative_specloss, with hvqvae_multipliers or without: the loss
  and every metric within rtol 1e-5; the codebook state after the update
  within 1e-5; every parameter's gradient against jax.grad within rtol
  1e-4, normwise per leaf (||port - JAX|| <= 1e-4 ||JAX|| + 1e-6 times
  the norm of the whole gradient: fp32 through a few conv layers and
  three FFTs, summation order only; the floor covers the level-1
  encoder's leaves, whose gradients are ~1e-5 of the whole and read up to
  1.3e-4 of their own norm). Eval (train=False): the same, and the state
  unchanged. use_bottleneck=False against JAX's NoBottleneck.
* one whole train step (make_vqvae_train_step, clipped Adam with weight
  decay) against jukebox_tpu's: loss within 1e-5, the gradient norm within
  1e-4; params: every element within 1e-2 x lr of JAX's and all of them
  within 1e-4 of how far the step moved them, normwise (Adam's first step
  moves an element by lr g / (|g| + eps) whatever its gradient's size, so
  an element whose |g| is near eps turns its gradient's rounding into a
  share of lr: 1.1e-3 x lr and 3.5e-5 normwise measured); Adam moments
  within 1e-4 of their leaf's largest |value|; codebook state within
  1e-5.
* train.run on synthetic wavs: checkpoint_step_1.jkb holds params, optimizer
  state and the full codebook state; it restores in jukebox_tpu's
  restore_model with equal params and state, and the port restores a
  checkpoint jukebox_tpu wrote; restored for training the codebooks get
  the fine-tuning reset, equal to JAX's restore_state at the port's world
  size of 1 (jukebox_tpu multiplies by jax.device_count(), 8 here).
* every preset of JAX's registry is in the port's with equal values, and
  the small family builds (its priors at the published widths, cut to 2
  layers).
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu import train as jtrain
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.models.bottleneck import BottleneckBlock as JBottleneckBlock
from jukebox_tpu.models.encdec import BlockCfg as JBlockCfg
from jukebox_tpu.models.vqvae import VQVAE as JVQVAE
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import train as ttrain
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.vqvae import VQVAE
from jukebox_tpu_torch.utils import train_utils as ttu
from jukebox_tpu_torch.utils.checkpoints import load_checkpoint
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             named_leaves, opt_state_to_jax,
                                             to_jax_params, vqvae_tree)

torch.set_num_threads(1)
RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
T = 2048
CFG = dict(levels=2, downs_t=(2, 1), strides_t=(2, 2), emb_width=16,
           l_bins=32)
BLOCK = dict(width=8, depth=2, m_conv=1.0, dilation_growth_rate=3)
HPS = dict(sample_length=T, width=8, depth=2, m_conv=1.0,
           dilation_growth_rate=3, sr=8000, linf_k=100, lmix_l1=0.3,
           lmix_l2=1.0, lmix_linf=0.02, spectral=0.5, multispectral=1.0,
           commit=0.02, l_mu=0.99, **CFG)
BANDWIDTH = {"l1": 0.3, "l2": 0.1, "spec": 50.0}
STATE_KEYS = ("k", "k_sum", "k_elem", "init", "threshold")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hps(pkg, **kw):
    hps = pkg.setup_hparams("teeny", dict(HPS, **kw))
    hps.bandwidth = dict(BANDWIDTH)
    return hps


def _audio(seed, n=2):
    rs = np.random.RandomState(seed)
    t = np.arange(T) / 8000.0
    x = 0.3 * np.sin(2 * np.pi * rs.uniform(100, 900, (n, 1)) * t)
    return (x + 0.1 * rs.standard_normal((n, T)))[..., None].astype(
        np.float32)


def _models(multipliers=None, use_bottleneck=True, seed=0):
    jm = JVQVAE(input_shape=(T, 1), mu=0.99, commit=0.02, spectral=0.5,
                multispectral=1.0, multipliers=multipliers,
                use_bottleneck=use_bottleneck, block=JBlockCfg(**BLOCK),
                **CFG)
    params = jm.init(jax.random.key(seed))
    state = jm.init_state()
    if use_bottleneck:
        # every code in use, seeded from the latents of other audio
        x = jnp.asarray(_audio(seed + 100))
        blk = jm.bottleneck.block
        state = {"level_blocks": [
            blk.restore_state(np.asarray(jm.encoder(l).apply(
                params["encoders"][l], x)[-1]).reshape(-1, 16)[::3][:32]
                + 0.01, num_tokens=1e6)
            for l in range(CFG["levels"])]}
    tm = VQVAE((T, 1), CFG["levels"], CFG["downs_t"], CFG["strides_t"],
               CFG["emb_width"], CFG["l_bins"], multipliers,
               BlockCfg(**BLOCK), device="cpu", commit=0.02, spectral=0.5,
               multispectral=1.0, use_bottleneck=use_bottleneck)
    from_jax_params(tm, vqvae_tree(_np(params), _np(state)))
    tm.requires_grad_(True)
    return jm, params, state, tm


def _tm_state(tm):
    return {"level_blocks": [{k: getattr(b, k).detach().numpy()
                              for k in STATE_KEYS}
                             for b in tm.bottleneck.level_blocks]}


def _assert_state(tm, js, rtol=RTOL):
    for blk, ref in zip(tm.bottleneck.level_blocks, js["level_blocks"]):
        for k in ref:
            np.testing.assert_allclose(getattr(blk, k).detach().numpy(),
                                       np.asarray(ref[k]), rtol=rtol,
                                       atol=rtol, err_msg=k)


def _forward_pair(jm, params, state, tm, x, loss_fn, train, **kw):
    jhps, thps = _hps(jhp, **kw), _hps(thp, **kw)

    def f(p):
        _, loss, metrics, s = jm.forward(p, state, jnp.asarray(x), jhps,
                                         loss_fn=loss_fn, train=train,
                                         rng=jax.random.key(3))
        return loss, (metrics, s)
    (jloss, (jmet, jstate)), jgrad = jax.value_and_grad(f, has_aux=True)(
        params)
    for p in tm.parameters():
        p.grad = None
    x_out, loss, tmet = tm(torch.from_numpy(x), thps, loss_fn=loss_fn,
                           train=train, gen=torch.Generator().manual_seed(0))
    loss.backward()
    assert x_out.shape == (x.shape[0], T, 1)
    return (float(jloss), _np(jmet), jstate, named_leaves(tm, _np(jgrad))), \
        (float(loss.detach()), tmet,
     {n: p.grad for n, p in tm.named_parameters()})


def _assert_close(j, t, what=""):
    jloss, jmet, _, jgrad = j
    tloss, tmet, tgrad = t
    assert tloss == pytest.approx(jloss, rel=RTOL)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=f"{what} {k}")
        assert not tmet[k].requires_grad
    floor = GRAD_FLOOR * np.sqrt(sum(np.sum(g ** 2) for g in jgrad.values()))
    for n, g in jgrad.items():
        gap = np.linalg.norm(tgrad[n].numpy() - g)
        assert gap <= GRAD_RTOL * np.linalg.norm(g) + floor, (what, n, gap)


@pytest.mark.parametrize("loss_fn", ["l1", "l2", "linf", "lmix"])
@pytest.mark.parametrize("nonrel", [True, False])
def test_forward_and_grads(loss_fn, nonrel):
    jm, params, state, tm = _models()
    x = _audio(1)
    j, t = _forward_pair(jm, params, state, tm, x, loss_fn, True,
                         use_nonrelative_specloss=nonrel)
    _assert_close(j, t, loss_fn)
    assert {"fit", "pn", "entropy", "used_curr", "usage", "dk"} <= set(t[1])
    _assert_state(tm, j[2])


def test_multipliers_and_eval():
    """hvqvae_multipliers (2, 1): level 0's blocks twice as wide and deep;
    then an eval forward from the same start, which leaves the codebooks as
    they were and sends the encoders only the commit loss's gradient."""
    jm, params, state, tm = _models(multipliers=(2, 1))
    assert tm.encoders[0].level_blocks[0].downs[0]["conv_down"].w.shape[0] \
        == 16
    assert len(tm.decoders[0].level_blocks[0].ups[0]["resnet"].blocks) == 4
    x = _audio(2)
    j, t = _forward_pair(jm, params, state, tm, x, "lmix", True)
    _assert_close(j, t, "train")
    _assert_state(tm, j[2])
    jm, params, state, tm = _models(multipliers=(2, 1))
    before = _tm_state(tm)
    j, t = _forward_pair(jm, params, state, tm, x, "l2", False)
    _assert_close(j, t, "eval")
    assert "usage" not in t[1] and "fit" not in t[1]
    for b, ref in zip(_tm_state(tm)["level_blocks"], before["level_blocks"]):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(b[k], ref[k])


def test_no_bottleneck():
    jm, params, state, tm = _models(use_bottleneck=False)
    assert tm.bottleneck.level_blocks == [] and not list(tm.buffers())
    j, t = _forward_pair(jm, params, state, tm, _audio(3), "l2", True)
    _assert_close(j, t, "no bottleneck")
    assert float(t[1]["usage"]) == float(t[1]["commit_loss"]) == 0.0


def test_train_step_matches_jax():
    jm, params, state, tm = _models(seed=4)
    lr = 1e-3
    kw = dict(lr=lr, lr_warmup=1.0, weight_decay=0.01, clip=1.0,
              loss_fn="lmix", train=True)
    jhps, thps = _hps(jhp, **kw), _hps(thp, **kw)
    jstep = jtrain.make_vqvae_train_step(jmm.VQVAERuntime(jm, params, state),
                                         jhps, jtu.make_lr_schedule(jhps))
    runtime = tmm.VQVAERuntime(tm)
    tstep = ttrain.make_vqvae_train_step(runtime, thps,
                                         ttu.make_lr_schedule(thps))
    p0 = _np(params)
    jopt = jtu.adam_init(params)
    topt = ttu.adam_init(runtime.params)
    x = _audio(5)
    jparams, jopt, jstate, jloss, jmet = jstep(
        jax.tree_util.tree_map(jnp.asarray, p0), jopt, state,
        jnp.asarray(x), jax.random.key(0), jnp.asarray(1), 1.0)
    tloss, tmet = tstep(topt, (torch.from_numpy(x), None), 7, 1)
    assert tmet["step_ok"] and bool(jmet["step_ok"])
    assert float(tloss) == pytest.approx(float(jloss), rel=RTOL)
    assert float(tmet["gn"]) == pytest.approx(float(jmet["gn"]), rel=1e-4)
    _assert_state(tm, jstate)
    jp, tp = flatten_tree(_np(jparams)), flatten_tree(to_jax_params(tm))
    assert jp.keys() == tp.keys()
    assert max(np.abs(jp[k] - flatten_tree(p0)[k]).max() for k in jp) > lr / 2
    p0f = flatten_tree(p0)
    worst = max(np.abs(tp[k] - jp[k]).max() for k in jp) / lr
    gap = np.sqrt(sum(np.sum((tp[k] - jp[k]) ** 2) for k in jp))
    moved = np.sqrt(sum(np.sum((jp[k] - p0f[k]) ** 2) for k in jp))
    assert worst <= 1e-2 and gap <= 1e-4 * moved
    jo = flatten_tree(_np({"m": jopt["m"], "v": jopt["v"]}))
    to = flatten_tree(opt_state_to_jax(tm, topt))
    for k, ref in jo.items():
        np.testing.assert_allclose(to[k], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-20,
                                   err_msg=k)
    assert topt["step"] == int(jopt["step"]) == 1
    assert all(p.grad is None for p in tm.parameters())


# -- train.run, checkpoints ---------------------------------------------------

RUN = dict(sr=8000, channels=2, sample_length=T, levels=2, downs_t=(2, 1),
           strides_t=(2, 2), emb_width=16, l_bins=32, width=8, depth=2,
           bs=2, loss_fn="l2", labels=False, min_duration=0.5,
           aug_shift=True, aug_blend=True)


def _write_wavs(d, seconds=(2.0, 2.5)):
    rs = np.random.RandomState(0)
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * 8000)) / 8000
        sig = 0.4 * np.sin(2 * np.pi * (220 + 110 * i) * t)
        pcm = np.stack([sig, sig + 0.05 * rs.standard_normal(len(t))], 1)
        with wave.open(str(d / f"s{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2")
                          .tobytes())


@pytest.fixture(scope="module")
def vq_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("vqrun")
    (d / "wavs").mkdir()
    _write_wavs(d / "wavs")
    out = ttrain.run("teeny", device="cpu", audio_files_dir=str(d / "wavs"),
                     train=True, test=True, max_steps=3, log_steps=1,
                     local_logdir=str(d / "logs"), name="vq", seed=5, **RUN)
    return d, out


def test_run_writes_step_checkpoint(vq_run, capsys):
    d, out = vq_run
    recs = out["records"]
    assert [r["it"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["used_curr"] > 0 for r in recs)
    assert recs[0]["checkpoint"] == str(d / "logs" / "vq" /
                                        "checkpoint_step_1.jkb")
    assert out["test"] is not None and np.isfinite(out["test"]["loss"])
    ckpt = load_checkpoint(recs[0]["checkpoint"])
    assert set(ckpt) == {"hps", "params", "state", "opt", "step"}
    assert int(ckpt["step"]) == 1 and int(ckpt["opt"]["step"]) == 1
    assert set(ckpt["params"]) == set(ckpt["opt"]["m"]) == {"encoders",
                                                           "decoders"}
    for blk in ckpt["state"]["level_blocks"]:
        assert set(blk) == set(STATE_KEYS)
        assert blk["init"].dtype == np.bool_ and bool(blk["init"])
    # the EMA weights are the file's params
    ema = out["ema"]
    assert ema is not None
    assert not os.path.exists(d / "logs" / "vq" / "checkpoint_latest.jkb")


def test_port_checkpoint_restores_in_jax(vq_run):
    d, out = vq_run
    path = out["records"][0]["checkpoint"]
    ckpt = load_checkpoint(path)
    jhps = jhp.setup_hparams("teeny", dict(RUN, restore_vqvae=path))
    jrt = jmm.make_vqvae(jhps)
    assert jrt.step == 1
    jp, fp = flatten_tree(_np(jrt.params)), flatten_tree(ckpt["params"])
    assert jp.keys() == fp.keys()
    for k in jp:
        np.testing.assert_array_equal(jp[k], fp[k])
    for a, b in zip(jrt.state["level_blocks"], ckpt["state"]["level_blocks"]):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    # and the port's frozen restore holds the same bits
    tm = tmm.make_vqvae(thp.setup_hparams("teeny", dict(
        RUN, restore_vqvae=path)), "cpu")
    assert tm.step == 1
    tp = flatten_tree(to_jax_params(tm))
    for k in fp:
        np.testing.assert_array_equal(tp[k], fp[k])
    for blk, ref in zip(tm.bottleneck.level_blocks,
                        ckpt["state"]["level_blocks"]):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(getattr(blk, k).numpy(), ref[k])


def test_fine_tune_reset_matches_jax(vq_run):
    d, out = vq_run
    path = out["records"][0]["checkpoint"]
    ckpt = load_checkpoint(path)
    kw = dict(RUN, restore_vqvae=path, train=True, revival_threshold=0.5)
    tm = tmm.make_vqvae(thp.setup_hparams("teeny", kw), "cpu")
    jrt = jmm.make_vqvae(jhp.setup_hparams("teeny", kw))
    world = jax.device_count()
    for level, (blk, ref, jstate) in enumerate(zip(
            tm.bottleneck.level_blocks, ckpt["state"]["level_blocks"],
            jrt.state["level_blocks"])):
        r2t = 4 * 2 ** level  # downs_t (2, 1), strides 2
        want = JBottleneckBlock(32, 16, 0.99).restore_state(
            ref["k"], num_tokens=T // r2t, threshold=0.5)
        for k in STATE_KEYS:
            np.testing.assert_array_equal(getattr(blk, k).numpy(),
                                          np.asarray(want[k]), err_msg=k)
        # jukebox_tpu counts the tokens of every device of its mesh
        np.testing.assert_array_equal(np.asarray(jstate["k_elem"]),
                                      world * blk.k_elem.numpy())
        np.testing.assert_array_equal(np.asarray(jstate["k"]), ref["k"])
    assert all(p.requires_grad for p in tm.parameters())
    assert not any(b.requires_grad for b in tm.buffers())


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A VQ-VAE checkpoint that jukebox_tpu wrote after a training forward
    (so its state is not the restored one) restores into the port's
    training setup: params, codebook state, Adam state and step."""
    jm, params, state, _ = _models(seed=6)
    _, _, _, state = jm.forward(params, state, jnp.asarray(_audio(7)),
                                _hps(jhp), loss_fn="l2", train=True,
                                rng=jax.random.key(1))
    opt = jtu.adam_init(params)
    opt["m"] = jax.tree_util.tree_map(lambda a: a + 0.5, opt["m"])
    opt["step"] = jnp.asarray(4)
    jmm.save_model_checkpoint(str(tmp_path), "step_4",
                              jmm.VQVAERuntime(jm, params, state), opt, 4,
                              jhp.setup_hparams("teeny", {}))
    path = str(tmp_path / "checkpoint_step_4.jkb")
    tm = tmm.make_vqvae(thp.setup_hparams("teeny", dict(
        HPS, restore_vqvae=path)), "cpu")
    assert tm.step == 4
    _assert_state(tm, _np(state), rtol=0)
    tp, jp = flatten_tree(to_jax_params(tm)), flatten_tree(_np(params))
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    opt_t, step = tmm.restore_opt(ttu.adam_init(dict(tm.named_parameters())),
                                  path, tm)
    assert step == opt_t["step"] == 4
    for k, a in flatten_tree(opt_state_to_jax(tm, opt_t)["m"]).items():
        np.testing.assert_array_equal(a, flatten_tree(_np(opt["m"]))[k])


# -- presets ------------------------------------------------------------------

def test_presets_equal_jax():
    assert set(thp.HPARAMS_REGISTRY) == set(jhp.HPARAMS_REGISTRY)
    for name, ref in jhp.HPARAMS_REGISTRY.items():
        assert dict(thp.HPARAMS_REGISTRY[name]) == dict(ref), name
    assert dict(thp.DEFAULTS) == dict(jhp.DEFAULTS)


# the unlabelled presets train with --labels=False, as the README's
# commands pass it
@pytest.mark.parametrize("preset,level,labels", [
    ("small_prior", 1, False), ("small_labelled_prior", 1, True),
    ("small_single_enc_dec_prior", 1, True),
    ("small_sep_enc_dec_prior", 1, True), ("small_upsampler", 0, False)])
def test_small_presets_build(preset, level, labels):
    hps = thp.setup_hparams(f"small_vqvae,{preset}", dict(
        sample_length=2048 * 256 // 8, levels=2, level=level, prior_depth=2,
        prime_depth=1, train=True, prior=True, labels=labels))
    vq = tmm.make_vqvae(hps, "cpu")
    assert vq.downsamples == [32, 8] and vq.l_bins == 1024
    assert not any(p.requires_grad for p in vq.parameters())
    rt = tmm.make_prior(hps, vq, "cpu")
    tr = rt.model.prior.transformer
    assert tr.n_depth == 2 and tr.n_in == 1024
    assert all(p.requires_grad for p in rt.params.values())
    assert rt.model.level == level


def test_small_vqvae_builds_for_training():
    hps = thp.setup_hparams("small_vqvae", dict(sample_length=8192,
                                                train=True))
    vq = tmm.make_vqvae(hps, "cpu")
    assert [b.k.shape for b in vq.bottleneck.level_blocks] == [(1024, 64)] * 2
    assert not any(bool(b.init) for b in vq.bottleneck.level_blocks)
    assert all(float(b.k.abs().max()) == 0.0
               for b in vq.bottleneck.level_blocks)
    assert "bottleneck.level_blocks.0.k" not in dict(vq.named_parameters())
