"""Checkpoints shared by the two packages (jukebox_tpu_torch/utils/
checkpoints.py and the restore / save functions of models/make_models.py)
against jukebox_tpu's, on the CPU:

* a `.jkb` written by jukebox_tpu restores in the port, and one written by
  the port restores in jukebox_tpu (make_prior's restore_prior,
  restore_opt), for both optimizer forms: params, optimizer state and step
  exactly equal (the file holds the numbers, so nothing may round);
* one train step from a restored state on both sides matches at
  test_torch_train_step.py's fp32 tolerances (loss within 1e-5, params
  within 1e-3 x lr, moments within 1e-4 of each leaf's largest |value|);
* a jukebox_tpu VQ-VAE checkpoint restored into the port's make_vqvae
  decodes as the JAX VQ-VAE does (1e-4, as test_torch_vqvae.py);
* the restricted unpickler refuses a pickle that names anything but
  numpy's reconstructors and builtin containers;
* restore specs resolve as in jukebox_tpu: a missing file or an uncached
  REMOTE_PREFIX path prints the same fresh-init message and keeps the
  fresh weights, a cached one restores, a local .pth.tar raises;
* a 5b_lyrics-like prior (lyric encoder, f6 layers' c_enc_kv, the
  unshared x_out of merged_decoder) round-trips through `.jkb` both ways,
  exactly;
* make_prior raises for the prior options it does not build."""

import collections
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu import train as jtrain
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.models.encdec import BlockCfg as JBlockCfg
from jukebox_tpu.models.vqvae import VQVAE as JVQVAE
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import train as ttrain
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils import checkpoints as tck
from jukebox_tpu_torch.utils import train_utils as ttu
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             opt_state_to_jax, to_jax_params)

from test_torch_train import TOP, VQ, build_pair

torch.set_num_threads(1)
LR = 1e-3
CFG = dict(TOP, prior_depth=16, train=True, prior=True, lr=LR, lr_warmup=1.0,
           weight_decay=0.01, clip=0.4)


@pytest.fixture(scope="module")
def pair():
    return build_pair(CFG, seed=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(_np(a)), flatten_tree(_np(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_state(jp, fp16, seed):
    """JAX params and an Adam state after one update with random grads."""
    params = jax.tree_util.tree_map(jnp.asarray, _np(jp.params))
    rs = np.random.RandomState(seed)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32)), params)
    opt = jtu.adam_init(params, fp16_state=fp16)
    return jtu.adam_update(params, grads, opt, LR, 0.9, 0.99, 1e-8, 0.01,
                           2.0)


def _hps(pkg, **kw):
    return pkg.setup_hparams("teeny", dict(CFG, **VQ, **kw))


@pytest.mark.parametrize("fp16", [False, True])
def test_jax_checkpoint_restores_in_port(pair, tmp_path, fp16):
    jvq, jp, tvq, tp, x, y = pair
    params, opt = _jax_state(jp, fp16, 3)
    jmm.save_model_checkpoint(str(tmp_path), "latest",
                              types.SimpleNamespace(params=params), opt, 7,
                              _hps(jhp, fp16_opt=fp16))
    path = str(tmp_path / "checkpoint_latest.jkb")
    rt = tmm.make_prior(_hps(thp, restore_prior=path), tvq, "cpu")
    assert rt.step == 7
    _assert_trees_equal(to_jax_params(rt.model), params)
    topt, step = tmm.restore_opt(ttu.adam_init(rt.params, fp16_state=fp16),
                                 path, rt.model)
    assert step == 7 and topt["step"] == 1
    _assert_trees_equal(opt_state_to_jax(rt.model, topt), opt)


@pytest.mark.parametrize("fp16", [False, True])
def test_port_checkpoint_restores_in_jax(pair, tmp_path, fp16):
    jvq, jp, tvq, tp, x, y = pair
    from_jax_params(tp.model, _np(jp.params))
    topt = ttu.adam_init(tp.params, fp16_state=fp16)
    rs = np.random.RandomState(4)
    grads = {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
             for n, p in tp.params.items()}
    ttu.adam_update(tp.params, grads, topt, LR, 0.9, 0.99, 1e-8, 0.01, 2.0)
    path = tmm.save_model_checkpoint(str(tmp_path), "latest", tp, topt, 5,
                                     _hps(thp, fp16_opt=fp16))
    assert path == str(tmp_path / "checkpoint_latest.jkb")
    jrt = jmm.make_prior(_hps(jhp, restore_prior=path), jvq)
    assert jrt.step == 5
    _assert_trees_equal(jrt.params, to_jax_params(tp.model))
    jopt, step = jmm.restore_opt(jtu.adam_init(jrt.params, fp16_state=fp16),
                                 path)
    assert step == 5
    _assert_trees_equal(jopt, opt_state_to_jax(tp.model, topt))
    ckpt = tck.load_checkpoint(path)
    assert set(ckpt) == {"hps", "params", "state", "opt", "step"}
    assert ckpt["state"] is None and int(ckpt["hps"]["prior_depth"]) == 16


def test_train_step_after_restore_matches_jax(pair, tmp_path):
    jvq, jp, tvq, tp, x, y = pair
    params, opt = _jax_state(jp, False, 5)
    jmm.save_model_checkpoint(str(tmp_path), "latest",
                              types.SimpleNamespace(params=params), opt, 1,
                              _hps(jhp))
    path = str(tmp_path / "checkpoint_latest.jkb")
    hps, thps = _hps(jhp), _hps(thp, restore_prior=path)
    rt = tmm.make_prior(thps, tvq, "cpu")
    topt, _ = tmm.restore_opt(ttu.adam_init(rt.params), path, rt.model)
    jstep = jtrain.make_prior_train_step(jp, hps, jtu.make_lr_schedule(hps))
    tstep = ttrain.make_prior_train_step(rt, thps,
                                         ttu.make_lr_schedule(thps))
    params, jopt, _, jloss, jm = jstep(
        params, opt, None, (jnp.asarray(x), jnp.asarray(y)),
        jax.random.key(0), jnp.asarray(2), 1.0)
    tloss, tm = tstep(topt, (torch.from_numpy(x), torch.from_numpy(y)), None,
                      2, 1.0)
    assert tm["step_ok"] and bool(jm["step_ok"])
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    assert topt["step"] == int(jopt["step"]) == 2
    ref = flatten_tree(_np(params))
    for k, out in flatten_tree(to_jax_params(rt.model)).items():
        np.testing.assert_allclose(out, ref[k], rtol=0, atol=1e-3 * LR,
                                   err_msg=k)
    ref = flatten_tree(_np(jopt))
    for k, out in flatten_tree(opt_state_to_jax(rt.model, topt)).items():
        atol = 1e-4 * np.abs(ref[k]).max() + 1e-20
        np.testing.assert_allclose(out, ref[k], rtol=0, atol=atol, err_msg=k)


VQ_CFG = dict(levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2), emb_width=8,
              l_bins=16)
VQ_BLOCK = dict(width=8, depth=2, m_conv=1.0, dilation_growth_rate=3,
                reverse_decoder_dilation=True)


def test_jax_vqvae_checkpoint_decodes_in_port(tmp_path):
    jm = JVQVAE(input_shape=(128, 1), mu=0.99, commit=0.02, spectral=0.0,
                multispectral=1.0, multipliers=(2, 1, 1),
                block=JBlockCfg(**VQ_BLOCK), **VQ_CFG)
    params = jm.init(jax.random.key(0))
    rs = np.random.RandomState(1)
    state = {"level_blocks": [
        {"k": jnp.asarray(rs.randn(VQ_CFG["l_bins"], VQ_CFG["emb_width"]),
                          jnp.float32)} for _ in range(VQ_CFG["levels"])]}
    jrt = jmm.VQVAERuntime(jm, params, state)
    jmm.save_model_checkpoint(str(tmp_path), "vq", jrt, None, 3,
                              jhp.setup_hparams("teeny", {}))
    path = str(tmp_path / "checkpoint_vq.jkb")
    hps = thp.setup_hparams("teeny", dict(
        VQ_CFG, sample_length=128, hvqvae_multipliers=(2, 1, 1),
        width=8, depth=2, m_conv=1.0, dilation_growth_rate=3,
        vqvae_reverse_decoder_dilation=True, restore_vqvae=path, seed=9))
    tm = tmm.make_vqvae(hps, "cpu")
    for level in range(3):
        zs = [rs.randint(0, VQ_CFG["l_bins"], (2, n)) for (n,) in jm.z_shapes]
        ref = jm.decode(params, state, [jnp.asarray(z) for z in zs[level:]],
                        start_level=level)
        out = tm.decode([torch.from_numpy(z) for z in zs[level:]],
                        start_level=level, bs_chunks=2)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_unpickler_refuses_other_globals(tmp_path):
    path = tmp_path / "bad.jkb"
    for obj in (collections.OrderedDict(a=1), {"x": np.float32},
                {"f": pickle.dumps}):
        path.write_bytes(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match="numpy trees only"):
            tck.load_checkpoint(str(path))
    tree = {"a": [np.zeros((2, 3), np.float16), (np.int32(4), None)],
            "s": np.asarray("x"), "b": {1, 2}, "t": torch.ones(2)}
    tck.save_checkpoint(str(path), tree)
    out = tck.load_checkpoint(str(path))
    assert out["a"][0].dtype == np.float16 and out["a"][1][1] is None
    assert out["t"].tolist() == [1.0, 1.0] and out["b"].item() == {1, 2}


def test_restore_specs_resolve_as_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    remote = thp.REMOTE_PREFIX + "jukebox/models/x/prior.jkb"
    missing = str(tmp_path / "nothing.jkb")
    for spec in (missing, remote, ""):
        assert tmm.resolve_restore(spec) is None
        port = capsys.readouterr().out
        assert jmm._resolve_restore(spec) is None
        assert port == capsys.readouterr().out
        assert ("using fresh init" in port) == bool(spec)
    cached = tmp_path / ".cache" / "jukebox/models/x/prior.jkb"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"")
    assert tmm.resolve_restore(remote) == jmm._resolve_restore(remote) \
        == str(cached)
    # an upstream file resolves the same way and is read by the port's
    # converter (tests/test_torch_upstream.py holds its conversion)
    pth = tmp_path / "prior_level_2.pth.tar"
    torch.save(dict(model={}, opt=None, step=5), pth)
    assert tmm.load_any(str(pth), "opt")["step"] == 5


def test_missing_checkpoint_keeps_fresh_init(capsys):
    vq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    fresh = tmm.make_prior(_hps(thp), vq, "cpu")
    rt = tmm.make_prior(_hps(thp, restore_prior="/nonexistent/x.jkb"), vq,
                        "cpu")
    assert "checkpoint /nonexistent/x.jkb not found; using fresh init" in \
        capsys.readouterr().out
    assert rt.step == 0
    for (n, a), b in zip(rt.params.items(), fresh.params.values()):
        assert torch.equal(a, b), n


# the options the JAX package asserts off too; spread, copy_input and
# prime_spread are built (tests/test_torch_prior_options.py)
@pytest.mark.parametrize("key,value", [("pos_init", True),
                                       ("prime_pos_init", True)])
def test_unported_prior_options_raise(key, value):
    vq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    with pytest.raises(NotImplementedError, match=key):
        tmm.make_prior(_hps(thp, **{key: value}), vq, "cpu")


def test_5b_lyrics_checkpoint_round_trip(tmp_path):
    """A JAX-written 5b_lyrics-like prior restores into the port, and the
    port's file restores into jukebox_tpu: every leaf equal, the lyric
    encoder (prime_prior, prime_state_proj / _ln, prime_x_out), the f6
    layer's c_enc_kv and merged_decoder's x_out among them."""
    from test_torch_5b import TOP_5B_LYRICS, VQ as VQ5

    def hps(pkg, **kw):
        return pkg.setup_hparams("teeny", dict(TOP_5B_LYRICS, **VQ5, **kw))
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ5)))
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ5)), "cpu")
    jp = jmm.make_prior(hps(jhp), jvq)
    rs = np.random.RandomState(6)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rs.randn(*np.shape(a)).astype(np.float32),
        _np(jp.params))
    jmm.save_model_checkpoint(str(tmp_path), "jax",
                              types.SimpleNamespace(params=params), None, 3,
                              hps(jhp))
    rt = tmm.make_prior(hps(thp, restore_prior=str(
        tmp_path / "checkpoint_jax.jkb")), tvq, "cpu")
    assert rt.step == 3
    names = set(rt.params)
    for want in ("prime_prior.transformer.blocks.1.attn.c_attn.w",
                 "prime_state_proj.w", "prime_state_ln.g", "prime_x_out.w",
                 "prior.transformer.blocks.18.attn.c_enc_kv.w",
                 "prior.x_out.w"):
        assert want in names, want
    _assert_trees_equal(to_jax_params(rt.model), params)
    path = tmm.save_model_checkpoint(str(tmp_path), "port", rt, None, 4,
                                     hps(thp))
    jrt = jmm.make_prior(hps(jhp, restore_prior=path), jvq)
    assert jrt.step == 4
    _assert_trees_equal(jrt.params, params)
