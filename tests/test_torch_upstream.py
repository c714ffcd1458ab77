"""Upstream `.pth.tar` checkpoints read by the port on the CPU, held to the
JAX package's converter (jukebox_tpu/utils/torch_convert.py) on the same
state dicts, and the golden dump (make_models.save_outputs) held to the JAX
package's.

The files are written by chip_smoke.py's upstream writer (save_upstream:
upstream's module layout, hps pickled as jukebox.hparams.Hyperparams from a
module that exists only while writing, the priors' dense weights in fp16,
the rest fp32), from models holding the JAX package's weights, for six
tiny configurations whose in and out widths differ (m_conv, m_mlp 2, 40
codes against width 48), so that a wrong transpose shows as a wrong shape:
a 3-level VQ-VAE in both resnet layouts (model.{j} and blocks.{j}), an
upsampler with its conditioner, an unlabelled top (start_token), a
labelled top with the time signal, a single_enc_dec lyric top
(1b_lyrics-like, f7 layers) and a sep_enc_dec top with its lyric encoder
(5b_lyrics-like, an f6 layer, merged_decoder's x_out). The port restores
each through make_vqvae / make_prior with restore_* set to the file; the
JAX package converts the same state dict (convert_vqvae_state_dict /
convert_prior_state_dict):

* params and codebook state equal to the bit (from_jax_params of the JAX
  tree against the port's restore);
* the VQ-VAE's codes equal, its decodes within 1e-5; each prior's fp32 loss
  and logits within 1e-4;
* restore_opt keeps a fresh optimizer state and takes the file's step;
* a missing key raises naming it, an unknown pickled global raises, the
  stub's absence does not matter, and a fresh process restores a file
  without importing jax, jukebox_tpu or jukebox;
* the JAX package's own convert_checkpoint (torch.load with PyTorch's
  default weights_only=True) refuses such a file: it does not admit
  upstream's Hyperparams.

save_outputs runs on presets cut to narrow widths and one or two layers at
their own n_ctx (both packages' registries patched alike): 1b_lyrics
(labels_v3: the top alone) and 5b_lyrics (three levels); zs equal, x_ds
within 1e-5, each prior's x_out within 1e-5 and preds within 1e-4.
"""

import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_tiny import META, TOP, UP, VQ
from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.utils import torch_convert as jtc
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils import torch_convert as ttc
from jukebox_tpu_torch.utils.convert import from_jax_params, vqvae_tree

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
N = 2
VQ_U = dict(VQ, m_conv=2.0, l_bins=40, depth=2)
WIDE = dict(prior_width=48, m_mlp=2.0)
CONFIGS = {
    "upsampler": dict(UP, level=0, cond_m_conv=2.0, **WIDE),
    "top": dict(level=2, n_ctx=32, prior_depth=3, heads=2, attn_order=2,
                blocks=4, init_scale=0.7, labels=False, **WIDE),
    "top_labelled": dict(level=2, n_ctx=32, prior_depth=3, heads=2,
                         attn_order=2, blocks=4, init_scale=0.7, labels=True,
                         y_bins=(120, 4111), t_bins=16, max_bow_genre_size=5,
                         n_vocab=80, min_duration=0.0, max_duration=600.0,
                         use_tokens=False, **WIDE),
    "1b_like": dict(TOP, **WIDE),
    # order 10 at depth 20: the f6 layer at 18; a 2-layer lyric encoder of
    # width 32 over 8 tokens
    "5b_like": dict(level=2, n_ctx=64, prior_width=96, prior_depth=20,
                    heads=4, attn_order=10, blocks=8, init_scale=0.2,
                    m_mlp=2.0, labels=True, y_bins=(120, 4111), t_bins=16,
                    max_bow_genre_size=5, n_vocab=80, min_duration=0.0,
                    max_duration=600.0, use_tokens=True, n_tokens=8,
                    prime_width=32, prime_depth=2, prime_heads=2,
                    prime_attn_order=2, prime_blocks=4, prime_init_scale=0.7,
                    prime_m_mlp=2.0, prime_loss_fraction=0.4,
                    merged_decoder=True, sr=8000),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def vqs():
    """(JAX VQ-VAE with a random codebook, the port's on its weights)."""
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ_U)))
    rng = np.random.RandomState(0)
    jvq.state = {"level_blocks": [
        dict(s, k=jax.numpy.asarray(rng.randn(*s["k"].shape), "float32"))
        for s in jvq.state["level_blocks"]]}
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ_U)), "cpu")
    from_jax_params(tvq, vqvae_tree(_np(jvq.params), _np(jvq.state)))
    return jvq, tvq


def _prior_pair(name, vqs):
    jvq, tvq = vqs
    cfg = CONFIGS[name]
    jp = jmm.make_prior(jhp.setup_hparams("teeny", dict(cfg)), jvq)
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(cfg)), tvq, "cpu")
    from_jax_params(tp.model, _np(jp.params))
    return jp, tp, cfg


def _load_sd(path):
    """The file's state dict as numpy, `module.` stripped, for the JAX
    converter (read by the port's loader: the JAX package's own torch.load
    refuses the file, test_jax_convert_checkpoint_refuses_upstream_hps)."""
    sd = ttc.load_state(path)["model"]
    return {(k[7:] if k.startswith("module.") else k): v.numpy()
            for k, v in sd.items()}


def _assert_bits(got, want):
    a, b = dict(got.named_parameters()), dict(want.named_parameters())
    assert list(a) == list(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    ba, bb = dict(got.named_buffers()), dict(want.named_buffers())
    assert list(ba) == list(bb)
    for n in ba:
        assert torch.equal(ba[n], bb[n]), n


def _dtypes(path):
    return {str(v.dtype) for v in ttc.load_state(path)["model"].values()}


@pytest.mark.parametrize("layout,prefix", [("model", ""),
                                           ("blocks", "module.")])
def test_vqvae_matches_jax_converter(vqs, tmp_path, layout, prefix):
    jvq, tvq = vqs
    path = str(tmp_path / "vqvae.pth.tar")
    chip_smoke.save_upstream(path, tvq, dict(VQ_U), step=7, layout=layout,
                             prefix=prefix)
    assert "jukebox" not in sys.modules and "jukebox.hparams" not in \
        sys.modules
    keys = list(ttc.load_state(path)["model"])
    assert any(f".{layout}.0.model.1.weight" in k for k in keys)
    assert all(k.startswith(prefix) for k in keys)
    got = tmm.make_vqvae(thp.setup_hparams(
        "teeny", dict(VQ_U, restore_vqvae=path, seed=3)), "cpu")
    assert got.step == 7
    assert "jukebox" not in sys.modules
    params, state = jtc.convert_vqvae_state_dict(_load_sd(path), jvq.model)
    ref = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ_U, seed=5)),
                         "cpu")
    from_jax_params(ref, vqvae_tree(_np(params), _np(state)))
    _assert_bits(got, ref)
    # the codebook k as written, the EMA state as restore_state sets it
    for blk, tblk in zip(got.bottleneck.level_blocks,
                         tvq.bottleneck.level_blocks):
        assert torch.equal(blk.k, tblk.k) and torch.equal(blk.k_sum, blk.k)
        assert bool((blk.k_elem == 1).all()) and bool(blk.init)
    # outputs against the JAX VQ-VAE on the converted params and state
    jvq2 = jmm.VQVAERuntime(jvq.model, jax.device_put(params),
                            jax.device_put(state))
    x = np.random.RandomState(1).uniform(-1, 1, (N, VQ_U["sample_length"], 1)
                                         ).astype(np.float32)
    jzs = jvq2.encode(x, bs_chunks=N)
    tzs = got.encode(torch.from_numpy(x), bs_chunks=N)
    for jz, tz in zip(jzs, tzs):
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    for level in range(3):
        jx = np.asarray(jvq2.decode(jzs[level:], start_level=level))
        tx = got.decode(tzs[level:], start_level=level).numpy()
        np.testing.assert_allclose(tx, jx, atol=1e-5, rtol=0)


def _inputs(tp, cfg):
    rng = np.random.RandomState(2)
    z = rng.randint(0, VQ_U["l_bins"], (N, tp.n_ctx))
    z_conds = ([rng.randint(0, VQ_U["l_bins"],
                            (N, tp.z_shapes[tp.level + 1][0]))]
               if tp.model.x_cond else [])
    y = None
    if cfg.get("labels", True):
        labels = tp.labeller.get_batch_labels([META] * N)
        y = tp.get_y(labels, 0)
    return z, z_conds, y


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prior_matches_jax_converter(vqs, tmp_path, name):
    jp, tp, cfg = _prior_pair(name, vqs)
    path = str(tmp_path / f"{name}.pth.tar")
    chip_smoke.save_upstream(path, tp.model, dict(cfg), step=11, fp16=True,
                             prefix="module." if name == "1b_like" else "")
    assert _dtypes(path) == {"torch.float16", "torch.float32"}
    got = tmm.make_prior(thp.setup_hparams(
        "teeny", dict(cfg, restore_prior=path, seed=3)), vqs[1], "cpu")
    assert got.step == 11
    params = jtc.convert_prior_state_dict(_load_sd(path), jp.model)
    ref = tmm.make_prior(thp.setup_hparams("teeny", dict(cfg, seed=5)),
                         vqs[1], "cpu")
    from_jax_params(ref.model, _np(params))
    _assert_bits(got.model, ref.model)
    # the parts this configuration exercises
    names = set(dict(got.model.named_parameters()))
    want = {"upsampler": "conditioner_blocks.0.cond.proj.w",
            "top": "prior.start_token",
            "top_labelled": "y_emb.relative_pos_emb.emb.weight",
            "1b_like": "prior.x_emb.weight",
            "5b_like": "prime_x_out.w"}[name]
    assert want in names
    if name == "5b_like":
        assert {"prior.x_out.w", "prime_state_proj.w",
                "prior.transformer.blocks.18.attn.c_enc_kv.w"} <= names
    # outputs: the JAX runtime on the converted params
    jp.params = jax.device_put(params)
    z, z_conds, y = _inputs(got, cfg)
    jloss, jm = jp.z_forward(z, z_conds=z_conds, y=y, get_preds=True)
    tloss, tm = got.z_forward(z, z_conds=z_conds, y=y, get_preds=True)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tm["preds"].numpy(), np.asarray(jm["preds"]),
                               atol=1e-4, rtol=0)
    # restore_opt: a fresh state, the file's step
    fresh = {"step": 0, "m": {}, "v": {}}
    opt, step = tmm.restore_opt(fresh, path, got.model)
    assert opt is fresh and step == 11


def test_missing_key_raises(vqs, tmp_path):
    _, tp, cfg = _prior_pair("top", vqs)
    sd = chip_smoke.upstream_state_dict(tp.model)
    del sd["prior.transformer._attn_mods.1.mlp.c_fc.w"]
    path = str(tmp_path / "prior.pth.tar")
    torch.save(dict(model=sd, step=1), path)
    with pytest.raises(KeyError, match=r"_attn_mods\.1\.mlp\.c_fc\.w"):
        tmm.make_prior(thp.setup_hparams("teeny", dict(cfg,
                                                       restore_prior=path)),
                       vqs[1], "cpu")


def test_unknown_global_raises(tmp_path):
    mod = types.ModuleType("evil_module")
    cls = type("Payload", (), {"__module__": "evil_module"})
    mod.Payload = cls
    sys.modules["evil_module"] = mod
    try:
        torch.save(dict(model={}, hps=cls(), step=0),
                   str(tmp_path / "x.pth.tar"))
    finally:
        del sys.modules["evil_module"]
    with pytest.raises(pickle.UnpicklingError, match="evil_module"):
        tmm.load_any(str(tmp_path / "x.pth.tar"), "opt")


def test_hps_reads_as_a_dict(vqs, tmp_path):
    _, tvq = vqs
    path = str(tmp_path / "vqvae.pth.tar")
    chip_smoke.save_upstream(path, tvq, {"sr": 8000, "levels": 3,
                                         "hop": (0.5, 0.125)}, step=2)
    out = tmm.load_any(path, "opt")
    assert out["hps"] == {"sr": 8000, "levels": 3, "hop": (0.5, 0.125)}
    assert type(out["hps"]) is dict and out["step"] == 2
    assert out["params"] is None and out["opt"] is None
    assert "jukebox" not in sys.modules


def test_jax_convert_checkpoint_refuses_upstream_hps(vqs, tmp_path):
    """The JAX package's convert_checkpoint loads with torch.load's default
    (weights_only=True since PyTorch 2.6), which refuses upstream's pickled
    Hyperparams; the same state dict with a plain dict for hps converts."""
    jvq, tvq = vqs
    path = str(tmp_path / "vqvae.pth.tar")
    chip_smoke.save_upstream(path, tvq, {"sr": 8000}, step=1)
    with pytest.raises(pickle.UnpicklingError, match="jukebox.hparams"):
        jtc.convert_checkpoint(path, "vqvae", jvq)
    plain = str(tmp_path / "plain.pth.tar")
    torch.save(dict(ttc.load_state(path), hps={"sr": 8000}), plain)
    assert jtc.convert_checkpoint(plain, "vqvae", jvq)["step"] == 1


def test_restoring_upstream_imports_no_jax(vqs, tmp_path):
    _, tvq = vqs
    path = str(tmp_path / "vqvae.pth.tar")
    chip_smoke.save_upstream(path, tvq, dict(VQ_U), step=4)
    code = (
        "import sys\n"
        "from jukebox_tpu_torch import hparams as thp\n"
        "from jukebox_tpu_torch.models import make_models as tmm\n"
        f"vq = tmm.make_vqvae(thp.setup_hparams('teeny', dict({VQ_U!r}, "
        f"restore_vqvae={path!r})), 'cpu')\n"
        "assert vq.step == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jukebox_tpu', 'jukebox'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- the golden dump ------------------------------------------------------------

# the presets at narrow widths and one or two layers, their n_ctx kept (the
# dump hard-wires 6144 / 8192 codes and 384 / 512 lyric tokens)
NARROW = {
    "vqvae": dict(emb_width=16, l_bins=64, width=8, depth=1),
    "upsampler_level_0": dict(prior_width=32, prior_depth=1, cond_width=16,
                              cond_depth=1),
    "upsampler_level_1": dict(prior_width=32, prior_depth=1, cond_width=16,
                              cond_depth=1),
    "prior_1b_lyrics": dict(prior_width=32, prior_depth=2),
    "prior_5b_lyrics": dict(prior_width=32, prior_depth=2, heads=2,
                            prime_width=16, prime_depth=1, prime_heads=2),
}


def _narrow(monkeypatch):
    for hp in (jhp, thp):
        for name, over in NARROW.items():
            monkeypatch.setitem(hp.HPARAMS_REGISTRY, name,
                                hp.Hyperparams(hp.HPARAMS_REGISTRY[name],
                                               **over))


@pytest.mark.parametrize("model", ["1b_lyrics", "5b_lyrics"])
def test_save_outputs_matches_jax(tmp_path, monkeypatch, model):
    _narrow(monkeypatch)
    made = {}
    jmake = jmm.make_model

    def jax_models(*args, **kwargs):
        vq, priors = jmake(*args, **kwargs)
        rng = np.random.RandomState(4)
        vq.state = {"level_blocks": [
            dict(s, k=jax.numpy.asarray(rng.randn(*s["k"].shape),
                                        "float32"))
            for s in vq.state["level_blocks"]]}
        made.update(vq=vq, priors=priors)
        return vq, priors
    tmake = tmm.make_model

    def port_models(*args, **kwargs):
        """The port's models on the JAX package's weights."""
        vq, priors = tmake(*args, **kwargs)
        from_jax_params(vq, vqvae_tree(_np(made["vq"].params),
                                       _np(made["vq"].state)))
        for tp, jp in zip(priors, made["priors"]):
            from_jax_params(tp.model, _np(jp.params))
        return vq, priors
    monkeypatch.setattr(jmm, "make_model", jax_models)
    monkeypatch.setattr(tmm, "make_model", port_models)
    v3 = model == "1b_lyrics"
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jmm.save_outputs(model, None, jhp.Hyperparams(
        labels_v3=v3, sample_length=(6144 if v3 else 8192) * 128))
    monkeypatch.chdir(tmp_path / "torch")
    # the port's CLI: labels_v3 and the length from the presets
    tmm.run(model, device="cpu")
    with open(tmp_path / "jax" / "data.jkb", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "torch" / "data.jkb", "rb") as f:
        got = pickle.load(f)
    levels = [2] if v3 else [0, 1, 2]
    assert sorted(k for k in got if isinstance(k, int)) == levels
    assert sorted(k for k in want if isinstance(k, int)) == levels
    for a, b in zip(got["zs"], want["zs"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["x_ds"], want["x_ds"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for level in levels:
        g, w = got[level], want[level]
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])
        assert g["preds"].shape == w["preds"].shape
        np.testing.assert_allclose(g["x_out"], w["x_out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["preds"], w["preds"], atol=1e-4, rtol=0)
