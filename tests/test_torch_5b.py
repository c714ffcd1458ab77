"""The 5b priors of the PyTorch port against jukebox_tpu on the CPU, on the
same params (numpy-seeded random values in every leaf, carried by
from_jax_params):

* a narrow 5b_lyrics-like top prior: order 10 at depth 20 (the f6 layer at
  d = 18), width 96 with 4 heads of width 6, merged_decoder (its own x_out,
  no x_cond after the transformer), v2 labels, and a 2-layer lyric encoder
  over 8 lyric tokens whose encoder_kv the f6 layer reads:
  1. teacher-forced logits and the prime / gen losses in fp32 against the
     JAX forward: 2e-5 abs + 2e-5 rel (summation order only);
  2. the token stream at top_k=1 in fp32 against the JAX sampler: equal;
* a narrow prior_5b (order 2, heads of width 6, merged_decoder, no lyrics):
  fp32 decode-step logits on a forced stream against the JAX teacher-forced
  logits (1e-4, as tests/test_torch_prior.py), and its top_k=1 stream;
* a tiny 5b_lyrics-like cascade (VQ-VAE, two upsamplers, that top) sampled
  at temp 0 in fp32 by sample.ancestral_sample: the codes at every level
  equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu import sample as jsample
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import sample as tsample
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils.convert import from_jax_params, vqvae_tree

torch.set_num_threads(1)
VQ = dict(sample_length=512, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000)
LABELS_V2 = dict(labels=True, y_bins=(120, 4111), t_bins=16,
                 max_bow_genre_size=5, n_vocab=80, min_duration=0.0,
                 max_duration=600.0, sr=8000)
TOP_5B_LYRICS = dict(level=2, n_ctx=32, prior_width=96, prior_depth=20,
                     heads=4, attn_order=10, blocks=4, init_scale=0.7,
                     use_tokens=True, n_tokens=8, prime_width=32,
                     prime_depth=2, prime_heads=2, prime_attn_order=2,
                     prime_blocks=4, prime_init_scale=0.7,
                     prime_loss_fraction=0.4, merged_decoder=True,
                     **LABELS_V2)
TOP_5B = dict(level=2, n_ctx=32, prior_width=96, prior_depth=6, heads=4,
              attn_order=2, blocks=4, init_scale=0.7, use_tokens=False,
              n_tokens=0, prime_loss_fraction=0.0, merged_decoder=True,
              **LABELS_V2)
UP = dict(n_ctx=32, prior_width=32, prior_depth=3, heads=1, attn_order=2,
          blocks=4, init_scale=0.7, cond_width=16, cond_depth=1,
          cond_dilation_growth_rate=1, cond_dilation_cycle=None,
          use_tokens=False, **LABELS_V2)
META = dict(artist="unknown", genre="unknown", lyrics="oh la la, la la la",
            total_length=8000 * 30, offset=0)
N = 2


def perturb(jp, seed, scale=0.1):
    """Random values in every leaf of the JAX prior (the init zeroes the
    biases and the f6 layers' c_proj), as numpy."""
    rng = np.random.RandomState(seed)
    jp.params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(
            np.float32), jax.tree_util.tree_map(np.asarray, jp.params))
    return jp


def build(cfg, jvq=None, tvq=None, seed=0):
    jvq = jvq or jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    tvq = tvq or tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    jp = perturb(jmm.make_prior(jhp.setup_hparams("teeny", dict(cfg)), jvq),
                 seed)
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(cfg)), tvq, "cpu")
    from_jax_params(tp.model, jp.params)
    return jp, tp


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def lyrics_top():
    jp, tp = build(TOP_5B_LYRICS)
    y = jp.get_y(jp.labeller.get_batch_labels([META] * N), 0)
    z = np.random.RandomState(1).randint(0, VQ["l_bins"], (N, jp.n_ctx))
    return jp, tp, y, z


def test_5b_lyrics_prior_structure(lyrics_top):
    _, tp, _, _ = lyrics_top
    m = tp.model
    tr = m.prior.transformer
    assert [tr.attn_func(d) for d in range(20)].count(6) == 1
    assert tr.blocks[18].attn.c_enc_kv.w.shape == (96, 48)
    assert tr.blocks[18].attn.c_attn.w.shape == (96, 24)
    assert m.prior.x_out.w.shape == (96, 32)
    assert not m.prior.add_cond_after_transformer
    assert m.prime_prior.only_encode and m.prime_x_out.w.shape == (96, 80)


def test_teacher_forced_logits_and_losses(lyrics_top):
    jp, tp, y, z = lyrics_top
    (loss, metrics) = jp.model.z_forward(jp.params, jnp.asarray(z),
                                         y=jnp.asarray(y), get_preds=True)
    with torch.no_grad():
        logits = tp.model(_t(z), None, _t(y))
        t_loss, t_metrics = tp.model.z_forward(_t(z), None, _t(y))
    np.testing.assert_allclose(logits.numpy(), np.asarray(metrics["preds"]),
                               rtol=2e-5, atol=2e-5)
    for key in ("prime_loss", "gen_loss"):
        np.testing.assert_allclose(float(t_metrics[key]),
                                   float(metrics[key]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=2e-5,
                               atol=2e-5)


def test_top_k1_token_stream_is_exact(lyrics_top):
    jp, tp, y, _ = lyrics_top
    ref = jp.sample(N, y=y, rng=jax.random.key(0), fp16=False, temp=1.0,
                    top_k=1)
    out = tp.sample(N, y=_t(y), fp16=False, temp=1.0, top_k=1)
    assert out.shape == (N, jp.n_ctx)
    assert len(np.unique(np.asarray(ref))) > 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_prior_5b_decode_logits_and_stream():
    jp, tp = build(TOP_5B, seed=2)
    m = tp.model
    assert m.prime_prior is None and not m.prior.share_x_emb_x_out
    y = jp.get_y(jp.labeller.get_batch_labels([META] * N), 0)
    z = np.random.RandomState(3).randint(0, VQ["l_bins"], (N, jp.n_ctx))
    _, metrics = jp.model.z_forward(jp.params, jnp.asarray(z),
                                    y=jnp.asarray(y), get_preds=True)
    ref = np.asarray(metrics["preds"])
    with torch.no_grad():
        caches, x_tok, x_cond, y_cond = m.sample_init(N, y=_t(y))
        for t in range(jp.n_ctx):
            logits = m.prior._decode_one(None, caches, x_tok, t, x_cond,
                                         y_cond, False, N)
            np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, t],
                                       rtol=1e-4, atol=1e-4, err_msg=f"{t}")
            x_tok = _t(z[:, t:t + 1])
    ref_toks = jp.sample(N, y=y, rng=jax.random.key(0), fp16=False, temp=1.0,
                         top_k=1)
    out = tp.sample(N, y=_t(y), fp16=False, temp=1.0, top_k=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_toks))


def test_5b_lyrics_cascade_matches_jax(tmp_path):
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    rng = np.random.RandomState(0)
    jvq.state = {"level_blocks": [
        dict(s, k=jnp.asarray(rng.randn(*s["k"].shape), "float32"))
        for s in jvq.state["level_blocks"]]}
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    from_jax_params(tvq, vqvae_tree(
        jax.tree_util.tree_map(np.asarray, jvq.params),
        jax.tree_util.tree_map(np.asarray, jvq.state)))
    cfgs = [dict(UP, level=0), dict(UP, level=1), TOP_5B_LYRICS]
    pairs = [build(c, jvq, tvq, seed=10 + i) for i, c in enumerate(cfgs)]
    jpriors, tpriors = [p[0] for p in pairs], [p[1] for p in pairs]

    def hps(name):
        return dict(n_samples=N, sample_length=VQ["sample_length"],
                    sr=VQ["sr"], hop_fraction=(0.5, 0.5, 0.125), seed=0,
                    name=str(tmp_path / name))
    skw = [dict(temp=0.0, fp16=False, chunk_size=8, max_batch_size=N)
           for _ in cfgs]
    labels = [p.labeller.get_batch_labels([META] * N) for p in jpriors]
    jzs = jsample.ancestral_sample(
        labels, [dict(s) for s in skw], jpriors,
        jhp.Hyperparams(levels=3, n_tokens=TOP_5B_LYRICS["n_tokens"],
                        pipeline_cascade=False, **hps("jax")))
    tzs = tsample.ancestral_sample(labels, [dict(s) for s in skw], tpriors,
                                   thp.Hyperparams(**hps("torch")))
    for level in range(3):
        want = VQ["sample_length"] // tpriors[level].raw_to_tokens
        assert tzs[level].shape == (N, want)
        np.testing.assert_array_equal(tzs[level], np.asarray(jzs[level]),
                                      err_msg=f"level {level}")
    assert len(np.unique(tzs[2])) > 1
    assert (tmp_path / "torch" / "level_0" / "item_1.wav").exists()
