"""The port's prior training forward against jukebox_tpu on the CPU: a tiny
single-enc-dec order-12 top prior with lyrics (48 layers: f7 prime layers at
15 and 31, the f0 dense layer at 47), on converted params and a VQ-VAE with a
random codebook, fp32. The codes of both encoders must be equal.

* z_forward: the loss and its prime / gen parts within 1e-5, and every
  parameter gradient within 1e-4 of its leaf's largest |gradient| against
  jax.grad (fp32 through 48 layers; the two differ in summation order only);
* checkpoint_res=1 gives the same gradients as 0 at dropout 0.1, also with
  the f0 layer on the flash path in bf16 (port only: the recompute must draw
  the same dropout masks): equal, since the recompute runs the same
  operations on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.models.encdec import BlockCfg as JBlockCfg
from jukebox_tpu.models.vqvae import VQVAE as JVQVAE
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import attention as tattn
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.ops import flash_attention as tfa
from jukebox_tpu_torch.utils.convert import (from_jax_params, named_leaves,
                                             to_jax_params)

torch.set_num_threads(1)
VQ = dict(sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000)
TOP = dict(level=2, n_ctx=16, prior_width=16, prior_depth=48, heads=2,
           attn_order=12, blocks=4, init_scale=0.7, labels=True,
           labels_v3=True, y_bins=(604, 7898), t_bins=16,
           max_bow_genre_size=1, n_vocab=79, min_duration=0.0,
           max_duration=600.0, use_tokens=True, n_tokens=8,
           prime_loss_fraction=0.4, single_enc_dec=True, sr=8000)
META = dict(artist="unknown", genre="unknown", lyrics="la la la la la",
            total_length=8000 * 30, offset=0)


def jax_vqvae_runtime(tvq):
    """jukebox_tpu's VQ-VAE runtime on the port VQ-VAE's weights and random
    codebook (a fresh JAX codebook is all zeros, so every code would be 0),
    built as jukebox_tpu's make_vqvae builds it, without its random init
    (which compiles one XLA program per conv shape)."""
    hps = jhp.setup_hparams("teeny", dict(VQ))
    block = JBlockCfg(width=hps.width, depth=hps.depth, m_conv=hps.m_conv,
                      dilation_growth_rate=hps.dilation_growth_rate,
                      dilation_cycle=hps.dilation_cycle,
                      reverse_decoder_dilation=hps.vqvae_reverse_decoder_dilation)
    model = JVQVAE(input_shape=(hps.sample_length, 1), levels=hps.levels,
                   downs_t=tuple(hps.downs_t), strides_t=tuple(hps.strides_t),
                   emb_width=hps.emb_width, l_bins=hps.l_bins, mu=hps.l_mu,
                   commit=hps.commit, spectral=hps.spectral,
                   multispectral=hps.multispectral,
                   multipliers=(tuple(hps.hvqvae_multipliers)
                                if hps.hvqvae_multipliers else None),
                   use_bottleneck=hps.use_bottleneck, block=block)
    tree = jax.tree_util.tree_map(jnp.asarray, to_jax_params(tvq))
    state = model.init_state()
    state["level_blocks"] = [dict(s, k=jnp.asarray(b.k.numpy())) for s, b in
                             zip(state["level_blocks"],
                                 tvq.bottleneck.level_blocks)]
    return jmm.VQVAERuntime(model, {"encoders": tree["encoders"],
                                    "decoders": tree["decoders"]}, state)


def build_pair(top, seed=0):
    """JAX and port VQ-VAE + prior on the same weights, a label batch y and
    audio x [2, sample_length, 1]."""
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ, seed=seed)),
                         "cpu")
    jvq = jax_vqvae_runtime(tvq)
    jp = jmm.make_prior(jhp.setup_hparams("teeny", dict(top, **VQ)), jvq)
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(top, **VQ)), tvq,
                        "cpu")
    from_jax_params(tp.model, jax.tree_util.tree_map(np.asarray, jp.params))
    y = jp.get_y(jp.labeller.get_batch_labels([META] * 2), 0)
    x = np.random.RandomState(seed).uniform(
        -1, 1, (2, VQ["sample_length"], 1)).astype(np.float32)
    return jvq, jp, tvq, tp, x, y


@pytest.fixture(scope="module")
def pair():
    return build_pair(dict(TOP, train=True))


def test_f0_layer_present(pair):
    tr = pair[3].model.prior.transformer
    assert [tr.attn_func(d) for d in (15, 31, 47)] == [7, 7, 0]


def test_z_forward_loss_and_grads(pair):
    jvq, jp, tvq, tp, x, y = pair
    zj = jvq.encode(jnp.asarray(x), start_level=2)[0]
    zt = tvq.encode(torch.from_numpy(x), start_level=2)[0]
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))

    def loss_fn(params):
        return jp.model.z_forward(params, zj, z_conds=[], y=jnp.asarray(y))

    (ref, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp.params)
    loss, metrics = tp.model.z_forward(zt, None, torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), abs=1e-5)
    for k in ("bpd", "prime_loss", "gen_loss"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), abs=1e-5)
    ref_grads = named_leaves(tp.model, jax.tree_util.tree_map(np.asarray,
                                                              jgrads))
    for name, p in tp.model.named_parameters():
        r = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("flash", [False, True])
def test_checkpoint_res_same_grads(monkeypatch, flash):
    if flash:  # put the f0 layer (L = 24) on the flash path
        monkeypatch.setattr(tattn, "_FLASH_MIN_CTX", 0)
    cfg = dict(TOP, train=True, attn_dropout=0.1, resid_dropout=0.1,
               emb_dropout=0.1)
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    grads, losses = [], []
    for c_res in (0, 1):
        tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
        tp = tmm.make_prior(thp.setup_hparams("teeny", dict(
            cfg, c_res=c_res, **VQ)), tvq, "cpu")
        y = torch.from_numpy(tp.get_y(tp.labeller.get_batch_labels(
            [META] * 2), 0))
        z = torch.from_numpy(np.random.RandomState(1).randint(0, 32, (2, 16)))
        loss, _ = tp.model.z_forward(z, None, y, fp16=flash, seed=11)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in tp.model.named_parameters()})
    # the f0 layer's forward runs again in the recompute
    assert len(calls) == (3 if flash else 0)
    assert losses[0] == losses[1]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    # dropout is on: the same model without a seed gives another loss
    assert tp.model.z_forward(z, None, y, fp16=flash)[0].item() != losses[1]
