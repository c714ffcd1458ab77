"""The tiny 3-level family the port's sampling tests share: a VQ-VAE, two
order-2 upsamplers and an order-12 lyric top prior (single_enc_dec, its f7
layer at depth 15), built by jukebox_tpu and by the port on the same
weights (from_jax_params) and the same codebooks."""

import jax
import numpy as np

from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils.convert import from_jax_params, vqvae_tree

VQ = dict(sample_length=512, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000)
UP = dict(n_ctx=32, prior_width=32, prior_depth=3, heads=1, attn_order=2,
          blocks=4, init_scale=0.7, cond_width=16, cond_depth=1,
          cond_dilation_growth_rate=1, cond_dilation_cycle=None,
          use_tokens=False, labels=True, y_bins=(120, 4111), t_bins=16,
          max_bow_genre_size=5, n_vocab=80, min_duration=0.0,
          max_duration=600.0, sr=8000)
TOP = dict(level=2, n_ctx=48, prior_width=32, prior_depth=16, heads=2,
           attn_order=12, blocks=4, init_scale=0.7, labels=True,
           labels_v3=True, y_bins=(604, 7898), t_bins=16,
           max_bow_genre_size=1, n_vocab=79, min_duration=0.0,
           max_duration=600.0, use_tokens=True, n_tokens=8,
           prime_loss_fraction=0.4, single_enc_dec=True, sr=8000)
# the lyric alignment's taps of the tiny top: its f7 layer, the second head
TAPS = dict(alignment_layer=15, alignment_head=1)
META = dict(artist="unknown", genre="unknown", lyrics="oh la la, la la la",
            total_length=8000 * 30, offset=0)


def vqvaes():
    """(JAX VQ-VAE, port VQ-VAE): the JAX codebooks given values (they start
    at zero and are fitted by training), the port's a copy."""
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    rng = np.random.RandomState(0)
    jvq.state = {"level_blocks": [
        dict(s, k=jax.numpy.asarray(rng.randn(*s["k"].shape), "float32"))
        for s in jvq.state["level_blocks"]]}
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    from_jax_params(tvq, vqvae_tree(
        jax.tree_util.tree_map(np.asarray, jvq.params),
        jax.tree_util.tree_map(np.asarray, jvq.state)))
    return jvq, tvq


def priors(cfgs, jvq, tvq):
    """The priors of `cfgs` in both packages, the port's on the JAX
    weights."""
    jps = [jmm.make_prior(jhp.setup_hparams("teeny", dict(c)), jvq)
           for c in cfgs]
    tps = [tmm.make_prior(thp.setup_hparams("teeny", dict(c)), tvq, "cpu")
           for c in cfgs]
    for jp, tp in zip(jps, tps):
        from_jax_params(tp.model, jax.tree_util.tree_map(np.asarray,
                                                         jp.params))
    return jps, tps


def family(top=TOP):
    """(jvq, JAX priors, tvq, port priors) of the 3-level family."""
    jvq, tvq = vqvaes()
    jps, tps = priors([dict(UP, level=0), dict(UP, level=1), top], jvq, tvq)
    return jvq, jps, tvq, tps
