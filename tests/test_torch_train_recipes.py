"""Upstream's other training recipes (README "Train the upsampler", the
labelled and lyric small priors) through the port's prior train step
against jukebox_tpu.train.make_prior_train_step on the CPU, each preset cut
to a few narrow layers (its attention orders, conditioning and options
kept): small_upsampler at level 0 of a 2-level VQ-VAE (a conditioner on
the codes above), small_labelled_prior, small_single_enc_dec_prior (the
lyrics in the stream, its f7 layer at depth 15) and
small_sep_enc_dec_prior (a lyric encoder, f6 cross-attention at depth 9)
at level 2 of a 3-level one, on labels whose artist and genre ids fall
inside the presets' y_bins (10, 100).

* Three fp32 steps from one state and one batch, clipped, with weight
  decay: test_torch_train_step.py's fp32 tolerances (loss per step within
  1e-5, the gradient norm within 1e-5 relative, params within 1e-3 x lr x
  steps, moments within 1e-4 of each leaf's largest |value|).
* c_attn / c_mlp (and the lyric encoder's prime_c_attn / prime_c_mlp):
  gradients equal bit for bit to the unflagged port's at dropout 0.1 (the
  recompute runs the same operations and draws the same masks), and one
  flagged step against JAX's flagged step to the same tolerances.
"""

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
from jukebox_tpu_torch.utils import train_utils as ttu
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             opt_state_from_jax,
                                             opt_state_to_jax, to_jax_params)

torch.set_num_threads(1)
LR, STEPS = 1e-3, 3
VQ = dict(emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000,
          hvqvae_multipliers=None)
VQ2 = dict(VQ, levels=2, downs_t=(2, 1), strides_t=(2, 2))
VQ3 = dict(VQ, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2))
NARROW = dict(n_ctx=256, prior_width=64, heads=2, blocks=16, prior=True,
              train=True, lr=LR, lr_warmup=1.0, weight_decay=0.01, clip=0.4,
              bs=2)
# preset -> (VQ-VAE, level, overrides that cut it to size)
RECIPES = {
    "small_upsampler": (VQ2, 0, dict(sample_length=1024, prior_depth=3,
                                     heads=1, cond_width=32, cond_depth=2,
                                     labels=False)),
    "small_labelled_prior": (VQ3, 2, dict(sample_length=4096, prior_depth=3,
                                          heads=1)),
    "small_single_enc_dec_prior": (VQ3, 2, dict(sample_length=4096,
                                                prior_depth=16, n_tokens=32)),
    "small_sep_enc_dec_prior": (VQ3, 2, dict(sample_length=4096,
                                             prior_depth=10, n_tokens=32,
                                             prime_width=32, prime_depth=2,
                                             prime_blocks=8)),
}
# the artist and genre of the labels: v3 ids 3 and 9, inside y_bins
META = dict(artist="dianne reeves", genre="bebop",
            lyrics="take five, take five", total_length=8000 * 90,
            offset=8000 * 20)
FLAGS = dict(c_attn=1, c_mlp=1, prime_c_attn=1, prime_c_mlp=1)


def recipe_hps(pkg, preset, **over):
    vq, level, cut = RECIPES[preset]
    kw = dict(vq, **NARROW)
    kw.update(level=level, **cut)
    kw.update(over)
    return pkg.setup_hparams(preset, kw)


def jax_vqvae_runtime(hps, tvq):
    """jukebox_tpu's VQ-VAE runtime on the port VQ-VAE's weights and
    random codebooks."""
    block = JBlockCfg(width=hps.width, depth=hps.depth, m_conv=hps.m_conv,
                      dilation_growth_rate=hps.dilation_growth_rate,
                      dilation_cycle=hps.dilation_cycle,
                      reverse_decoder_dilation=hps.vqvae_reverse_decoder_dilation)
    model = JVQVAE(input_shape=(hps.sample_length, 1), levels=hps.levels,
                   downs_t=tuple(hps.downs_t), strides_t=tuple(hps.strides_t),
                   emb_width=hps.emb_width, l_bins=hps.l_bins, mu=hps.l_mu,
                   commit=hps.commit, spectral=hps.spectral,
                   multispectral=hps.multispectral, multipliers=None,
                   use_bottleneck=hps.use_bottleneck, block=block)
    tree = jax.tree_util.tree_map(jnp.asarray, to_jax_params(tvq))
    state = model.init_state()
    state["level_blocks"] = [dict(s, k=jnp.asarray(b.k.numpy())) for s, b in
                             zip(state["level_blocks"],
                                 tvq.bottleneck.level_blocks)]
    return jmm.VQVAERuntime(model, {"encoders": tree["encoders"],
                                    "decoders": tree["decoders"]}, state)


def build(preset, seed=0, **over):
    """(JAX prior runtime, port prior runtime on its weights, JAX hps, port
    hps, audio x [2, T, 1], labels y or None)."""
    thps = recipe_hps(thp, preset, **over)
    jhps = recipe_hps(jhp, preset, **over)
    tvq = tmm.make_vqvae(thps, "cpu")
    jp = jmm.make_prior(jhps, jax_vqvae_runtime(jhps, tvq))
    tp = tmm.make_prior(thps, tvq, "cpu")
    from_jax_params(tp.model, jax.tree_util.tree_map(np.asarray, jp.params))
    y = (jp.get_y(jp.labeller.get_batch_labels([META] * 2), 0)
         if thps.labels else None)
    x = np.random.RandomState(seed).uniform(
        -1, 1, (2, thps.sample_length, 1)).astype(np.float32)
    return jp, tp, jhps, thps, x, y


def test_recipes_cut_as_planned():
    for preset, (vq, level, _) in RECIPES.items():
        hps = recipe_hps(thp, preset)
        assert hps.labels == (preset != "small_upsampler")
        if hps.labels:
            assert tuple(hps.y_bins) == (10, 100)
        assert hps.c_res == 1 and hps.level == level
    tr = lambda p: [thp.HPARAMS_REGISTRY[p]["attn_order"]]  # noqa: E731
    assert tr("small_single_enc_dec_prior") == [12]
    assert tr("small_sep_enc_dec_prior") == [8]


def _steps(preset, n_steps, **over):
    """n_steps of both packages' train steps from one state and batch:
    (JAX losses, port losses, JAX gns, port gns, JAX params, port params,
    JAX opt, port opt, p0)."""
    jp, tp, jhps, thps, x, y = build(preset, **over)
    p0 = jax.tree_util.tree_map(np.asarray, jp.params)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    jopt = jtu.adam_init(params)
    topt = opt_state_from_jax(tp.model, jax.tree_util.tree_map(np.asarray,
                                                               jopt))
    jstep = jtrain.make_prior_train_step(jp, jhps, jtu.make_lr_schedule(jhps))
    tstep = ttrain.make_prior_train_step(tp, thps,
                                         ttu.make_lr_schedule(thps))
    yj = None if y is None else jnp.asarray(y)
    yt = None if y is None else torch.from_numpy(y)
    out = dict(jl=[], tl=[], jg=[], tg=[])
    for it in range(1, n_steps + 1):
        params, jopt, _, jloss, jm = jstep(params, jopt, None,
                                           (jnp.asarray(x), yj),
                                           jax.random.key(it),
                                           jnp.asarray(it), 1.0)
        tloss, tm = tstep(topt, (torch.from_numpy(x), yt), None, it, 1.0)
        assert tm["step_ok"] and bool(jm["step_ok"])
        out["jl"].append(float(jloss))
        out["tl"].append(float(tloss))
        out["jg"].append(float(jm["gn"]))
        out["tg"].append(float(tm["gn"]))
    return out, params, jopt, tp, topt, p0


def _assert_match(out, params, jopt, tp, topt, n_steps):
    for jl, tl, jg, tg in zip(out["jl"], out["tl"], out["jg"], out["tg"]):
        assert tl == pytest.approx(jl, abs=1e-5)
        assert tg == pytest.approx(jg, rel=1e-5)
    jp_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    tp_flat = flatten_tree(to_jax_params(tp.model))
    assert jp_flat.keys() == tp_flat.keys()
    for k, ref in jp_flat.items():
        np.testing.assert_allclose(tp_flat[k], ref, rtol=0,
                                   atol=1e-3 * LR * n_steps, err_msg=k)
    jo = flatten_tree(jax.tree_util.tree_map(np.asarray, jopt))
    to = flatten_tree(opt_state_to_jax(tp.model, topt))
    for k, ref in jo.items():
        if k.startswith(("m.", "v.")):
            np.testing.assert_allclose(
                to[k], ref, rtol=0, atol=1e-4 * np.abs(ref).max() + 1e-20,
                err_msg=k)


@pytest.mark.parametrize("preset", list(RECIPES))
def test_three_steps_match_jax(preset):
    out, params, jopt, tp, topt, _ = _steps(preset, STEPS)
    assert max(out["jg"]) > NARROW["clip"]  # the clip was taken
    assert topt["step"] == int(jopt["step"]) == STEPS
    _assert_match(out, params, jopt, tp, topt, STEPS)


def _grads(preset, flags):
    """Loss and gradients of one batch at dropout 0.1, seeded."""
    _, tp, _, thps, x, y = build(preset, attn_dropout=0.1, resid_dropout=0.1,
                                 emb_dropout=0.1, prime_attn_dropout=0.1,
                                 prime_resid_dropout=0.1, **flags)
    z = tp.vqvae.encode(torch.from_numpy(x), start_level=tp.level)
    loss, _ = tp.model.z_forward(z[0], z[1:] or None,
                                 None if y is None else torch.from_numpy(y),
                                 seed=5)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  tp.model.named_parameters()}


@pytest.mark.parametrize("preset", ["small_upsampler",
                                    "small_sep_enc_dec_prior"])
def test_c_attn_c_mlp_same_grads_and_match_jax(preset):
    loss0, g0 = _grads(preset, {})
    loss1, g1 = _grads(preset, FLAGS)
    assert loss0 == loss1
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    if preset == "small_sep_enc_dec_prior":
        assert any(n.startswith("prime_prior.") for n in g1)
    # the flags reach every block of both transformers
    _, tp, *_ = build(preset, **FLAGS)
    trs = [tp.model.prior.transformer] + (
        [tp.model.prime_prior.transformer] if tp.model.prime_prior else [])
    assert all(b.checkpoint_attn == b.checkpoint_mlp == 1
               for tr in trs for b in tr.blocks)
    out, params, jopt, tp, topt, _ = _steps(preset, 1, **FLAGS)
    _assert_match(out, params, jopt, tp, topt, 1)
