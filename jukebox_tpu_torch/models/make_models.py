"""Model factories, the sampling runtime and the training runtime of the
PyTorch port (counterpart of jukebox_tpu/models/make_models.py). Models are
built on their device and drawn there from a seed, then restored from
hps.restore_vqvae / hps.restore_prior when those name a checkpoint: a
`.jkb` file of either package (utils/checkpoints.py), or a REMOTE_PREFIX
path cached under ~/.cache as the JAX package looks for it; a path that
does not exist falls back to the fresh init with a message, as in the JAX
package. With hps.train a prior's parameters are trainable fp32 masters and
its dropouts and activation checkpointing follow hps; the VQ-VAE stays
frozen.
"""

import os

import numpy as np
import torch

from jukebox_tpu_torch.hparams import REMOTE_PREFIX, setup_hparams
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.prior import SimplePrior
from jukebox_tpu_torch.models.vqvae import VQVAE, calculate_strides
from jukebox_tpu_torch.ops.core import init_weights
from jukebox_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                 save_checkpoint)
from jukebox_tpu_torch.utils.convert import (from_jax_params, named_to_tree,
                                             opt_state_from_jax,
                                             opt_state_to_jax, to_jax_params,
                                             vqvae_tree)

MODELS = {
    "1b_lyrics": ("vqvae", "upsampler_level_0", "upsampler_level_1",
                  "prior_1b_lyrics"),
}


# prior keys the port does not build, with the value that builds nothing
_UNPORTED_PRIOR_KEYS = dict(spread=None, pos_init=False, copy_input=False,
                            merged_decoder=False)
# hps entries a checkpoint does not keep (jukebox_tpu save_model_checkpoint)
_UNSAVED_HPS = ("metadata_v2", "metadata_v3", "alignments", "lyric_processor",
                "midi_processor", "bandwidth")


# ---------------------------------------------------------------------------
# restore and save (jukebox_tpu make_models.py:192-251)
# ---------------------------------------------------------------------------

def resolve_restore(path):
    """The local file of a restore spec, or None (with the JAX package's
    message) when nothing restorable exists: REMOTE_PREFIX paths must be
    cached under ~/.cache, as the reference lays them out."""
    if not path:
        return None
    if path.startswith(REMOTE_PREFIX):
        local = os.path.join(os.path.expanduser("~/.cache"),
                             path[len(REMOTE_PREFIX):])
        if os.path.exists(local):
            return local
        print(f"[make_models] remote checkpoint {path} not cached at {local}; "
              f"using fresh init")
        return None
    if os.path.exists(path):
        return path
    print(f"[make_models] checkpoint {path} not found; using fresh init")
    return None


def load_any(path):
    """A `.jkb` checkpoint as its numpy tree. Upstream `.pth.tar` state
    dicts are not converted yet (ROADMAP queue 1 item 1)."""
    if path.endswith(".pth.tar"):
        raise NotImplementedError(
            f"{path}: upstream .pth.tar checkpoints are not converted by the "
            f"port yet (ROADMAP queue 1 item 1); restore a .jkb file")
    return load_checkpoint(path)


def restore_model(model, checkpoint_path):
    """Copy a checkpoint's params (and, for a VQ-VAE, the codebooks of its
    state) into `model`. Returns the checkpoint's step, 0 when nothing is
    restorable (the model keeps its fresh init)."""
    path = resolve_restore(checkpoint_path)
    if path is None:
        return 0
    ckpt = load_any(path)
    params = ckpt["params"]
    if isinstance(model, VQVAE):
        params = vqvae_tree(params, ckpt["state"])
    from_jax_params(model, params)
    print(f"Restored from {path}")
    return int(np.asarray(ckpt.get("step", 0)))


def restore_opt(opt_state, checkpoint_path, model):
    """(opt_state, step): the checkpoint's optimizer state for `model`'s
    parameters on their device, or opt_state unchanged and 0 when there is
    no checkpoint or it holds none."""
    path = resolve_restore(checkpoint_path)
    if path is None:
        return opt_state, 0
    ckpt = load_any(path)
    opt = ckpt.get("opt")
    step = int(np.asarray(ckpt.get("step", 0)))
    if opt is None:
        return opt_state, step
    device = next(model.parameters()).device
    return opt_state_from_jax(model, opt, device), step


def save_model_checkpoint(logdir, name, runtime, opt_state, step, hps,
                          params=None):
    """{logdir}/checkpoint_{name}.jkb with hps, params (the model's, or
    `params` as {name: tensor or array}, e.g. an EMA shadow), the JAX
    layout of opt_state and step. Returns the path."""
    save_hps = {k: v for k, v in dict(hps).items() if k not in _UNSAVED_HPS}
    tree = (to_jax_params(runtime.model) if params is None
            else named_to_tree(runtime.model, params))
    payload = dict(hps=save_hps, params=tree, state=None,
                   opt=opt_state_to_jax(runtime.model, opt_state), step=step)
    path = f"{logdir}/checkpoint_{name}.jkb"
    save_checkpoint(path, payload)
    return path


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def make_vqvae(hps, device="cuda"):
    block = BlockCfg(width=hps.width, depth=hps.depth, m_conv=hps.m_conv,
                     dilation_growth_rate=hps.dilation_growth_rate,
                     dilation_cycle=hps.dilation_cycle,
                     reverse_decoder_dilation=hps.vqvae_reverse_decoder_dilation)
    if not hps.sample_length:
        assert hps.sample_length_in_seconds != 0
        top_raw_to_tokens = int(np.prod(calculate_strides(hps.strides_t,
                                                          hps.downs_t)))
        hps.sample_length = ((hps.sample_length_in_seconds * hps.sr)
                             // top_raw_to_tokens) * top_raw_to_tokens
    model = VQVAE((hps.sample_length, 1), hps.levels, hps.downs_t,
                  hps.strides_t, hps.emb_width, hps.l_bins,
                  hps.hvqvae_multipliers, block, device=device)
    init_weights(model, hps.get("seed", 0), device).eval()
    restore_model(model, hps.restore_vqvae)
    return model


def make_prior(hps, vqvae, device="cuda"):
    train = hps.get("train", False)
    if train and (hps.get("c_attn", 0) or hps.get("c_mlp", 0)):
        raise NotImplementedError("c_attn / c_mlp checkpointing is not "
                                  "ported; c_res is")
    dropped = {k: hps.get(k, v) for k, v in _UNPORTED_PRIOR_KEYS.items()
               if hps.get(k, v) != v}
    if dropped:
        raise NotImplementedError(f"prior options {dropped} are not ported")
    prior_kwargs = dict(
        input_shape=(hps.n_ctx,), bins=vqvae.l_bins, width=hps.prior_width,
        depth=hps.prior_depth, heads=hps.heads, attn_order=hps.attn_order,
        blocks=hps.blocks, zero_out=hps.zero_out, res_scale=hps.res_scale,
        init_scale=hps.init_scale, m_attn=hps.m_attn, m_mlp=hps.m_mlp,
        attn_dropout=hps.attn_dropout if train else 0.0,
        resid_dropout=hps.resid_dropout if train else 0.0,
        emb_dropout=hps.emb_dropout if train else 0.0,
        checkpoint_res=hps.c_res if train else 0)
    x_cond_kwargs = dict(
        out_width=hps.prior_width, init_scale=hps.init_scale,
        width=hps.cond_width, depth=hps.cond_depth, m_conv=hps.cond_m_conv,
        dilation_growth_rate=hps.cond_dilation_growth_rate,
        dilation_cycle=hps.cond_dilation_cycle, zero_out=hps.cond_zero_out,
        res_scale=hps.cond_res_scale)
    y_cond_kwargs = dict(
        out_width=hps.prior_width, init_scale=hps.init_scale,
        y_bins=hps.y_bins, t_bins=hps.t_bins, sr=hps.sr,
        min_duration=hps.min_duration, max_duration=hps.max_duration,
        max_bow_genre_size=hps.max_bow_genre_size)
    prime_kwargs = dict(use_tokens=hps.use_tokens, n_tokens=hps.n_tokens,
                        bins=hps.n_vocab,
                        prime_loss_fraction=hps.prime_loss_fraction)
    # z_shapes of every level when this level gets n_ctx codes
    z_shapes = [(z[0] * hps.n_ctx // vqvae.z_shapes[hps.level][0],)
                for z in vqvae.z_shapes]
    model = SimplePrior(z_shapes, vqvae.l_bins, hps.level, vqvae.downs_t,
                        vqvae.strides_t, prior_kwargs, x_cond_kwargs,
                        y_cond_kwargs, prime_kwargs, labels=hps.labels,
                        labels_v3=hps.labels_v3,
                        single_enc_dec=hps.single_enc_dec, device=device)
    init_weights(model, hps.get("seed", 0) + hps.level + 1, device)
    model.requires_grad_(bool(train))
    runtime = PriorRuntime(model.eval(), vqvae)
    runtime.step = restore_model(model, hps.restore_prior)
    return runtime


class PriorRuntime:
    """A prior with its sampling and training entry points. stage_decode
    stages the bf16 decode form (weights the decode kernels stream); sample
    runs one window: sample_init (conditioning + prefill), the token loop,
    and sample_finish. params are the trainable fp32 masters by name; step
    counts the optimizer steps taken."""

    def __init__(self, model, vqvae):
        self.model, self.vqvae = model, vqvae
        self.staged = None
        self.step = 0

    @property
    def params(self):
        return dict(self.model.named_parameters())

    def __getattr__(self, name):
        # n_ctx, raw_to_tokens, labeller, n_tokens, level, z_shapes, ...
        return getattr(self.__dict__["model"], name)

    def stage_decode(self):
        if self.staged is None:
            self.staged = self.model.prior.transformer.prepare_decode_params(
                torch.bfloat16)

    def release(self):
        self.staged = None

    def decode(self, zs, start_level=None, end_level=None, bs_chunks=1):
        start_level = self.model.level if start_level is None else start_level
        end_level = self.model.levels if end_level is None else end_level
        return self.vqvae.decode(zs, start_level, end_level, bs_chunks)

    @torch.no_grad()
    def sample(self, n_samples, z=None, z_conds=None, y=None, gen=None,
               fp16=False, temp=1.0, top_k=0, top_p=0.0, chunk_size=None,
               sample_tokens=None):
        model = self.model
        dec = None
        if fp16:
            self.stage_decode()
            dec = self.staged
        if z is not None and z.shape[1] == 0:
            z = None
        caches, x_tok, x_cond, y_cond = model.sample_init(
            n_samples, z=z, z_conds=z_conds, y=y, fp16=fp16,
            chunk_size=chunk_size, dec_params=dec)
        t = model.sample_prefix_len(z)
        total = sample_tokens if sample_tokens is not None else model.n_ctx
        if model.single_enc_dec:
            total += model.n_tokens
        toks, _ = model.sample_segment(
            caches, x_tok, t, total - t, gen, x_cond, y_cond, fp16=fp16,
            temp=temp, top_k=top_k, top_p=top_p, dec_params=dec)
        return model.sample_finish(toks, z=z)


def make_model(model, hps, device="cuda", prior_overrides=None):
    """The VQ-VAE and the priors of a registered model, drawn from
    hps.seed. prior_overrides: optional per-level dicts merged into each
    prior's hparams (e.g. a cut prior_depth)."""
    vqvae_name, *prior_names = MODELS[model]
    vqvae = make_vqvae(setup_hparams(vqvae_name, dict(
        sample_length=hps.get("sample_length", 0),
        sample_length_in_seconds=hps.get("sample_length_in_seconds", 0),
        seed=hps.get("seed", 0))), device)
    hps.sample_length = vqvae.sample_length
    overrides = prior_overrides or [{}] * len(prior_names)
    priors = [make_prior(setup_hparams(name, dict(seed=hps.get("seed", 0),
                                                  **over)), vqvae, device)
              for name, over in zip(prior_names, overrides)]
    return vqvae, priors
