"""Model factories, the sampling runtime and the training runtime of the
PyTorch port (counterpart of jukebox_tpu/models/make_models.py). Models are
built on their device and drawn there from a seed, then restored from
hps.restore_vqvae / hps.restore_prior when those name a checkpoint: a
`.jkb` file of either package (utils/checkpoints.py) or upstream's
`.pth.tar` (utils/torch_convert.py), local or a REMOTE_PREFIX path cached
under ~/.cache as the JAX package looks for it (the presets' files at
~/.cache/jukebox/models/<model>/<file>.pth.tar); a path that
does not exist falls back to the fresh init with a message, as in the JAX
package. With hps.train a prior's parameters are trainable fp32 masters and
its dropouts and activation checkpointing (c_res, c_attn, c_mlp and the
lyric encoder's prime_c_*) follow hps, and the VQ-VAE stays
frozen; with hps.train and not hps.prior the VQ-VAE is the model trained:
its parameters are trainable and its codebooks start unseeded (or from the
restored checkpoint, their EMA statistics reset for fine-tuning). A
sampling prior with hps.fp16_params holds its weights in bf16
after the restore, LayerNorms in fp32 (convert_params_bf16).
"""

import os
import pickle

import numpy as np
import torch

from jukebox_tpu_torch.hparams import (REMOTE_PREFIX, Hyperparams,
                                      setup_hparams)
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.prior import SimplePrior
from jukebox_tpu_torch.models.vqvae import VQVAE, calculate_strides
from jukebox_tpu_torch.ops.core import init_weights
from jukebox_tpu_torch.parallel.dist import get_rank
from jukebox_tpu_torch.utils.checkpoints import (load_checkpoint,
                                                 save_checkpoint)
from jukebox_tpu_torch.utils.convert import (from_jax_params, named_to_tree,
                                             opt_state_from_jax,
                                             opt_state_to_jax, to_jax_params,
                                             vqvae_state, vqvae_tree)
from jukebox_tpu_torch.utils.torch_convert import convert_checkpoint

MODELS = {
    "5b": ("vqvae", "upsampler_level_0", "upsampler_level_1", "prior_5b"),
    "5b_lyrics": ("vqvae", "upsampler_level_0", "upsampler_level_1",
                  "prior_5b_lyrics"),
    "1b_lyrics": ("vqvae", "upsampler_level_0", "upsampler_level_1",
                  "prior_1b_lyrics"),
}


# prior keys the port refuses, with the value that builds nothing: the JAX
# package asserts them off too (autoregressive.py:100)
_UNPORTED_PRIOR_KEYS = dict(pos_init=False, prime_pos_init=False)
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


def load_any(path, kind=None, model=None):
    """A checkpoint file: a `.jkb` as its numpy tree, or upstream's
    `.pth.tar` converted into `model` in place (kind "vqvae" / "prior";
    "opt" reads its step alone) as utils/torch_convert.py does, returning
    its step and hps with params None."""
    if path.endswith(".pth.tar"):
        return convert_checkpoint(path, kind, model)
    return load_checkpoint(path)


def restore_model(model, checkpoint_path):
    """Copy a checkpoint's params (and, for a VQ-VAE, the codebook state
    its state holds: every key of each level, or k alone, as an upstream
    file's k restores it) into `model`. Returns the checkpoint's step, 0
    when nothing is restorable (the model keeps its fresh init)."""
    path = resolve_restore(checkpoint_path)
    if path is None:
        return 0
    vq = isinstance(model, VQVAE)
    ckpt = load_any(path, "vqvae" if vq else "prior", model)
    params = ckpt["params"]
    if params is not None:
        if vq and ckpt.get("state") is not None:
            params = vqvae_tree(params, ckpt["state"])
        from_jax_params(model, params)
    print(f"Restored from {path}")
    return int(np.asarray(ckpt.get("step", 0)))


def restore_opt(opt_state, checkpoint_path, model):
    """(opt_state, step): the checkpoint's optimizer state for `model`'s
    parameters on their device, or opt_state unchanged when there is no
    checkpoint (step 0) or it holds none (an upstream `.pth.tar`: its
    step, with the fresh state, as jukebox_tpu's restore_opt)."""
    path = resolve_restore(checkpoint_path)
    if path is None:
        return opt_state, 0
    ckpt = load_any(path, "opt")
    opt = ckpt.get("opt")
    step = int(np.asarray(ckpt.get("step", 0)))
    if opt is None:
        return opt_state, step
    device = next(model.parameters()).device
    return opt_state_from_jax(model, opt, device), step


def _full_opt(placement, opt_state):
    """The whole optimizer state from every rank's pieces: fp16 moments
    unscaled by each rank's own scale, gathered and scaled again by the
    whole tensor's (ops/adam.py's s = 1e-8 + max|x| / 65504)."""
    out = {"step": opt_state["step"]}
    fp16 = "m_scale" in opt_state
    for key in ("m", "v"):
        if not fp16:
            out[key] = placement.full_dict(opt_state[key])
            continue
        out[key], out[key + "_scale"] = {}, {}
        for n, t in opt_state[key].items():
            x = placement.full(n, t.float() * opt_state[key + "_scale"][n])
            sc = 1e-8 + torch.amax(torch.abs(x)) / 65504.0
            out[key][n] = (x / sc).to(torch.float16)
            out[key + "_scale"][n] = sc
    return out


def save_model_checkpoint(logdir, name, runtime, opt_state, step, hps,
                          params=None):
    """{logdir}/checkpoint_{name}.jkb with hps, params (the model's, or
    `params` as {name: tensor or array}, e.g. an EMA shadow), a VQ-VAE's
    codebook state (None for a prior), the JAX layout of opt_state (None:
    no optimizer state, a sampling checkpoint) and step. Returns the
    path. A model placed over several ranks (runtime.placement) is
    gathered whole first, every rank taking part, and rank 0 writes the
    file a single process would."""
    save_hps = {k: v for k, v in dict(hps).items() if k not in _UNSAVED_HPS}
    placement = getattr(runtime, "placement", None)
    if placement is not None:
        device = next(runtime.model.parameters()).device
        params = placement.full_dict(
            placement.params if params is None else
            {n: torch.as_tensor(v, device=device) for n, v in params.items()})
        opt_state = (None if opt_state is None
                     else _full_opt(placement, opt_state))
    path = f"{logdir}/checkpoint_{name}.jkb"
    if placement is not None and get_rank() != 0:
        return path
    tree = (to_jax_params(runtime.model) if params is None
            else named_to_tree(runtime.model, params))
    opt = (None if opt_state is None
           else opt_state_to_jax(runtime.model, opt_state))
    state = (vqvae_state(runtime.model) if isinstance(runtime.model, VQVAE)
             else None)
    payload = dict(hps=save_hps, params=tree, state=state, opt=opt, step=step)
    save_checkpoint(path, payload)
    return path


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def make_vqvae(hps, device="cuda"):
    """The VQ-VAE of hps on `device`, drawn from hps.seed and restored from
    hps.restore_vqvae. Frozen, with a random codebook unless restored; with
    hps.train and not hps.prior trainable, its codebooks unseeded (JAX's
    init_state) before the restore, and after it, when hps.restore_vqvae is
    set, reset for fine-tuning as jukebox_tpu's make_vqvae does
    (make_models.py:777-790): restore_state(k, num_tokens = the tokens of a
    step at that level, threshold = hps.revival_threshold), on one process.
    The restored step is the model's `step`."""
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
                  hps.hvqvae_multipliers, block, device=device, mu=hps.l_mu,
                  commit=hps.commit, spectral=hps.spectral,
                  multispectral=hps.multispectral,
                  use_bottleneck=hps.use_bottleneck)
    init_weights(model, hps.get("seed", 0), device).eval()
    train = hps.get("train", False) and not hps.get("prior", False)
    if train:
        model.bottleneck.reset_state()
    model.step = restore_model(model, hps.restore_vqvae)
    if train:
        model.requires_grad_(True)
        if hps.restore_vqvae:
            downsamples = calculate_strides(hps.strides_t, hps.downs_t)
            for level, blk in enumerate(model.bottleneck.level_blocks):
                num_tokens = hps.sample_length // int(
                    np.prod(downsamples[:level + 1]))
                blk.restore_state(blk.k.clone(), num_tokens=num_tokens,
                                  threshold=hps.revival_threshold)
    return model


def make_prior(hps, vqvae, device="cuda"):
    train = hps.get("train", False)
    dropped = {k: hps.get(k, v) for k, v in _UNPORTED_PRIOR_KEYS.items()
               if hps.get(k, v) != v}
    if dropped:
        raise NotImplementedError(f"prior options {dropped} are not ported")
    prior_kwargs = dict(
        input_shape=(hps.n_ctx,), bins=vqvae.l_bins, width=hps.prior_width,
        depth=hps.prior_depth, heads=hps.heads, attn_order=hps.attn_order,
        blocks=hps.blocks, spread=hps.spread, zero_out=hps.zero_out,
        res_scale=hps.res_scale,
        init_scale=hps.init_scale, m_attn=hps.m_attn, m_mlp=hps.m_mlp,
        attn_dropout=hps.attn_dropout if train else 0.0,
        resid_dropout=hps.resid_dropout if train else 0.0,
        emb_dropout=hps.emb_dropout if train else 0.0,
        checkpoint_res=hps.c_res if train else 0,
        checkpoint_attn=hps.c_attn if train else 0,
        checkpoint_mlp=hps.c_mlp if train else 0)
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
    if hps.use_tokens and not hps.single_enc_dec:
        # the lyric encoder (jukebox_tpu make_models.py:824-840)
        prime_kwargs.update(
            width=hps.prime_width, depth=hps.prime_depth,
            heads=hps.prime_heads, attn_order=hps.prime_attn_order,
            blocks=hps.prime_blocks, spread=hps.prime_spread,
            zero_out=hps.prime_zero_out,
            res_scale=hps.prime_res_scale, init_scale=hps.prime_init_scale,
            m_attn=hps.prime_m_attn, m_mlp=hps.prime_m_mlp,
            attn_dropout=hps.prime_attn_dropout if train else 0.0,
            resid_dropout=hps.prime_resid_dropout if train else 0.0,
            emb_dropout=hps.prime_emb_dropout if train else 0.0,
            checkpoint_res=hps.prime_c_res if train else 0,
            checkpoint_attn=hps.prime_c_attn if train else 0,
            checkpoint_mlp=hps.prime_c_mlp if train else 0)
    # z_shapes of every level when this level gets n_ctx codes
    z_shapes = [(z[0] * hps.n_ctx // vqvae.z_shapes[hps.level][0],)
                for z in vqvae.z_shapes]
    model = SimplePrior(z_shapes, vqvae.l_bins, hps.level, vqvae.downs_t,
                        vqvae.strides_t, prior_kwargs, x_cond_kwargs,
                        y_cond_kwargs, prime_kwargs, labels=hps.labels,
                        labels_v3=hps.labels_v3,
                        single_enc_dec=hps.single_enc_dec,
                        merged_decoder=hps.merged_decoder,
                        copy_input=hps.copy_input, device=device)
    model.alignment_head = hps.get("alignment_head", None)
    model.alignment_layer = hps.get("alignment_layer", None)
    init_weights(model, hps.get("seed", 0) + hps.level + 1, device)
    model.requires_grad_(bool(train))
    runtime = PriorRuntime(model.eval(), vqvae)
    runtime.step = restore_model(model, hps.restore_prior)
    if hps.get("fp16_params", False) and not train:
        convert_params_bf16(model)
    return runtime


LN_KEYS = ("ln", "ln_0", "ln_1", "prime_state_ln")


@torch.no_grad()
def convert_params_bf16(model):
    """Cast every fp32 parameter of `model` to bf16 in place, except the
    LayerNorms' (any name part in LN_KEYS), as jukebox_tpu's
    convert_params_bf16 casts a sampling prior's params after its restore
    (make_models.py:868-893). The decode staging then reads the bf16
    weights. Returns the model."""
    for name, p in model.named_parameters():
        if p.dtype == torch.float32 and not set(name.split(".")) & set(
                LN_KEYS):
            p.data = p.data.to(torch.bfloat16)
    return model


def decode_mode(quantize=None):
    """(quantize, cache_int8) of a decode staging, with jukebox_tpu's
    switches (make_models.py:447-489, transformer.py:536-546): quantize
    defaults to "int8" when JUKEBOX_INT8_DECODE is set; the ring caches are
    int8 when the weights are, unless JUKEBOX_INT8_CACHE=1/0 says
    otherwise."""
    if quantize is None and os.environ.get("JUKEBOX_INT8_DECODE"):
        quantize = "int8"
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown decode quantization {quantize!r}")
    env = os.environ.get("JUKEBOX_INT8_CACHE")
    cache_int8 = quantize == "int8" if env is None else env != "0"
    return quantize, cache_int8


class VQVAERuntime:
    """A VQ-VAE being trained, with the training loop's interface: model,
    params (the trainable parameters by name; the codebooks are buffers and
    stay out of them), step (the optimizer steps taken) and placement (a
    parallel/placement.py Placement over several ranks, or None)."""

    def __init__(self, model):
        self.model, self.step = model, getattr(model, "step", 0)
        self.placement = None

    @property
    def params(self):
        if self.placement is not None:
            return self.placement.params
        return dict(self.model.named_parameters())


class PriorRuntime:
    """A prior with its sampling and training entry points. stage_decode
    stages the decode form (the weights the decode kernels stream: bf16,
    or int8 with stage_decode(quantize="int8") or JUKEBOX_INT8_DECODE=1);
    sample runs one window: sample_init (conditioning, the lyric encoder,
    caches, prefill), the token loop, and sample_finish. params are the
    trainable fp32 masters by name (the rank's pieces under a placement,
    parallel/placement.py); step counts the optimizer steps taken."""

    def __init__(self, model, vqvae):
        self.model, self.vqvae = model, vqvae
        self.staged = None
        self.staged_mode = None
        self.step = 0
        self.placement = None

    @property
    def params(self):
        if self.placement is not None:
            return self.placement.params
        return dict(self.model.named_parameters())

    def __getattr__(self, name):
        # n_ctx, raw_to_tokens, labeller, n_tokens, level, z_shapes, ...
        return getattr(self.__dict__["model"], name)

    def stage_decode(self, quantize=None, mesh=None):
        """Stage the decode weights once per mode (decode_mode): a change
        of mode, or of the environment switches, restages. mesh: a
        parallel/dist.py Mesh with mp > 1 splits the prior over "mp" first
        (parallel/placement.py tensor_parallel, in place, unless a
        placement split it already): each rank stages its columns, rows and
        heads, its KV caches hold its heads (cache bytes / mp), and every
        row-split product is all-reduced, in bf16 and int8 alike
        (jukebox_tpu make_models.py:447-566). Returns the mode."""
        if mesh is not None and mesh.mp > 1 and \
                self.model.prior.transformer.tp is None:
            from jukebox_tpu_torch.parallel.placement import tensor_parallel
            tensor_parallel(self.model, mesh)
            self.staged = None
        mode = decode_mode(quantize)
        if self.staged is None or self.staged_mode != mode:
            self.staged = None
            self.staged = self.model.prior.transformer.prepare_decode_params(
                torch.bfloat16, quantize=mode[0])
            self.staged_mode = mode
        return mode

    def release(self):
        self.staged = None
        self.staged_mode = None

    def encode(self, x, start_level=None, end_level=None, bs_chunks=1):
        start_level = self.model.level if start_level is None else start_level
        end_level = self.model.levels if end_level is None else end_level
        return self.vqvae.encode(x, start_level, end_level, bs_chunks)

    def decode(self, zs, start_level=None, end_level=None, bs_chunks=1):
        start_level = self.model.level if start_level is None else start_level
        end_level = self.model.levels if end_level is None else end_level
        return self.vqvae.decode(zs, start_level, end_level, bs_chunks)

    @torch.no_grad()
    def z_forward(self, z, z_conds=(), y=None, fp16=False,
                  get_attn_weights=frozenset(), attn_head=None,
                  get_preds=False):
        """The prior's z_forward on codes z, conditioning z_conds and labels
        y (numpy arrays or tensors) moved to its device. With
        get_attn_weights the recorded weights of those layers, each cut to
        head attn_head and cast to fp16 as jukebox_tpu's runtime does
        (make_models.py:705-728), or whole [N, H, Lq, Lkv] fp32 maps
        without a head; else (loss, metrics), with the logits as
        metrics["preds"] under get_preds."""
        device = next(self.model.parameters()).device

        def dev(a):
            return None if a is None else torch.as_tensor(a, device=device)
        z_conds = [dev(c) for c in z_conds] if z_conds else None
        out = self.model.z_forward(dev(z), z_conds, dev(y), fp16=fp16,
                                   get_attn_weights=get_attn_weights,
                                   get_preds=get_preds)
        if not get_attn_weights or attn_head is None:
            return out
        return [w[:, attn_head].to(torch.float16) for w in out]

    @torch.no_grad()
    def forward(self, x, y=None, fp16=False, decode=False, get_preds=False):
        """Audio x [N, T, 1] encoded to this level and the levels above,
        then z_forward on its codes (jukebox_tpu make_models.py:732):
        (x_out, loss, metrics), x_out the codes decoded back under decode
        (else None)."""
        device = next(self.model.parameters()).device
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        z, *z_conds = self.encode(x, bs_chunks=x.shape[0])
        loss, metrics = self.z_forward(z, z_conds=z_conds, y=y, fp16=fp16,
                                       get_preds=get_preds)
        x_out = self.decode([z, *z_conds]) if decode else None
        return x_out, loss, metrics

    @torch.no_grad()
    def sample(self, n_samples, z=None, z_conds=None, y=None, gen=None,
               fp16=False, temp=1.0, top_k=0, top_p=0.0, chunk_size=None,
               sample_tokens=None):
        model = self.model
        dec, cache_int8 = None, False
        if fp16:
            # the mode staged before (stage_decode(quantize="int8")), else
            # the environment's
            mode = self.staged_mode if self.staged is not None else None
            _, cache_int8 = mode or self.stage_decode()
            dec = self.staged
        if z is not None and z.shape[1] == 0:
            z = None
        # the lyric encoder, once per window
        encoder_kv = (model.encoder_kv_from_y(y, fp16)
                      if y is not None and model.prime_prior is not None
                      else None)
        caches, x_tok, x_cond, y_cond = model.sample_init(
            n_samples, z=z, z_conds=z_conds, y=y, fp16=fp16,
            chunk_size=chunk_size, dec_params=dec, encoder_kv=encoder_kv,
            int8=cache_int8)
        t = model.sample_prefix_len(z)
        total = sample_tokens if sample_tokens is not None else model.n_ctx
        if model.single_enc_dec:
            total += model.n_tokens
        toks, _ = model.sample_segment(
            caches, x_tok, t, total - t, gen, x_cond, y_cond, fp16=fp16,
            temp=temp, top_k=top_k, top_p=top_p, dec_params=dec)
        return model.sample_finish(toks, z=z)


def make_model(model, hps, device="cuda", prior_overrides=None,
               levels=None):
    """The VQ-VAE and the priors of a registered model, drawn from
    hps.seed. prior_overrides: optional per-level dicts merged into each
    prior's hparams (e.g. a cut prior_depth). levels: the levels whose
    priors to build (default all; [-1] the top alone)."""
    vqvae_name, *prior_names = MODELS[model]
    vqvae = make_vqvae(setup_hparams(vqvae_name, dict(
        sample_length=hps.get("sample_length", 0),
        sample_length_in_seconds=hps.get("sample_length_in_seconds", 0),
        seed=hps.get("seed", 0))), device)
    hps.sample_length = vqvae.sample_length
    overrides = prior_overrides or [{}] * len(prior_names)
    if levels is None:
        levels = range(len(prior_names))
    priors = [make_prior(setup_hparams(prior_names[level], dict(
        seed=hps.get("seed", 0), **overrides[level])), vqvae, device)
              for level in levels]
    return vqvae, priors


# ---------------------------------------------------------------------------
# the golden dump (jukebox_tpu make_models.py:896-939)
# ---------------------------------------------------------------------------

def save_outputs(model, device, hps, path="data.jkb"):
    """Golden outputs of a registered model for checking another
    implementation against this one: seeded random audio encoded at every
    level and decoded from each level (zs, x_ds), and each prior's
    teacher-forced forward on it with fixed labels (x, y, x_out: its codes
    decoded, preds: its logits), pickled into `path`. With labels_v3 only
    the top prior is run. hps.labels_v3 defaults to the top prior's preset,
    and without hps.sample_length or sample_length_in_seconds the models
    take the dump's audio length (jukebox_tpu's run needs both given)."""
    if "labels_v3" not in hps:
        hps.labels_v3 = setup_hparams(MODELS[model][-1], {}).labels_v3
    n_ctx, n_tokens, prime_bins = ((6144, 384, 79) if hps.labels_v3
                                   else (8192, 512, 80))
    rng = np.random.RandomState(0)
    x = (2 * rng.rand(1, n_ctx * 8 * 4 * 4, 1) - 1.0).astype(np.float32)
    lyric_tokens = rng.randint(0, prime_bins, (n_tokens,))
    artist_id, genre_ids = 10, [1]
    total_length, offset = 2 * 2646000, 2646000
    if not hps.get("sample_length") and not hps.get(
            "sample_length_in_seconds"):
        hps.sample_length = x.shape[1]
    vqvae, priors = make_model(model, hps, device)
    dev = next(vqvae.parameters()).device
    vq_prior = priors[-1]
    with torch.no_grad():
        zs = vq_prior.encode(torch.as_tensor(x, device=dev), start_level=0)
        x_ds = [vq_prior.decode(zs[level:], start_level=level)
                for level in range(len(zs))]
    data = dict(zs=[z.cpu().numpy() for z in zs],
                x_ds=[d.float().cpu().numpy() for d in x_ds])
    for level, prior in enumerate(priors):
        if hps.labels_v3 and level != len(priors) - 1:
            continue
        print(f"Doing level {level}")
        x_in = x[:, : n_ctx * 8 * (4 ** level)]
        y_in = prior.labeller.get_y_from_ids(artist_id, genre_ids,
                                             lyric_tokens, total_length,
                                             offset)[None]
        x_out, _, metrics = prior.forward(x_in, y=y_in,
                                          fp16=hps.get("fp16", False),
                                          get_preds=True, decode=True)
        data[level] = dict(x=x_in, y=y_in,
                           x_out=x_out.float().cpu().numpy(),
                           preds=metrics["preds"].float().cpu().numpy())
    with open(path, "wb") as f:
        pickle.dump(data, f)
    print("Saved data")
    return data


def run(model, port=29500, device="cuda", **kwargs):
    """CLI: the golden dump of a registered model into ./data.jkb,

        python -m jukebox_tpu_torch.models.make_models 1b_lyrics [--seed=0]
            [--labels_v3=True] [--fp16=True] [--device=cpu]

    from random weights drawn from --seed unless the presets' checkpoints
    are cached under ~/.cache/jukebox/models."""
    save_outputs(model, device, Hyperparams(**kwargs))


if __name__ == "__main__":
    from jukebox_tpu_torch.utils.cli import fire
    fire(run)
