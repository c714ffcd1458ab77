"""Upstream `.pth.tar` checkpoints into the port's modules (counterpart of
jukebox_tpu/utils/torch_convert.py).

Upstream's released files hold `{"hps", "model", "opt", "step"}`: `model`
a state dict of its torch modules, `hps` an object of its
`jukebox.hparams.Hyperparams` class. They load here without upstream's
package and without running pickled code: torch.load(weights_only=True)
admits tensors, containers and primitives, and a stand-in takes the place
of that one class (its items become a plain dict). Any other global raises
pickle.UnpicklingError naming it.

The state dict maps onto the port's parameters module by module, as the
JAX converter maps it onto its trees (the port names its parameters after
those trees' paths, utils/convert.py):

  torch Conv1d      weight (out, in, k)  -> Conv1d.w (out, in, k)           [as-is]
  torch ConvTransp. weight (in, out, k)  -> ConvTranspose1d.w (in, out, k)  [as-is]
  upstream Conv1D   w (n_in, n_out)      -> Dense.w                         [as-is]
  torch Linear      weight (out, in)     -> Table "w" (in, out)             [transpose]
  torch LayerNorm   weight / bias        -> g / b
  Embedding         weight               -> Table weight

Each tensor is cast to fp32 (upstream's fp16_params files mix fp16 conv
weights with fp32) and copied into its parameter, and the file's tensor is
dropped as it is consumed, so the file's tensors and the model's never
double on the host; a zipfile checkpoint is memory-mapped, not read whole.
A VQ-VAE's codebooks take `k` and restore their EMA state from it
(BottleneckBlock.restore_state). Keys the model does not use are ignored,
as the JAX converter ignores them; a key it needs that the file lacks
raises KeyError naming it.
"""

import pickle
import zipfile

import torch

UPSTREAM_HPARAMS = "jukebox.hparams.Hyperparams"


class UpstreamHyperparams(dict):
    """Stand-in for upstream's `jukebox.hparams.Hyperparams` while a file
    loads: its pickle rebuilds it with `__new__` and fills it item by item,
    and the stand-in hands back a plain dict for that."""

    def __new__(cls, *args, **kwargs):
        return dict()


def load_state(path):
    """The checkpoint at `path` as loaded by torch.load(weights_only=True)
    with the stand-in for upstream's Hyperparams, on the CPU (memory-mapped
    when the file is a zipfile checkpoint)."""
    try:
        with torch.serialization.safe_globals(
                [(UpstreamHyperparams, UPSTREAM_HPARAMS)]):
            return torch.load(path, map_location="cpu", weights_only=True,
                              mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError as e:
        raise pickle.UnpicklingError(
            f"{path}: an upstream checkpoint holds tensors, containers and "
            f"{UPSTREAM_HPARAMS} only; {e}") from None


# -- the spec: {port parameter name: (upstream key, transpose)} ---------------

def _conv(spec, name, key):
    spec[f"{name}.w"] = (f"{key}.weight", False)
    spec[f"{name}.b"] = (f"{key}.bias", False)


def _dense(spec, name, key):
    spec[f"{name}.w"] = (f"{key}.w", False)
    spec[f"{name}.b"] = (f"{key}.b", False)


def _linear(spec, name, key):
    spec[f"{name}.w"] = (f"{key}.weight", True)


def _ln(spec, name, key):
    spec[f"{name}.g"] = (f"{key}.weight", False)
    spec[f"{name}.b"] = (f"{key}.bias", False)


def _emb(spec, name, key):
    spec[f"{name}.weight"] = (f"{key}.weight", False)


def _resnet(spec, sd, name, key, resnet):
    """Resnet1D: `{key}.model.{j}` (or `{key}.blocks.{j}` when trained with
    per-block checkpointing); each block is Sequential(ReLU, Conv1d(3),
    ReLU, Conv1d(1))."""
    prefix = (f"{key}.model" if f"{key}.model.0.model.1.weight" in sd
              else f"{key}.blocks")
    for j in range(len(resnet.blocks)):
        _conv(spec, f"{name}.blocks.{j}.conv_dil", f"{prefix}.{j}.model.1")
        _conv(spec, f"{name}.blocks.{j}.conv_1x1", f"{prefix}.{j}.model.3")


def _encoder_conv_block(spec, sd, name, key, block):
    """EncoderConvBlock: model.{i} = Sequential(Conv1d, Resnet1D) for
    i < down_t, then model.{down_t} = Conv1d."""
    for i, down in enumerate(block.downs):
        _conv(spec, f"{name}.downs.{i}.conv_down", f"{key}.model.{i}.0")
        _resnet(spec, sd, f"{name}.downs.{i}.resnet", f"{key}.model.{i}.1",
                down["resnet"])
    if block.proj is not None:
        _conv(spec, f"{name}.proj", f"{key}.model.{len(block.downs)}")


def _decoder_conv_block(spec, sd, name, key, block):
    """DecoderConvBock: model.0 = Conv1d, model.{1 + i} =
    Sequential(Resnet1D, ConvTranspose1d)."""
    if not len(block.ups):
        return
    _conv(spec, f"{name}.proj", f"{key}.model.0")
    for i, up in enumerate(block.ups):
        _resnet(spec, sd, f"{name}.ups.{i}.resnet", f"{key}.model.{1 + i}.0",
                up["resnet"])
        _conv(spec, f"{name}.ups.{i}.conv_up", f"{key}.model.{1 + i}.1")


def vqvae_spec(sd, model):
    """The spec of models/vqvae.py VQVAE."""
    spec = {}
    for level in range(model.levels):
        for l, blk in enumerate(model.encoders[level].level_blocks):
            _encoder_conv_block(spec, sd, f"encoders.{level}.level_blocks.{l}",
                                f"encoders.{level}.level_blocks.{l}", blk)
        for l, blk in enumerate(model.decoders[level].level_blocks):
            _decoder_conv_block(spec, sd, f"decoders.{level}.level_blocks.{l}",
                                f"decoders.{level}.level_blocks.{l}", blk)
        _conv(spec, f"decoders.{level}.out", f"decoders.{level}.out")
    return spec


def _transformer(spec, name, key, tr):
    for d in range(tr.n_depth):
        n, k = f"{name}.blocks.{d}", f"{key}._attn_mods.{d}"
        _dense(spec, f"{n}.attn.c_attn", f"{k}.attn.c_attn")
        _dense(spec, f"{n}.attn.c_proj", f"{k}.attn.c_proj")
        if tr.attn_func(d) == 6:
            _dense(spec, f"{n}.attn.c_enc_kv", f"{k}.attn.c_enc_kv")
        _ln(spec, f"{n}.ln_0", f"{k}.ln_0")
        _dense(spec, f"{n}.mlp.c_fc", f"{k}.mlp.c_fc")
        _dense(spec, f"{n}.mlp.c_proj", f"{k}.mlp.c_proj")
        _ln(spec, f"{n}.ln_1", f"{k}.ln_1")


def _autoregressive(spec, name, ar):
    """ConditionalAutoregressive2D under `name` (the same key upstream)."""
    _emb(spec, f"{name}.x_emb", f"{name}.x_emb")
    spec[f"{name}.pos_emb.pos_emb"] = (f"{name}.pos_emb.pos_emb", False)
    _transformer(spec, f"{name}.transformer", f"{name}.transformer",
                 ar.transformer)
    if not ar.y_cond:
        spec[f"{name}.start_token"] = (f"{name}.start_token", False)
    if not ar.only_encode and not ar.share_x_emb_x_out:
        _linear(spec, f"{name}.x_out", f"{name}.x_out")


def prior_spec(sd, model):
    """The spec of models/prior.py SimplePrior."""
    spec = {}
    _autoregressive(spec, "prior", model.prior)
    if model.x_cond:
        cb = "conditioner_blocks.0"
        _emb(spec, f"{cb}.x_emb", f"{cb}.x_emb")
        _decoder_conv_block(spec, sd, f"{cb}.cond", f"{cb}.cond",
                            model.conditioner_blocks[0].cond)
        _ln(spec, f"{cb}.ln", f"{cb}.ln")
    if model.y_cond:
        names = ["bow_genre_emb", "artist_emb"]
        if model.y_emb.include_time_signal:
            names += ["total_length_emb", "absolute_pos_emb",
                      "relative_pos_emb"]
        for n in names:
            _emb(spec, f"y_emb.{n}.emb", f"y_emb.{n}.emb")
    if model.prime_prior is not None:
        _autoregressive(spec, "prime_prior", model.prime_prior)
        _dense(spec, "prime_state_proj", "prime_state_proj")
        _ln(spec, "prime_state_ln", "prime_state_ln")
        _linear(spec, "prime_x_out", "prime_x_out")
    return spec


@torch.no_grad()
def convert_state_dict(sd, model):
    """Copy upstream state dict `sd` (keys without `module.`) into `model`
    (a VQVAE or a SimplePrior), consuming sd: each tensor is popped, cast
    to fp32, copied into its parameter (on its device, in its dtype) and
    dropped. A VQ-VAE's codebooks restore their state from `k`. Returns
    the number of tensors copied."""
    from jukebox_tpu_torch.models.vqvae import VQVAE
    is_vqvae = isinstance(model, VQVAE)
    spec = vqvae_spec(sd, model) if is_vqvae else prior_spec(sd, model)
    params = dict(model.named_parameters())
    if set(spec) != set(params):
        raise KeyError(f"{type(model).__name__}: the converter's parameters "
                       f"differ from the model's: "
                       f"{sorted(set(spec) ^ set(params))[:8]}")
    for name, p in params.items():
        key, transpose = spec[name]
        if key not in sd:
            raise KeyError(f"upstream checkpoint has no {key} (for the "
                           f"port's {name})")
        a = sd.pop(key).to(torch.float32)
        if transpose:
            a = a.t()
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(a.shape)} does not fit "
                             f"the port's {name} {tuple(p.shape)}")
        p.copy_(a)
        del a
    n = len(params)
    if is_vqvae:
        for level, blk in enumerate(model.bottleneck.level_blocks):
            key = f"bottleneck.level_blocks.{level}.k"
            if key not in sd:
                raise KeyError(f"upstream checkpoint has no {key}")
            blk.restore_state(sd.pop(key).to(torch.float32))
            n += 1
    return n


def strip_module(sd):
    """The state dict with a leading `module.` (DistributedDataParallel's
    wrapper) taken off every key, in place."""
    for k in [k for k in sd if k.startswith("module.")]:
        sd[k[len("module."):]] = sd.pop(k)
    return sd


def convert_checkpoint(path, kind, model=None):
    """Load upstream's `.pth.tar` at `path`. kind "vqvae" / "prior":
    convert its state dict into `model` (convert_state_dict); kind "opt":
    only read it. Returns {"step", "hps" (a plain dict), "params": None
    (the weights are in the model), "state": None, "opt": None}: upstream's
    optimizer state does not carry over, the caller keeps a fresh one."""
    ckpt = load_state(path)
    ckpt.pop("opt", None)
    sd = ckpt.pop("model", ckpt)
    out = {"step": int(ckpt.get("step", 0) or 0),
           "hps": dict(ckpt.get("hps") or {}), "params": None,
           "state": None, "opt": None}
    if kind in ("vqvae", "prior"):
        convert_state_dict(strip_module(sd), model)
    elif kind != "opt":
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    return out
