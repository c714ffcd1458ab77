"""Placement rules of the port's parameters over the ("dp", "mp") mesh
(counterpart of jukebox_tpu/parallel/shardings.py): plain functions that
return one spec per parameter name, a tuple with one entry per axis of
the parameter, each None (whole), "dp" or "mp" (split over that mesh
axis).

The port's dense weights are (in, out) as the JAX package's, so the rules
carry over name for name: the transformers' input products c_attn, c_fc
and c_enc_kv split their output columns over "mp", the output products
c_proj their input rows (their bias is added after the all-reduce and stays
whole). fsdp_param_specs adds the ZeRO-3 split over "dp" and picks each
leaf's axis as the JAX package does on its layout; a convolution weight,
(k, in, out) there and (out, in, k) or (in, out, k) here, is judged in the
JAX layout and its spec moved to the port's. What a split means for c_attn
is the port's own (placement.py): q, k and v are each split by heads.

`params` is an nn.Module, or {name: tensor or shape} (then no convolution
is permuted).
"""

import numpy as np
import torch.nn as nn

from jukebox_tpu_torch.utils.convert import _TO_TORCH, _owner, _perm

_COL_SPLIT = ("c_attn", "c_fc", "c_enc_kv")   # w: (in, out) -> (None, mp)
_ROW_SPLIT = ("c_proj",)                      # w: (in, out) -> (mp, None)


def _shapes(params):
    """{name: (port shape, perm)}: perm maps the port's axes to the JAX
    layout's (port axis i is JAX axis perm[i]), None when they agree."""
    if isinstance(params, nn.Module):
        return {n: (tuple(p.shape),
                    _perm(_owner(params, n), n, _TO_TORCH, p.ndim))
                for n, p in params.named_parameters()}
    return {n: (tuple(getattr(s, "shape", s)), None)
            for n, s in params.items()}


def _to_port(jax_spec, perm):
    return tuple(jax_spec) if perm is None else tuple(jax_spec[a]
                                                      for a in perm)


def _to_jax(spec, perm):
    if perm is None:
        return list(spec)
    out = [None] * len(spec)
    for i, a in enumerate(perm):
        out[a] = spec[i]
    return out


def megatron_spec(name, ndim):
    """The "mp" spec of one parameter by its name (prior_param_specs'
    rule)."""
    keys = name.split(".")
    if any(k in _COL_SPLIT for k in keys):
        if keys[-1] == "w":
            return (None, "mp")
        if keys[-1] == "b":
            return ("mp",)
    return (None,) * ndim


def prior_param_specs(params):
    """{name: spec}: transformer products split over "mp" (column-split
    c_attn / c_fc / c_enc_kv, row-split c_proj whose bias stays whole),
    everything else whole."""
    out = {}
    for n, (shape, _) in _shapes(params).items():
        keys = n.split(".")
        if any(k in _ROW_SPLIT for k in keys) and keys[-1] == "w":
            out[n] = ("mp", None)
        else:
            out[n] = megatron_spec(n, len(shape))
    return out


def fsdp_param_specs(params, dp_size, base_specs=None, min_size=1 << 14):
    """ZeRO-3 placement over "dp" on top of base_specs (default: all
    whole): a leaf of at least min_size elements splits its largest axis
    that base_specs leaves whole and dp_size divides (the later axis of
    the JAX layout on a tie); smaller leaves keep their base spec."""
    out = {}
    for n, (shape, perm) in _shapes(params).items():
        base = (base_specs[n] if base_specs is not None
                else (None,) * len(shape))
        dims = _to_jax(tuple(base) + (None,) * (len(shape) - len(base)),
                       perm)
        jshape = _to_jax(shape, perm)
        size = int(np.prod(shape)) if shape else 1
        free = [(d, i) for i, d in enumerate(jshape)
                if dims[i] is None and d % dp_size == 0]
        if size < min_size or not free:
            out[n] = tuple(base)
            continue
        _, ax = max(free)
        dims[ax] = "dp"
        out[n] = _to_port(dims, perm)
    return out


def per_device_fraction(params, specs, dp_size, mp_size=1):
    """Each rank's share of all parameter elements under specs: 1/(dp*mp)
    when everything splits, 1.0 when everything is whole."""
    total = held = 0
    for n, (shape, _) in _shapes(params).items():
        size = int(np.prod(shape)) if shape else 1
        div = 1
        for axis in specs[n]:
            div *= {"dp": dp_size, "mp": mp_size}.get(axis, 1)
        total += size
        held += size // div
    return held / max(total, 1)


# staged decode dicts (Transformer.prepare_decode_params) and the products
# they hold
_DECODE_COL = ("qkv", "fc", "enc_kv")
_DECODE_ROW = ("proj", "mlp")


def decode_param_specs(dec_params):
    """Per layer of a staged decode list, {key: {leaf: spec}} for the
    dense dicts and {key: spec} for the other leaves: column-split qkv / fc
    / enc_kv ("w" or "w_q" over its columns, and "s", "b"), row-split proj
    / mlp ("w" or "w_q" over its rows; their "s" and "b" whole, applied
    after the all-reduce); LayerNorms whole. The KV caches a split qkv
    fills hold the rank's heads."""
    out = []
    for layer in dec_params:
        spec = {}
        for key, val in layer.items():
            if not isinstance(val, dict):
                spec[key] = (None,) * val.ndim
                continue
            leaves = {}
            for leaf, t in val.items():
                if key in _DECODE_COL:
                    leaves[leaf] = ((None, "mp") if leaf in ("w", "w_q")
                                    else ("mp",))
                elif key in _DECODE_ROW and leaf in ("w", "w_q"):
                    leaves[leaf] = ("mp", None)
                else:
                    leaves[leaf] = (None,) * t.ndim
            spec[key] = leaves
        out.append(spec)
    return out
