"""Parameter bridge between JAX param trees and the port's modules.

A JAX param tree (nested dicts / lists of numpy arrays, feature-last:
dense (in, out), conv (k, in, out)) maps onto a module by path: the port
names its parameters after the tree's keys, so "transformer/blocks/3/attn/
c_attn/w" is the parameter transformer.blocks.3.attn.c_attn.w. Dense,
LayerNorm and table leaves keep their layout; conv weights move to
PyTorch's (out, in, k) for Conv1d and (in, out, k) for ConvTranspose1d.
Every leaf is consumed exactly once: a tree leaf without a parameter, or a
parameter without a leaf, raises.

Trees shaped like the params carry over the same way: the Adam state of
jukebox_tpu.utils.train_utils.adam_init ("m", "v" and, in the fp16 form,
the per-tensor "m_scale" / "v_scale") and an EMA shadow, so that a JAX train
state and the port's can start from one state and be compared.
"""

import numpy as np
import torch

from jukebox_tpu_torch.ops.core import Conv1d, ConvTranspose1d

# JAX conv (k, in, out) -> torch layout, and back
_TO_TORCH = {Conv1d: (2, 1, 0), ConvTranspose1d: (1, 2, 0)}
_TO_JAX = {Conv1d: (2, 1, 0), ConvTranspose1d: (2, 0, 1)}


def flatten_tree(tree, prefix=""):
    """{dotted path: array} of a nested dict / list tree; None leaves
    (absent sub-modules) are skipped."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None:
            out[prefix[:-1]] = tree
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def _owner(module, name):
    return module.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else module


def _perm(owner, name, table, ndim):
    if name.rsplit(".", 1)[-1] == "w" and type(owner) in table and ndim == 3:
        return table[type(owner)]
    return None


def named_leaves(module, tree):
    """{parameter name: numpy array in the port's layout} of a tree shaped
    like `module`'s parameters (params, Adam moments, per-tensor scales, an
    EMA shadow). Leaves keep their dtype; a missing or leftover leaf raises
    KeyError, a shape that does not fit ValueError."""
    leaves = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"param tree does not match {type(module).__name__}: "
                       f"missing {missing[:8]}, leftover {extra[:8]}")
    out = {}
    for name, p in params.items():
        a = np.array(leaves[name])  # writable copy
        perm = _perm(_owner(module, name), name, _TO_TORCH, a.ndim)
        if perm is not None:
            a = np.ascontiguousarray(a.transpose(perm))
        if a.ndim and tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {a.shape} vs {tuple(p.shape)}")
        out[name] = a
    return out


def named_to_tree(module, named):
    """Inverse of named_leaves: {parameter name: array or tensor} -> a
    JAX-layout tree of numpy arrays (lists where the path has integer
    keys)."""
    root = {}
    for name in dict(module.named_parameters()):
        a = named[name]
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        perm = _perm(_owner(module, name), name, _TO_JAX, a.ndim)
        if perm is not None:
            a = np.ascontiguousarray(a.transpose(perm))
        node = root
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return _lists(root)


@torch.no_grad()
def from_jax_params(module, tree):
    """Copy a JAX param tree into `module`'s parameters (on their device and
    dtype). Returns the module."""
    params = dict(module.named_parameters())
    for name, a in named_leaves(module, tree).items():
        params[name].copy_(torch.from_numpy(a.astype(np.float32)))
    return module


def to_jax_params(module):
    """The module's parameters as a JAX-layout param tree of numpy arrays."""
    return named_to_tree(module, {n: p.float() for n, p in
                                  module.named_parameters()})


_OPT_TREES = ("m", "v", "m_scale", "v_scale")


def opt_state_from_jax(module, opt_state, device=None):
    """jukebox_tpu's Adam state -> the port's (utils/train_utils.py): each
    of m, v (and m_scale, v_scale) as {name: tensor} in its dtype on
    `device`, and step as an int."""
    out = {"step": int(np.asarray(opt_state["step"]))}
    for key in _OPT_TREES:
        if key in opt_state:
            out[key] = {n: torch.from_numpy(a).to(device) for n, a in
                        named_leaves(module, opt_state[key]).items()}
    if set(opt_state) - set(out):
        raise KeyError(f"unknown optimizer state {sorted(set(opt_state) - set(out))}")
    return out


def opt_state_to_jax(module, opt_state):
    """The port's Adam state as jukebox_tpu's: trees of numpy arrays."""
    out = {"step": np.asarray(opt_state["step"], np.int32)}
    for key in _OPT_TREES:
        if key in opt_state:
            out[key] = named_to_tree(module, opt_state[key])
    return out


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def vqvae_tree(params, state):
    """The JAX VQ-VAE as one tree for the port's VQVAE: the encoders' and
    decoders' params and each level's codebook from the bottleneck state."""
    return {"encoders": params["encoders"], "decoders": params["decoders"],
            "bottleneck": {"level_blocks": [{"k": s["k"]}
                                            for s in state["level_blocks"]]}}
