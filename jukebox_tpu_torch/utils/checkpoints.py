"""Checkpoint files of the PyTorch port (counterpart of
jukebox_tpu/utils/checkpoints.py): the JAX package's `.jkb` format, so a
file written by either package restores in the other.

A `.jkb` file is one pickle (highest protocol) of a dict of numpy trees:
nested dicts, lists and tuples whose leaves are numpy arrays, numpy
scalars, None and Python builtins. A checkpoint holds `hps`, `params`,
`state`, `opt` and `step` in the JAX tree layout (utils/convert.py maps the
port's modules onto it).

Reading goes through a restricted unpickler that resolves only numpy's
array, scalar and dtype reconstructors and a few builtin types, and raises
UnpicklingError on any other global: a checkpoint can neither import a
module (jax, jukebox_tpu or anything else) nor run code while it loads.
"""

import os
import pickle

import numpy as np
import torch

_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "_frombuffer", "scalar", "ndarray", "dtype")
_BUILTINS = ("set", "frozenset", "complex", "bytearray", "slice", "range")


class CheckpointUnpickler(pickle.Unpickler):
    """Admits numpy arrays, scalars and dtypes and the builtin containers;
    any other global raises pickle.UnpicklingError."""

    def find_class(self, module, name):
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or \
                (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        if module == "numpy.dtypes" and name.endswith("DType"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}: a .jkb file holds numpy "
            f"trees only")


def to_numpy(tree):
    """The tree with every tensor and array leaf as a numpy array (the JAX
    package's tree_map(np.asarray)): dicts, lists and tuples are kept,
    None stays None."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path, payload):
    """Write payload (a dict of trees) to `path` as numpy, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_numpy(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as f:
        return CheckpointUnpickler(f).load()
