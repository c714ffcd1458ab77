"""utils/convert.py: a JAX param tree maps onto the port's modules leaf for
leaf, every leaf consumed once; a missing or leftover leaf raises; the
reverse direction gives back the same tree."""

import jax
import numpy as np
import pytest
import torch

from jukebox_tpu.models.conditioners import Conditioner as JConditioner
from jukebox_tpu.models.encdec import BlockCfg as JBlockCfg
from jukebox_tpu.models.transformer import Transformer as JTransformer
from jukebox_tpu_torch.models.conditioners import Conditioner
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             to_jax_params)

torch.set_num_threads(1)


def _pair(kind):
    if kind == "transformer":
        j = JTransformer(n_in=16, n_ctx=24, n_head=2, n_depth=3, attn_order=2,
                         blocks=4, mask=True)
        tm = Transformer(16, 24, 2, 3, attn_order=2, blocks=4, mask=True,
                         device="cpu")
    else:  # conv-transpose stack + embedding + LayerNorm
        blk = dict(width=8, depth=2, dilation_growth_rate=3,
                   dilation_cycle=2)
        j = JConditioner(input_shape=(6,), bins=10, down_t=2, stride_t=2,
                         out_width=12, init_scale=1.0, block=JBlockCfg(**blk))
        tm = Conditioner((6,), 10, 2, 2, 12, 1.0, BlockCfg(**blk),
                         device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, j.init(jax.random.key(0)))
    return tree, tm


@pytest.mark.parametrize("kind", ["transformer", "conditioner"])
def test_round_trip(kind):
    tree, tm = _pair(kind)
    from_jax_params(tm, tree)
    leaves = flatten_tree(tree)
    assert len(leaves) == len(list(tm.parameters()))
    back = flatten_tree(to_jax_params(tm))
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["transformer", "conditioner"])
def test_missing_leaf_raises(kind):
    tree, tm = _pair(kind)
    leaves = flatten_tree(tree)
    victim = sorted(leaves)[3]
    node = tree
    *path, leaf = victim.split(".")
    for k in path:
        node = node[int(k)] if isinstance(node, list) else node[k]
    del node[leaf]
    with pytest.raises(KeyError, match="missing"):
        from_jax_params(tm, tree)


def test_leftover_leaf_raises():
    tree, tm = _pair("transformer")
    tree["blocks"][0]["attn"]["c_enc_kv"] = {"w": np.zeros((16, 8)),
                                            "b": np.zeros(8)}
    with pytest.raises(KeyError, match="leftover"):
        from_jax_params(tm, tree)


def test_shape_mismatch_raises():
    tree, tm = _pair("transformer")
    tree["blocks"][1]["mlp"]["c_fc"]["w"] = np.zeros((16, 17), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tm, tree)


@pytest.mark.parametrize("fp16_state", [False, True])
def test_opt_state_round_trip(fp16_state):
    """jukebox_tpu's Adam state (moments in the params' layout, conv
    weights included, and per-tensor scales in the fp16 form) crosses into
    the port's {name: tensor} state and back unchanged."""
    from jukebox_tpu.utils.train_utils import adam_init, adam_update
    from jukebox_tpu_torch.utils.convert import (opt_state_from_jax,
                                                 opt_state_to_jax)
    tree, tm = _pair("conditioner")
    params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    opt = adam_init(params, fp16_state=fp16_state)
    _, opt = adam_update(params, params, opt, 1e-3, 0.9, 0.99, 1e-8, 0.0)
    opt = jax.tree_util.tree_map(np.asarray, opt)
    port = opt_state_from_jax(tm, opt)
    assert port["step"] == 1
    for name, p in tm.named_parameters():
        assert port["m"][name].shape == p.shape
        assert port["m"][name].dtype == (torch.float16 if fp16_state
                                         else torch.float32)
    back = flatten_tree(opt_state_to_jax(tm, port))
    ref = flatten_tree(opt)
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    opt["m"]["ln"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError, match="leftover"):
        opt_state_from_jax(tm, opt)


def test_ema_shadow_crosses_over():
    """A jukebox_tpu CPUEMA shadow (a JAX-layout tree of fp32 arrays) maps
    onto the port's {name: array} shadow and back unchanged."""
    from jukebox_tpu.utils.train_utils import CPUEMA
    from jukebox_tpu_torch.utils.convert import named_leaves, named_to_tree
    tree, tm = _pair("conditioner")
    shadow = CPUEMA(tree, mu=0.9, freq=1).shadow
    port = named_leaves(tm, shadow)
    for name, p in tm.named_parameters():
        assert port[name].shape == tuple(p.shape)
    back = flatten_tree(named_to_tree(tm, port))
    for k, v in flatten_tree(shadow).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
