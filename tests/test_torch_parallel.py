"""The port's placement rules (jukebox_tpu_torch/parallel/shardings.py)
against the JAX package's (jukebox_tpu/parallel/shardings.py), leaf for
leaf, and the refusals of parallel/: on the CPU, in one process.

* prior_param_specs, fsdp_param_specs (dp 2 and 4, alone and on top of the
  Megatron specs, min_size 64 and the default) and per_device_fraction on
  tests/test_parallel.py _build's prior, and on a tiny upsampler whose
  conditioner's convolutions the port holds in another layout (each judged
  in the JAX layout): equal specs, equal fractions.
* decode_param_specs: the rule of each staged product equals the JAX
  rule for the product of the same name (the JAX tree's leading group
  axis dropped).
* A prior of prior_5b_lyrics' widths (width 4800, 72 layers, 8 heads)
  built on the meta device, under fsdp_param_specs at dp=8: each rank holds
  less than 1.05 / 8 of it and params + fp32 moments under 10e9 bytes
  (tests/test_parallel.py test_fsdp_5b_shape_memory_fits_16gb_mesh).
* make_mesh keeps the JAX asserts (mesh_mp=2 in a world of one raises, so
  train.setup refuses it instead of training replicated); a Megatron split
  of a one-head transformer over mp=2 raises; the loader's process slices
  are the JAX loader's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_mp_worker as W
from jukebox_tpu.parallel import shardings as jsh
from jukebox_tpu_torch.data.data_processor import ShardedLoader
from jukebox_tpu_torch.parallel import shardings as tsh
from jukebox_tpu_torch.parallel.dist import Mesh, make_mesh
from jukebox_tpu_torch.parallel.placement import tensor_parallel

torch.set_num_threads(1)


def _flat(specs):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda q: isinstance(q, P))[0]}


def _assert_specs(jspecs, tspecs, module):
    """JAX specs (a P tree, JAX layout) equal the port's (per name, the
    port's layout)."""
    from jukebox_tpu_torch.utils.convert import _TO_TORCH, _owner, _perm
    flat = _flat(jspecs)
    assert flat.keys() == tspecs.keys()
    params = dict(module.named_parameters())
    for n, s in flat.items():
        s = s + (None,) * (params[n].ndim - len(s))
        perm = _perm(_owner(module, n), n, _TO_TORCH, params[n].ndim)
        if perm is not None:
            s = tuple(s[a] for a in perm)
        assert tspecs[n] == s, (n, tspecs[n], s)


@pytest.fixture(scope="module")
def pairs():
    """[(JAX params, port module)]: _build's prior and a tiny upsampler."""
    from test_parallel import _build
    import _torch_tiny as tiny
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    jprior = _build()[0]
    tvq = make_vqvae(setup_hparams("teeny", dict(W.VQ_PAR)), "cpu")
    tprior = make_prior(setup_hparams("teeny", dict(W.PRIOR_PAR)), tvq, "cpu")
    jvq, tvq3 = tiny.vqvaes()
    jps, tps = tiny.priors([dict(tiny.UP, level=0)], jvq, tvq3)
    return [(jprior.params, tprior.model), (jps[0].params, tps[0].model)]


@pytest.mark.parametrize("case", ["prior", "upsampler"])
def test_specs_match_jax(pairs, case):
    jparams, module = pairs[["prior", "upsampler"].index(case)]
    jbase = jsh.prior_param_specs(jparams)
    tbase = tsh.prior_param_specs(module)
    _assert_specs(jbase, tbase, module)
    assert any("mp" in s for s in tbase.values())
    for dp in (2, 4):
        for min_size in (64, 1 << 14):
            for jb, tb in ((None, None), (jbase, tbase)):
                js = jsh.fsdp_param_specs(jparams, dp, base_specs=jb,
                                          min_size=min_size)
                ts = tsh.fsdp_param_specs(module, dp, base_specs=tb,
                                          min_size=min_size)
                _assert_specs(js, ts, module)
                for mp in (1, 2):
                    assert tsh.per_device_fraction(module, ts, dp, mp) == \
                        pytest.approx(jsh.per_device_fraction(
                            jparams, js, dp, mp), rel=1e-12)
    if case == "upsampler":  # a conv weight judged in the JAX layout
        ts = tsh.fsdp_param_specs(module, 2, min_size=64)
        convs = [n for n, p in module.named_parameters() if p.ndim == 3
                 and "dp" in ts[n]]
        assert convs


def test_decode_specs_match_jax():
    """Each staged product's rule equals the JAX rule of the product of
    the same name in a segment tree (leading group axis)."""
    from jukebox_tpu_torch.models.transformer import Transformer
    from jukebox_tpu_torch.ops.core import init_weights
    tr = Transformer(16, 32, 2, 4, attn_order=6, blocks=4, encoder_dims=8,
                     device="cpu")
    init_weights(tr, 0)
    names = dict(qkv="c_attn", proj="c_proj", fc="c_fc", mlp="c_proj",
                 enc_kv="c_enc_kv")
    for quantize in (None, "int8"):
        staged = tr.prepare_decode_params(torch.float32, quantize)
        specs = tsh.decode_param_specs(staged)
        for layer, spec in zip(staged, specs):
            for key, sub in layer.items():
                if not isinstance(sub, dict):
                    assert spec[key] == (None,) * sub.ndim
                    continue
                tree = {names[key]: {leaf: np.zeros((2,) + tuple(t.shape))
                                     for leaf, t in sub.items()}}
                jflat = _flat(jsh.decode_param_specs(tree))
                for leaf, t in sub.items():
                    js = jflat[f"{names[key]}.{leaf}"]
                    js = (js + (None,) * (t.ndim + 1 - len(js)))[1:]
                    assert spec[key][leaf] == js, (key, leaf)


def test_fsdp_5b_shape_on_meta_fits():
    from jukebox_tpu_torch.models.autoregressive import \
        ConditionalAutoregressive2D
    prior = ConditionalAutoregressive2D(
        input_shape=(8192,), bins=2048, width=4800, depth=72, heads=8,
        attn_order=2, blocks=128, y_cond=True, device="meta")
    dp = 8
    specs = tsh.fsdp_param_specs(prior, dp)
    pf = tsh.per_device_fraction(prior, specs, dp)
    assert pf < 1.05 / dp, pf
    total = sum(p.numel() for p in prior.parameters())
    assert total > 4e9
    assert 3 * 4 * total * pf < 10e9


def test_mesh_refuses_a_world_it_does_not_fill():
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.dp_rank, mesh.mp_rank) == (1, 1, 0, 0)
    with pytest.raises(AssertionError):
        make_mesh(-1, 2, device="cpu")
    with pytest.raises(AssertionError):
        make_mesh(2, 1, device="cpu")
    from jukebox_tpu_torch import train
    with pytest.raises(AssertionError):
        train.setup("teeny", device="cpu", mesh_mp=2)


def test_megatron_split_refuses_uneven_heads():
    """Heads that mp does not divide no longer refuse the split: such a
    layer keeps its heads and runs its attention whole (its product
    columns still split); what stays refused is columns mp does not
    divide."""
    from jukebox_tpu_torch.models.transformer import Transformer
    tr = Transformer(16, 32, 1, 2, attn_order=2, blocks=4, device="cpu")
    split = tensor_parallel(tr, Mesh(1, 2))
    attn = tr.blocks[0].attn
    assert attn.whole and (attn.n_head, attn.n_state) == (1, 4)
    assert attn.c_attn.w.shape == (16, 6) and split["blocks.0.attn.c_attn.w"]
    tr = Transformer(16, 32, 1, 2, attn_order=2, blocks=4, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        tensor_parallel(tr, Mesh(1, 3))


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_slices_match_jax(drop_last):
    view = list(range(11))
    n = len(view)
    rng = np.random.RandomState(5 + 2)
    order = np.arange(n)
    rng.shuffle(order)
    for nproc in (1, 2, 3):
        per = n // nproc if drop_last else -(-n // nproc)
        for proc in range(nproc):
            ld = ShardedLoader(view, 2, shuffle=True, drop_last=drop_last,
                               seed=5, proc=proc, nproc=nproc)
            ld.set_epoch(2)
            np.testing.assert_array_equal(ld._indices(),
                                          order[proc::nproc][:per])
