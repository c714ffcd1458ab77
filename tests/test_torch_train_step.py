"""Three steps of the port's prior train step (jukebox_tpu_torch/train.py
make_prior_train_step: VQ-VAE encode, z_forward, backward, clipped Adam with
weight decay) against jukebox_tpu.train.make_prior_train_step on the CPU,
from one state (params and Adam state cross over with utils/convert.py) and
one batch, for a tiny order-12 lyric top prior (16 layers, f7 prime layer
at 15). The learning rate is 1e-3 from step 1 and the gradient norm crosses
the clip (set to 0.4) by step 3, so clipping is exercised.

fp32 (fp32 moments, loss scale 1): loss per step within 1e-5, moments after
step 3 within 1e-4 of each leaf's largest |value| (fp32, summation order
only); params within 1e-3 x lr x steps: Adam divides each gradient by its
running RMS, so the ~1e-6 relative rounding of an element whose gradient is
small beside its leaf's grows in its step, but stays far below one step.

fp16 + fp16_opt (bf16 activations, fp16 moments with per-tensor scales,
loss scale 2**16): loss per step within 1e-4 relative, the gradient norm
within 1e-2 relative (bf16 rounding through 16 layers, in other places on
each side); params normwise, ||port - JAX|| within 5e-2 of ||JAX - start||,
how far the three steps moved them (1.2e-2 measured: Adam moves an element
by up to lr per step whatever its gradient's size, so one whose gradient
bf16 noise dominates may move the other way); the unscaled moments
of all leaves together within 1e-2 in norm, and each leaf within 1e-1 of
its largest |value| (a few leaves, such as attention biases whose exact
gradient is near zero, hold little but rounding noise in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu import train as jtrain
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import train as ttrain
from jukebox_tpu_torch.utils import train_utils as ttu
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             opt_state_from_jax,
                                             opt_state_to_jax, to_jax_params)

from test_torch_train import TOP, VQ, build_pair

torch.set_num_threads(1)
LR, STEPS = 1e-3, 3
CFG = dict(TOP, prior_depth=16, train=True, prior=True, lr=LR, lr_warmup=1.0,
           weight_decay=0.01, clip=0.4)


@pytest.fixture(scope="module")
def pair():
    return build_pair(CFG, seed=2)


def _unscaled(opt):
    """{path: moment as fp32} of a JAX-layout Adam state."""
    flat = flatten_tree(opt)
    out = {}
    for key in ("m", "v"):
        for path, a in flat.items():
            if path.startswith(key + "."):
                s = flat.get(f"{key}_scale.{path[len(key) + 1:]}", 1.0)
                out[path] = np.asarray(a, np.float32) * np.float32(s)
    return out


@pytest.mark.parametrize("fp16", [False, True])
def test_three_steps_match_jax(pair, fp16):
    jvq, jp, tvq, tp, x, y = pair
    hps = jhp.setup_hparams("teeny", dict(CFG, **VQ, fp16=fp16,
                                          fp16_opt=fp16))
    thps = thp.setup_hparams("teeny", dict(CFG, **VQ, fp16=fp16,
                                           fp16_opt=fp16))
    p0 = jax.tree_util.tree_map(np.asarray, jp.params)
    from_jax_params(tp.model, p0)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    jopt = jtu.adam_init(params, fp16_state=fp16)
    topt = opt_state_from_jax(tp.model, jax.tree_util.tree_map(np.asarray,
                                                               jopt))
    jstep = jtrain.make_prior_train_step(jp, hps, jtu.make_lr_schedule(hps))
    tstep = ttrain.make_prior_train_step(tp, thps,
                                         ttu.make_lr_schedule(thps))
    scale = 2.0 ** 16 if fp16 else 1.0
    batch_j = (jnp.asarray(x), jnp.asarray(y))
    batch_t = (torch.from_numpy(x), torch.from_numpy(y))
    gns = []
    for it in range(1, STEPS + 1):
        params, jopt, _, jloss, jm = jstep(params, jopt, None, batch_j,
                                           jax.random.key(it),
                                           jnp.asarray(it), scale)
        tloss, tm = tstep(topt, batch_t, None, it, scale)
        assert tm["step_ok"] and bool(jm["step_ok"])
        gns.append(float(jm["gn"]))
        if fp16:
            assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)
            assert float(tm["gn"]) == pytest.approx(float(jm["gn"]),
                                                    rel=1e-2)
        else:
            assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
            assert float(tm["gn"]) == pytest.approx(float(jm["gn"]),
                                                    rel=1e-5)
    assert max(gns) > hps.clip  # the clip was taken
    assert topt["step"] == int(jopt["step"]) == STEPS
    jp_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    tp_flat = flatten_tree(to_jax_params(tp.model))
    assert jp_flat.keys() == tp_flat.keys()
    if fp16:
        # normwise against how far the steps moved the params
        p0_flat = flatten_tree(p0)
        diff = np.sqrt(sum(np.sum((tp_flat[k] - jp_flat[k]) ** 2)
                           for k in jp_flat))
        moved = np.sqrt(sum(np.sum((jp_flat[k] - p0_flat[k]) ** 2)
                            for k in jp_flat))
        assert diff <= 5e-2 * moved
    else:
        for k, ref in jp_flat.items():
            np.testing.assert_allclose(tp_flat[k], ref, rtol=0,
                                       atol=1e-3 * LR * STEPS, err_msg=k)
    jm_flat = _unscaled(jax.tree_util.tree_map(np.asarray, jopt))
    tm_flat = _unscaled(opt_state_to_jax(tp.model, topt))
    assert jm_flat.keys() == tm_flat.keys()
    for k, ref in jm_flat.items():
        atol = (1e-1 if fp16 else 1e-4) * np.abs(ref).max() + 1e-20
        np.testing.assert_allclose(tm_flat[k], ref, rtol=0, atol=atol,
                                   err_msg=k)
    for key in ("m", "v"):
        keys = [k for k in jm_flat if k.startswith(key + ".")]
        diff = np.sqrt(sum(np.sum((tm_flat[k] - jm_flat[k]) ** 2)
                           for k in keys))
        norm = np.sqrt(sum(np.sum(jm_flat[k] ** 2) for k in keys))
        assert diff <= (1e-2 if fp16 else 1e-5) * norm, key
