"""The port's optimizer, clipping, loss scaling, LR schedule and EMA
(jukebox_tpu_torch/utils/train_utils.py) against jukebox_tpu's on the same
numpy state, on the CPU. Adam, the norms and the EMAs run in fp32 on both
sides: 1e-6 relative / 1e-7 absolute (operation order only; the port
updates in place). The fp16 moments (stored scaled to at most 65504) may
round one fp16 step apart: 2**-10 relative. LossScalar and the LR
schedule are host arithmetic: equal, or within fp32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.hparams import Hyperparams
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch.utils import train_utils as ttu

torch.set_num_threads(1)
SHAPES = {"a": (40, 30), "b": (17,), "c": (3, 4, 5)}


def _state(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("fp16_state", [False, True])
def test_adam_update(fp16_state):
    params, kw = _state(0), dict(lr=1e-3, beta1=0.9, beta2=0.99, eps=1e-8,
                                 weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _t(params)
    jo = jtu.adam_init(jp, fp16_state=fp16_state)
    to = ttu.adam_init(tp, fp16_state=fp16_state)
    for step in range(3):
        grads = _state(10 + step)
        scale = 2.0 + step
        jp, jo = jtu.adam_update(jp, {k: jnp.asarray(v) for k, v in
                                      grads.items()}, jo, scale=scale, **kw)
        to = ttu.adam_update(tp, _t(grads), to, scale=torch.tensor(scale),
                             **kw)
    assert to["step"] == int(jo["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for mk in ("m", "v"):
            ref, out = np.asarray(jo[mk][k]), to[mk][k].numpy()
            assert out.dtype == ref.dtype
            if fp16_state:
                np.testing.assert_allclose(
                    to[mk + "_scale"][k].numpy(),
                    np.asarray(jo[mk + "_scale"][k]), rtol=1e-6)
                # one fp16 rounding step: 2**-10 relative
                np.testing.assert_allclose(out.astype(np.float32),
                                           ref.astype(np.float32),
                                           rtol=2 ** -10, atol=1e-3)
            else:
                np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)


def test_grad_norm_and_clip():
    grads = _state(3)
    gn = ttu.global_grad_norm(_t(grads))
    ref = jtu.global_grad_norm({k: jnp.asarray(v) for k, v in grads.items()})
    np.testing.assert_allclose(float(gn), float(ref), rtol=1e-6)
    for norm, clip, scale in ((2.0, 1.0, 1.0), (0.5, 1.0, 1.0),
                              (3.0, 1.0, 256.0), (0.9, 1.0, 256.0)):
        out = ttu.clipped_grad_scale(torch.tensor(norm), clip, scale)
        ref = jtu.clipped_grad_scale(jnp.asarray(norm), clip, scale)
        assert float(out) == pytest.approx(float(ref), rel=1e-7)


def test_loss_scalar_sequence():
    overflows = [False, False, True, False, True, True, False, False, False]
    for args in ((None,), (128.0,)):
        js = jtu.LossScalar(*args, scale_factor=2.0 ** (1 / 3),
                            scale_window=2)
        ts = ttu.LossScalar(*args, scale_factor=2.0 ** (1 / 3),
                            scale_window=2)
        for o in overflows:
            js.update_scale(o)
            ts.update_scale(o)
            assert ts.get_scale() == js.get_scale()
    for v in (1.0, float("inf"), -float("inf"), float("nan")):
        assert ttu.check_overflow(v) == jtu.check_overflow(v)


@pytest.mark.parametrize("linear", [False, True])
def test_lr_schedule(linear):
    hps = Hyperparams(lr=3e-4, lr_warmup=10.0, lr_decay=50.0, lr_gamma=0.5,
                      lr_scale=0.7, lr_use_linear_decay=linear,
                      lr_start_linear_decay=20)
    jfn, tfn = jtu.make_lr_schedule(hps), ttu.make_lr_schedule(hps)
    for step in (0, 1, 5, 10, 25, 60, 120):
        assert float(tfn(step)) == pytest.approx(float(jfn(step)), rel=1e-6)


@pytest.mark.parametrize("cpu", [False, True])
def test_ema(cpu):
    params = _state(4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = _t(params)
    jema = (jtu.CPUEMA if cpu else jtu.EMA)(jparams, mu=0.9, freq=2)
    tema = (ttu.CPUEMA if cpu else ttu.EMA)(tparams, mu=0.9, freq=2)
    for step in range(5):
        new = _state(20 + step)
        jparams = {k: jnp.asarray(v) for k, v in new.items()}
        for k in tparams:
            tparams[k].copy_(torch.tensor(new[k]))
        jema.step(jparams)
        tema.step(tparams)
    for k in SHAPES:
        out = tema.shadow[k]
        out = out if cpu else out.numpy()
        assert isinstance(tema.shadow[k], np.ndarray) == cpu
        np.testing.assert_allclose(out, np.asarray(jema.shadow[k]),
                                   rtol=1e-6, atol=1e-7)
    assert tema.swap(tparams)[0] is tema.shadow


def test_get_ema():
    hps = Hyperparams(mu=None, bs=1, ngpus=1, ema=True, train=True,
                      cpu_ema=True, cpu_ema_freq=7)
    params = _t(_state(0))
    ema = ttu.get_ema(params, hps)
    ref = jtu.get_ema({k: jnp.asarray(v) for k, v in _state(0).items()}, hps)
    assert isinstance(ema, ttu.CPUEMA) and ema.freq == ref.freq == 7
    assert ema.mu == pytest.approx(ref.mu)
    hps.train = False
    assert ttu.get_ema(params, hps) is None
