"""The port's Adam (jukebox_tpu_torch/ops/adam.py) against jukebox_tpu on
the same numpy state, on the CPU, three updates each:

* the plain fp32-moment version against the Pallas kernel
  (ops/pallas/adam.py adam_update_pallas, interpret mode) within 1e-6
  (fp32, operation order only);
* the fp16-moment form against jukebox_tpu.utils.train_utils.adam_update:
  params within 1e-6, scales within 1e-6 relative, the fp16 moments within
  one fp16 step (both round x / s to fp16 from fp32 values that may differ
  in the last bit);

and the kernel's launch table (AdamTable): every element of every tensor
in exactly one chunk, pointers and sizes as the tensors', and a table that
is rebuilt when the state's tensors change."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops.pallas.adam import adam_update_pallas
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch.ops import adam as tad
from jukebox_tpu_torch.utils import train_utils as ttu

torch.set_num_threads(1)
SHAPES = {"w": (64, 48), "b": (48,), "emb": (3, 5, 7), "big": (70001,)}
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.01)


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (scale * rs.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def test_plain_matches_pallas():
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = {"m": {k: jnp.zeros_like(v) for k, v in jp.items()},
          "v": {k: jnp.zeros_like(v) for k, v in jp.items()},
          "step": jnp.zeros((), jnp.int32)}
    tp = _t(params)
    to = ttu.adam_init(tp)
    for step in range(3):
        grads = _tree(10 + step, scale=3.0)
        scale = 1.5 + step
        jp, jo = adam_update_pallas(jp, {k: jnp.asarray(v) for k, v in
                                         grads.items()}, jo, scale=scale,
                                    interpret=True, **HYPER)
        to = tad.adam_update_plain(tp, _t(grads), to,
                                   scale=torch.tensor(scale), **HYPER)
    assert to["step"] == int(jo["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        for mk in ("m", "v"):
            np.testing.assert_allclose(to[mk][k].numpy(),
                                       np.asarray(jo[mk][k]), rtol=0,
                                       atol=1e-6)


def test_fp16_form_matches_jax():
    params = _tree(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jtu.adam_init(jp, fp16_state=True)
    tp = _t(params)
    to = ttu.adam_init(tp, fp16_state=True)
    for step in range(3):
        grads = _tree(20 + step, scale=0.5)
        if step == 1:
            grads["b"] = np.zeros_like(grads["b"])  # a None gradient below
        jp, jo = jtu.adam_update(jp, {k: jnp.asarray(v) for k, v in
                                      grads.items()}, jo, scale=2.0, **HYPER)
        tgrads = _t(grads)
        if step == 1:
            tgrads["b"] = None
        to = ttu.adam_update(tp, tgrads, to, scale=2.0, **HYPER)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        for mk in ("m", "v"):
            ref = np.asarray(jo[mk][k]).astype(np.float32)
            out = to[mk][k].numpy()
            assert out.dtype == np.float16
            step_ = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 11)
            assert (np.abs(out.astype(np.float32) - ref) <= step_).all(), mk
            np.testing.assert_allclose(to[mk + "_scale"][k].numpy(),
                                       np.asarray(jo[mk + "_scale"][k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("fp16", [False, True])
def test_launch_table(fp16, monkeypatch):
    monkeypatch.setattr(tad, "CHUNK", 1000)
    params = _t(_tree(2))
    opt = ttu.adam_init(params, fp16_state=fp16)
    table = tad.table_for(params, opt)
    assert opt[tad.TABLE_KEY] is table and table.fp16 == fp16
    covered = {n: np.zeros(p.numel(), int) for n, p in params.items()}
    names = list(params)
    sizes = table.dev["size"].tolist()
    for k, start in zip(table.dev["chunk_tensor"].tolist(),
                        table.dev["chunk_start"].tolist()):
        covered[names[k]][start:min(start + 1000, sizes[k])] += 1
    assert all((c == 1).all() for c in covered.values())
    assert table.dev["p"].tolist() == [p.data_ptr() for p in params.values()]
    assert table.dev["m"].tolist() == [m.data_ptr()
                                       for m in opt["m"].values()]
    assert sizes == [p.numel() for p in params.values()]
    assert tad.table_for(params, opt) is table
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    grads["b"] = None
    ptrs = table.grad_ptrs(grads).tolist()
    assert ptrs[names.index("b")] == 0
    assert ptrs[0] == grads[names[0]].data_ptr()
    with pytest.raises(TypeError):
        table.grad_ptrs(dict(grads, w=grads["w"].double()))
    opt["m"]["w"] = opt["m"]["w"].clone()  # another tensor: a new table
    assert tad.table_for(params, opt) is not table
    # the plain version on the CPU, whatever the table
    tad.adam_update(params, grads, opt, **HYPER)
    assert opt["step"] == 1 and tad.LAUNCHES["adam_update"] == 0
