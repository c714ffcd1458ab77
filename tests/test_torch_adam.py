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
in exactly one item of each pass, pointers, sizes and per-tensor item
counts as the tensors', a zero state, and a table that is rebuilt when
the state's tensors change; and its walk (item_order): each pass covers
every element once, a tensor's update items come after all of its amax
items and walk its chunks in reverse, and the walk applied chunk by chunk
in numpy gives the plain version's bits and JAX's numbers."""

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


def _coverage(items, sizes, chunk, kinds):
    """Per tensor, how often each element lies in an item of `kinds`."""
    covered = [np.zeros(n, int) for n in sizes]
    for k, start, kind in items:
        if kind in kinds:
            covered[k][start:min(start + chunk, sizes[k])] += 1
    return covered


@pytest.mark.parametrize("fp16", [False, True])
def test_launch_table(fp16, monkeypatch):
    monkeypatch.setattr(tad, "CHUNK", 1000)
    params = _t(_tree(2))
    opt = ttu.adam_init(params, fp16_state=fp16)
    table = tad.table_for(params, opt)
    assert opt[tad.TABLE_KEY] is table and table.fp16 == fp16
    assert table.chunk == 1000
    names = list(params)
    sizes = table.dev["size"].tolist()
    items = list(zip(table.dev["item_tensor"].tolist(),
                     table.dev["item_start"].tolist(),
                     table.dev["item_kind"].tolist()))
    assert items == table.items == tad.item_order(sizes, fp16, 1000)
    passes = ([(tad.AMAX, tad.BOTH), (tad.UPDATE, tad.BOTH)] if fp16
              else [(tad.UPDATE,)])
    for kinds in passes:
        assert all((c == 1).all()
                   for c in _coverage(items, sizes, 1000, kinds))
    assert fp16 or all(kind == tad.UPDATE for *_, kind in items)
    for key, kind in (("n_amax", tad.AMAX), ("n_upd", tad.UPDATE)):
        assert table.dev[key].tolist() == [
            sum(1 for k, _, kd in items if k == t and kd == kind)
            for t in range(len(names))]
    assert table.dev["p"].tolist() == [p.data_ptr() for p in params.values()]
    assert table.dev["m"].tolist() == [m.data_ptr()
                                       for m in opt["m"].values()]
    assert sizes == [p.numel() for p in params.values()]
    assert not (table.amax.any() or table.done.any() or table.ticket.any())
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


def _walk(items, chunk, params, grads, opt, scale, lr, beta1, beta2, eps,
          weight_decay):
    """One update as the kernel walks it, in numpy fp32 with every
    operation rounded as adam_update_plain's (on the CPU): the items in
    order, each over its chunk; an amax item folds its chunk's max |new m|,
    |new v| into its tensor's, an update item stores its chunk under the
    tensor's new scales, which the tensor's last update replaces the old
    with. The square root is PyTorch's on each chunk: on the CPU it rounds
    1 in ~140 values otherwise than numpy's correctly rounded one (the
    card's, which the kernel takes, is correctly rounded). params, opt:
    {name: numpy array}, updated in place."""
    f32 = np.float32
    names = list(params)
    fp16 = "m_scale" in opt
    step_size, b1, b2, c1, c2 = (f32(v) for v in tad.step_scalars(
        opt["step"] + 1, lr, beta1, beta2))
    amax = {}
    left = {k: sum(1 for t, _, kd in items if t == k and kd != tad.AMAX)
            for k in range(len(names))}
    new_scales = {}
    for k, start, kind in items:
        n = names[k]
        p = params[n].reshape(-1)
        sl = slice(start, min(start + chunk, p.size))
        g = grads[n]
        g = (np.zeros(p[sl].shape, f32) if g is None
             else g.reshape(-1)[sl]) / f32(scale)
        m = opt["m"][n].reshape(-1)[sl].astype(f32)
        v = opt["v"][n].reshape(-1)[sl].astype(f32)
        if fp16:
            m = m * opt["m_scale"][n]
            v = v * opt["v_scale"][n]
        m = b1 * m + c1 * g
        v = b2 * v + c2 * g * g
        if kind != tad.UPDATE:
            am, av = amax.get(k, (f32(0), f32(0)))
            amax[k] = (max(am, np.abs(m).max()), max(av, np.abs(v).max()))
        if kind == tad.AMAX:
            continue
        denom = torch.sqrt(torch.from_numpy(v)).numpy() + f32(eps)
        p[sl] = p[sl] - step_size * (m / denom + f32(weight_decay) * p[sl])
        if fp16:
            ms, vs = (f32(1e-8) + a / f32(tad.FLOAT16_MAX) for a in amax[k])
            opt["m"][n].reshape(-1)[sl] = (m / ms).astype(np.float16)
            opt["v"][n].reshape(-1)[sl] = (v / vs).astype(np.float16)
            new_scales[n] = (ms, vs)
        else:
            opt["m"][n].reshape(-1)[sl] = m
            opt["v"][n].reshape(-1)[sl] = v
        left[k] -= 1
        if fp16 and left[k] == 0:
            opt["m_scale"][n], opt["v_scale"][n] = new_scales[n]
    opt["step"] += 1


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_item_order_covers_and_waits(fp16):
    chunk = 1000
    sizes = [int(np.prod(s)) for s in SHAPES.values()]
    items = tad.item_order(sizes, fp16, chunk)
    passes = ([(tad.AMAX, tad.BOTH), (tad.UPDATE, tad.BOTH)] if fp16
              else [(tad.UPDATE,)])
    for kinds in passes:
        assert all((c == 1).all() for c in _coverage(items, sizes, chunk,
                                                     kinds))
    for k, n in enumerate(sizes):
        at = {kd: [i for i, (t, _, x) in enumerate(items) if t == k
                   and x == kd] for kd in (tad.AMAX, tad.UPDATE, tad.BOTH)}
        starts = {kd: [items[i][1] for i in ix] for kd, ix in at.items()}
        if fp16 and n <= chunk:  # one item does both passes
            assert len(at[tad.BOTH]) == 1 and not at[tad.AMAX] + at[tad.UPDATE]
            continue
        assert not at[tad.BOTH]
        # every update item after all of the tensor's amax items; the amax
        # pass walks forward, the update pass in reverse
        assert not at[tad.AMAX] or max(at[tad.AMAX]) < min(at[tad.UPDATE])
        assert starts[tad.AMAX] == sorted(starts[tad.AMAX])
        want = sorted(starts[tad.UPDATE], reverse=True) if fp16 else \
            sorted(starts[tad.UPDATE])
        assert starts[tad.UPDATE] == want and len(set(want)) == len(want)
    # the walk, chunk by chunk, against the plain version's bits and JAX
    params = _tree(3)
    np_p = {k: v.copy() for k, v in params.items()}
    tp = _t(params)
    to = ttu.adam_init(tp, fp16_state=fp16)
    np_o = {"step": 0, "m": {k: v.numpy().copy() for k, v in to["m"].items()},
            "v": {k: v.numpy().copy() for k, v in to["v"].items()}}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if fp16:
        np_o["m_scale"] = {k: np.float32(v) for k, v in to["m_scale"].items()}
        np_o["v_scale"] = {k: np.float32(v) for k, v in to["v_scale"].items()}
        jo = jtu.adam_init(jp, fp16_state=True)
    else:
        jo = {"m": {k: jnp.zeros_like(v) for k, v in jp.items()},
              "v": {k: jnp.zeros_like(v) for k, v in jp.items()},
              "step": jnp.zeros((), jnp.int32)}
    for step in range(3):
        grads = _tree(30 + step, scale=0.5 if fp16 else 3.0)
        scale = 2.0 + step
        ng = dict(grads, b=None) if step == 1 else grads
        _walk(items, chunk, np_p, ng, np_o, scale, **HYPER)
        tg = _t(grads)
        if step == 1:
            tg["b"] = None
            grads = dict(grads, b=np.zeros_like(grads["b"]))
        to = tad.adam_update_plain(tp, tg, to, scale=torch.tensor(scale),
                                   **HYPER)
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        if fp16:
            jp, jo = jtu.adam_update(jp, jg, jo, scale=scale, **HYPER)
        else:
            jp, jo = adam_update_pallas(jp, jg, jo, scale=scale,
                                        interpret=True, **HYPER)
    assert np_o["step"] == to["step"] == 3
    for k in SHAPES:
        assert np.array_equal(np_p[k], tp[k].numpy()), k
        for mk in ("m", "v"):
            assert np.array_equal(np_o[mk][k], to[mk][k].numpy()), (mk, k)
            if fp16:
                assert np_o[mk + "_scale"][k] == to[mk + "_scale"][k].item()
        np.testing.assert_allclose(np_p[k], np.asarray(jp[k]), rtol=0,
                                   atol=1e-6)
        for mk in ("m", "v"):
            ref = np.asarray(jo[mk][k]).astype(np.float32)
            out = np_o[mk][k].astype(np.float32)
            if fp16:  # within one fp16 step, as test_fp16_form_matches_jax
                step_ = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 11)
                assert (np.abs(out - ref) <= step_).all(), mk
                np.testing.assert_allclose(np_o[mk + "_scale"][k],
                                           np.asarray(jo[mk + "_scale"][k]),
                                           rtol=1e-6)
            else:
                np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
