"""The int8 decode mode of the PyTorch port against jukebox_tpu on the CPU:

* quantize_dense / quantize_dense_tree (weight-only int8, per-column
  absmax scales) against the JAX package's numpy functions: bit-exact,
  values and scales;
* the int8 cache rows: quantize_row (the megakernel's write rule,
  decode_stack.py:671-689) against the same expression evaluated by JAX,
  and quantize_rows (the prefill -> decode conversion) against
  pack_caches(quantize=True): int8 values and bf16 scales bit-exact;
* the int8 dense of the prefill against jukebox_tpu.ops.core.dense on the
  int8 form: fp32 2e-6, bf16 exact;
* the mode switches JUKEBOX_INT8_DECODE / JUKEBOX_INT8_CACHE and
  stage_decode(quantize="int8"), and an int8 window sampled through
  PriorRuntime.sample with a context prefill, against the bf16 window:
  the int8 logits within INT8_TOL of the bf16 path's.
The decode steps themselves are held against the interpret-mode megakernel
by tests/test_torch_5b_decode.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.ops import core as jcore
from jukebox_tpu.ops.pallas.decode_stack import pack_caches
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.ops import core as tcore
from jukebox_tpu_torch.ops import decode_stack as ds

torch.set_num_threads(1)
INT8_TOL = 0.05


def _weights(shape, seed):
    rng = np.random.RandomState(seed)
    w = (0.02 * rng.randn(*shape)).astype(np.float32)
    w[..., 0, :] *= 40.0          # one large row sets each column's scale
    w[..., :, 1] = 0.0            # an all-zero column: the 1e-12 floor
    return w


@pytest.mark.parametrize("shape", [(48, 40), (3, 16, 24), (257, 72)])
def test_quantize_dense_is_bit_exact(shape):
    w = _weights(shape, sum(shape))
    b = np.arange(shape[-1], dtype=np.float32)
    ref = jcore.quantize_dense({"w": w, "b": b})
    out = tcore.quantize_dense({"w": torch.from_numpy(w),
                                "b": torch.from_numpy(b)})
    assert out["w_q"].dtype == torch.int8 and out["s"].dtype == torch.float32
    np.testing.assert_array_equal(out["w_q"].numpy(), ref["w_q"])
    np.testing.assert_array_equal(out["s"].numpy(), ref["s"][..., 0, :])
    np.testing.assert_array_equal(out["b"].numpy(), ref["b"])


def test_quantize_dense_tree_walks_like_jax():
    tree = {"c_attn": {"w": _weights((16, 24), 1), "b": np.zeros(24, "f4")},
            "ln": {"g": np.ones(16, "f4"), "b": np.zeros(16, "f4")},
            "blocks": [{"w": _weights((8, 8), 2), "b": np.ones(8, "f4")}]}
    ref = jcore.quantize_dense_tree(tree)
    out = tcore.quantize_dense_tree(jax.tree_util.tree_map(torch.from_numpy,
                                                           tree))
    assert set(out["c_attn"]) == {"w_q", "s", "b"}
    assert set(out["ln"]) == {"g", "b"}
    np.testing.assert_array_equal(out["blocks"][0]["w_q"].numpy(),
                                  ref["blocks"][0]["w_q"])
    np.testing.assert_array_equal(out["c_attn"]["s"].numpy(),
                                  ref["c_attn"]["s"][0])


def _rows(seed, shape=(3, 7, 40)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.rand(*shape[:-1], 1) * 3).astype(np.float32)
    x[0, 0] = 0.0                 # an all-zero row: the 1e-8 floor
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def test_quantize_row_matches_the_megakernel_write():
    """decode_stack.py:671-689 on the same bf16 rows."""
    x = _rows(0)
    k = jnp.asarray(x)
    ksc = jnp.maximum(jnp.max(jnp.abs(k), axis=-1, keepdims=True) / 127.0,
                      1e-8)
    ref_q = jnp.clip(jnp.round(k * (1.0 / ksc)), -127.0, 127.0).astype(
        jnp.int8)
    q, s = ds.quantize_row(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(
        s.float().numpy(), np.asarray(ksc[..., 0].astype(jnp.bfloat16)
                                      .astype(jnp.float32)))


def test_quantize_rows_matches_pack_caches():
    """The prefill -> decode conversion: an f1 cache [B, slots, A] through
    pack_caches(quantize=True) (lane 40 = A, so no lane padding)."""
    x = _rows(1, (2, 8, 40))
    std = ({"k": jnp.asarray(x, jnp.bfloat16)[None],
            "v": jnp.asarray(-x, jnp.bfloat16)[None]},)
    k8, v8, ks, vs = pack_caches(std, 8, pat=(1,), lane=40, sublane=1,
                                 quantize=True)
    q, s = ds.quantize_rows(torch.from_numpy(x).bfloat16())
    # kernel layout [G, slots, B, A] -> [B, slots, A]
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(k8)[0].transpose(1, 0, 2))
    np.testing.assert_array_equal(
        s.float().numpy(),
        np.asarray(ks.astype(jnp.float32))[0, :, :, 0].T)
    qv, _ = ds.quantize_rows(torch.from_numpy(-x).bfloat16())
    np.testing.assert_array_equal(qv.numpy(),
                                  np.asarray(v8)[0].transpose(1, 0, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(dtype):
    w = _weights((32, 24), 3)
    b = (0.1 * np.arange(24)).astype(np.float32)
    x = np.random.RandomState(4).randn(2, 5, 32).astype(np.float32)
    jq = jcore.quantize_dense({"w": w, "b": b})
    ref = jcore.dense(jax.tree_util.tree_map(jnp.asarray, jq),
                      jnp.asarray(x, dtype))
    tq = tcore.quantize_dense({"w": torch.from_numpy(w),
                               "b": torch.from_numpy(b)})
    out = tcore.dense_any(torch.from_numpy(x).to(getattr(torch, dtype)), tq)
    tol = 2e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_decode_mode_switches(monkeypatch):
    monkeypatch.delenv("JUKEBOX_INT8_DECODE", raising=False)
    monkeypatch.delenv("JUKEBOX_INT8_CACHE", raising=False)
    assert tmm.decode_mode() == (None, False)
    assert tmm.decode_mode("int8") == ("int8", True)
    monkeypatch.setenv("JUKEBOX_INT8_DECODE", "1")
    assert tmm.decode_mode() == ("int8", True)
    monkeypatch.setenv("JUKEBOX_INT8_CACHE", "0")
    assert tmm.decode_mode() == ("int8", False)
    monkeypatch.delenv("JUKEBOX_INT8_DECODE")
    monkeypatch.setenv("JUKEBOX_INT8_CACHE", "1")
    assert tmm.decode_mode() == (None, True)
    with pytest.raises(ValueError, match="int4"):
        tmm.decode_mode("int4")


VQ = dict(sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000)
UP = dict(level=1, n_ctx=32, prior_width=64, prior_depth=6, heads=1,
          attn_order=2, blocks=4, init_scale=0.7, cond_width=16, cond_depth=1,
          cond_dilation_growth_rate=1, cond_dilation_cycle=None,
          use_tokens=False, labels=False, sr=8000)


def test_int8_window_with_prefill(monkeypatch):
    """An upsampler window with 16 context tokens in the int8 mode
    (JUKEBOX_INT8_DECODE=1): the prefill runs the int8 dense into bf16
    caches, converts them to int8 at the boundary, and the window decodes
    through the int8 plain versions; its decode-step logits on a forced
    stream stay within INT8_TOL of the bf16 mode's, and the staged form is
    rebuilt when the mode changes."""
    monkeypatch.delenv("JUKEBOX_INT8_CACHE", raising=False)
    vq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    rt = tmm.make_prior(thp.setup_hparams("teeny", dict(UP)), vq, "cpu")
    m = rt.model
    rng = np.random.RandomState(5)
    z = torch.from_numpy(rng.randint(0, 32, (2, 32)))
    zc = [torch.from_numpy(rng.randint(0, 32, (2, 16)))]
    logits = {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            monkeypatch.setenv("JUKEBOX_INT8_DECODE", "1")
        q, cache_int8 = rt.stage_decode()
        assert (q == "int8") == (mode == "int8") == cache_int8
        with torch.no_grad():
            caches, x_tok, x_cond, y_cond = m.sample_init(
                2, z=z[:, :16], z_conds=zc, fp16=True, chunk_size=8,
                dec_params=rt.staged, int8=cache_int8)
            assert (caches[0]["k"].dtype == torch.int8) == cache_int8
            out = []
            for t in range(16, 32):
                out.append(m.prior._decode_one(rt.staged, caches, x_tok, t,
                                               x_cond, y_cond, True, 2))
                x_tok = z[:, t:t + 1]
        logits[mode] = torch.cat(out, dim=1)
        toks = rt.sample(2, z=z[:, :16], z_conds=zc, fp16=True, temp=0.0,
                         chunk_size=8)
        assert toks.shape == (2, 32) and torch.equal(toks[:, :16], z[:, :16])
    scale = max(1.0, float(logits["bf16"].abs().max()))
    err = float((logits["int8"] - logits["bf16"]).abs().max())
    assert 0 < err <= INT8_TOL * scale
