"""fp16_params when sampling: a sampling prior restored with
hps.fp16_params holds its weights in bf16, as jukebox_tpu's make_prior
casts them with convert_params_bf16 after the restore (make_models.py:
868-893), and its LayerNorms in fp32.

A narrow 5b_lyrics-like top prior (tests/test_torch_5b.py TOP_5B_LYRICS:
order 10 at depth 20, 4 heads of width 6, a 2-layer lyric encoder) is
restored in both packages from one `.jkb` of random fp32 params (the
init plus 0.02 of normal noise in every leaf):

1. every parameter's dtype equals the JAX tree's leaf for leaf (bf16, or
   fp32 under ln / ln_0 / ln_1 / prime_state_ln), and its values equal the
   JAX leaf bit for bit;
2. the decode staging reads the cast weights: its bf16 weights equal the
   cast params, and its int8 form equals jukebox_tpu's quantize_dense of
   the cast weights bit for bit;
3. the bf16 decode-step logits on a forced token stream (the port's decode
   kernels' plain versions) against the JAX runtime's bf16 decode step
   (XLA) on the cast params: BF_TOL 0.04 of max(1, |ref|), the bound of
   tests/test_torch_5b_decode.py for two bf16 paths that round at
   different points;
4. the token stream at top_k=1 in the bf16 mode, fed back to the JAX
   runtime's bf16 decode step: every token its argmax or a near tie within
   the same BF_TOL (the two bf16 paths can flip a near tie, after which
   the streams part), and at least 90% exactly its argmax.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.ops import core as jcore
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils.convert import named_leaves
from test_torch_5b import META, N, TOP_5B_LYRICS, VQ

torch.set_num_threads(1)
BF_TOL = 0.04


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """(JAX runtime, port runtime, y) restored with fp16_params=True from
    one checkpoint of random fp32 params."""
    tmp = tmp_path_factory.mktemp("fp16_params")

    def hps(pkg, **kw):
        return pkg.setup_hparams("teeny", dict(TOP_5B_LYRICS, **VQ, **kw))
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    jp = jmm.make_prior(hps(jhp), jvq)
    rs = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*np.shape(a)).astype(
            np.float32), _np(jp.params))
    jmm.save_model_checkpoint(str(tmp), "jax",
                              types.SimpleNamespace(params=params), None, 1,
                              hps(jhp))
    path = str(tmp / "checkpoint_jax.jkb")
    jrt = jmm.make_prior(hps(jhp, restore_prior=path, fp16_params=True), jvq)
    trt = tmm.make_prior(hps(thp, restore_prior=path, fp16_params=True), tvq,
                         "cpu")
    y = jrt.get_y(jrt.labeller.get_batch_labels([META] * N), 0)
    return jrt, trt, y


def test_params_are_cast_like_convert_params_bf16(restored):
    jrt, trt, _ = restored
    ref = named_leaves(trt.model, _np(jrt.params))
    kinds = set()
    for name, p in trt.model.named_parameters():
        a = ref[name]
        bf16 = a.dtype == jnp.bfloat16
        assert bf16 or a.dtype == np.float32, (name, a.dtype)
        assert p.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        np.testing.assert_array_equal(p.float().numpy(),
                                      a.astype(np.float32), err_msg=name)
        kinds.add((name.rsplit(".", 2)[-2], bf16))
    # weights, tables and biases in bf16; the LayerNorms in fp32
    assert ("c_attn", True) in kinds and ("ln_0", False) in kinds
    assert ("prime_state_ln", False) in kinds
    assert ("prime_state_proj", True) in kinds


def test_decode_staging_reads_the_cast_weights(restored):
    _, trt, _ = restored
    tr = trt.model.prior.transformer
    blk = tr.blocks[0]
    bf = tr.prepare_decode_params(torch.bfloat16)
    assert torch.equal(bf[0]["qkv"]["w"], blk.attn.c_attn.w)
    q8 = tr.prepare_decode_params(torch.bfloat16, quantize="int8")
    ref = jcore.quantize_dense({"w": blk.attn.c_attn.w.float().numpy(),
                                "b": blk.attn.c_attn.b.float().numpy()})
    np.testing.assert_array_equal(q8[0]["qkv"]["w_q"].numpy(), ref["w_q"])
    np.testing.assert_array_equal(q8[0]["qkv"]["s"].numpy(),
                                  ref["s"][..., 0, :])


def _jax_decode_logits(jrt, y, z):
    """The JAX runtime's bf16 decode-step logits [N, T, bins] on the forced
    stream z [N, T] (token t - 1 feeds step t)."""
    P, jm = jrt.params, jrt.model
    caches, _, x_cond, y_cond, enc = jm.sample_init(P, N, y=jnp.asarray(y),
                                                    fp16=True)
    prior = jm.prior
    dec = prior.transformer.prepare_decode_params(P["prior"]["transformer"])
    xc = x_cond if prior.x_cond else prior._default_x_cond(N)
    step = jax.jit(lambda c, x, t: prior._decode_one(
        P["prior"], dec, c, x, t, xc, y_cond, enc, True, N))
    tok, out = jnp.zeros((N, 1), jnp.int32), []
    for t in range(z.shape[1]):
        logits, caches = step(caches, tok, jnp.int32(t))
        out.append(np.asarray(logits, np.float32))
        tok = jnp.asarray(z[:, t:t + 1], jnp.int32)
    return np.concatenate(out, axis=1)


def test_bf16_decode_logits_match_jax(restored):
    jrt, trt, y = restored
    z = np.random.RandomState(9).randint(0, VQ["l_bins"], (N, jrt.n_ctx))
    ref = _jax_decode_logits(jrt, y, z)
    m = trt.model
    trt.stage_decode()
    x_tok = torch.zeros((N, 1), dtype=torch.long)
    with torch.no_grad():
        caches, _, x_cond, y_cond = m.sample_init(
            N, y=torch.as_tensor(np.asarray(y)), fp16=True,
            dec_params=trt.staged)
        for t in range(jrt.n_ctx):
            out = m.prior._decode_one(trt.staged, caches, x_tok, t, x_cond,
                                      y_cond, True, N)[:, 0].float().numpy()
            err = np.abs(out - ref[:, t]).max()
            assert err <= BF_TOL * max(1.0, np.abs(ref[:, t]).max()), (t, err)
            x_tok = torch.as_tensor(z[:, t:t + 1])


def test_bf16_top_k1_stream_matches_jax(restored):
    """The port's top_k=1 stream, fed back to the JAX runtime: each token
    is the JAX decode step's argmax, or a near tie within the two bf16
    paths' logit gap (BF_TOL of max(1, |logits|)), and most are exact."""
    jrt, trt, y = restored
    out = trt.sample(N, y=torch.as_tensor(np.asarray(y)), fp16=True,
                     temp=1.0, top_k=1).numpy()
    assert out.shape == (N, jrt.n_ctx) and len(np.unique(out)) > 1
    ref = _jax_decode_logits(jrt, y, out)
    picked = np.take_along_axis(ref, out[..., None], axis=-1)[..., 0]
    best = ref.max(axis=-1)
    tol = BF_TOL * np.maximum(1.0, np.abs(ref).max(axis=-1))
    assert (best - picked <= tol).all()
    assert (ref.argmax(axis=-1) == out).mean() >= 0.9
