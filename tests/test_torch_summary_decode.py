"""Sampling with the summary pattern (attn_func 4: attn orders 3 [1, 4] and
5 [1, 4, 1, 1]) in the PyTorch port, against jukebox_tpu on the CPU, on the
same numpy inputs and converted params:

* attention alone, fp32: token-by-token f4 decode (the layer module at host
  positions, at a StepIndex advanced on the device as a CUDA graph replays
  it, and the ring-kernel composition c_attn -> ring_attn_decode -> c_proj
  through ring_geometry) and chunked prefill at 1 and 2 blocks a chunk
  followed by decode, against the JAX decode_step / prefill_chunk at atol
  2e-5 (tests/test_attention.py's bound on JAX against its forward), the
  caches too;
* ring_geometry's f4 rows before, at and after a block's last token and in
  the last block;
* priors of order 5 at depth 5 and order 3 at depth 9 (packed and unpacked
  layers meet in both), conditioned on artist, genre and timing: the fp32
  decode logits on a forced token stream against the JAX _decode_one at
  rtol / atol 1e-4 (tests/test_torch_prior.py's), tokens at top_k=1 with a
  two-block context prefill equal to the JAX sampler's, and the staged
  bf16 and int8 decode (the kernels' plain versions) within STAGED_TOL of
  max(1, |logit|) of the fp32 and bf16 paths;
* the packing rule: the layers the port marks packed equal the layers the
  JAX package packs into its megakernel (_stack_eligible /
  _flat_stack_func) at the depths of orders 3 and 5 and at every preset
  prior, where they stay all layers;
* the int8 mode's staging against the JAX package's stage_decode
  (JUKEBOX_STACK_KERNEL=1, as on its TPU): every layer's weights int8 (the
  unpacked ones bit for bit its quantize_dense_tree), int8 caches on the
  packed layers alone, the rest in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu.models.attention import FactoredAttention as JAttn
from jukebox_tpu.models.transformer import Transformer as JTransformer
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.models.attention import FactoredAttention
from jukebox_tpu_torch.models.transformer import Transformer
from jukebox_tpu_torch.ops.decode_stack import (ring_attn_decode_plain,
                                                ring_geometry)
from jukebox_tpu_torch.utils.convert import from_jax_params

from test_torch_prior import META, TOP, VQ

torch.set_num_threads(1)
ATOL = 2e-5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STAGED_TOL = 0.05  # bf16 vs fp32, int8 vs bf16: test_torch_prior's bound
N_IN, A, H, N_CTX, BLOCKS, B = 16, 8, 2, 32, 4, 2
BC = N_CTX // BLOCKS
N = 2


def make(seed=0):
    kw = dict(n_in=N_IN, n_ctx=N_CTX, n_state=A, n_head=H, attn_func=4,
              blocks=BLOCKS, mask=True)
    ja = JAttn(**kw)
    params = ja.init(jax.random.key(seed))
    # non-zero biases: the zero pad's k = 0 row then differs from a bias
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(seed + 7),
                                              p.shape), params)
    ta = FactoredAttention(**kw, device="cpu")
    from_jax_params(ta, jax.tree_util.tree_map(np.asarray, params))
    return ja, params, ta


def x_seq(T, seed=1):
    return np.random.RandomState(seed).randn(B, T, N_IN).astype(np.float32)


def _close(out, ref, what):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("path", ["layer", "step_index", "ring"])
def test_f4_decode_matches_jax(path):
    """Every position of four blocks, token by token, in lockstep with
    the JAX decode_step; the caches at the end."""
    ja, params, ta = make()
    step = jax.jit(lambda p, c, x, t: ja.decode_step(p, c, x, t))
    jc = ja.init_cache(params, B, jnp.float32)
    tc = ta.init_cache(B, torch.float32, "cpu")
    assert tc["k"].shape == (B, BLOCKS + 1, A) == jc["k"].shape
    pos = ta.step_index(0, "cpu")
    xs = x_seq(N_CTX)
    with torch.no_grad():
        for t in range(N_CTX):
            x = xs[:, t:t + 1]
            ref, jc = step(params, jc, jnp.asarray(x), jnp.int32(t))
            if path == "ring":
                geom = ring_geometry(4, t, tc["k"].shape, BC)
                qkv = ta.c_attn(torch.from_numpy(x[:, 0]))
                o = ring_attn_decode_plain(qkv, tc["k"], tc["v"], geom, H,
                                           qkv)
                out = ta.c_proj(o)[:, None]
            elif path == "step_index":
                out = ta.decode_step(tc, torch.from_numpy(x),
                                     pos.positions())
                pos.advance()
            else:
                out = ta.decode_step(tc, torch.from_numpy(x), t)
            _close(out.numpy(), ref, f"{path} t={t}")
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key], key)
    # row 0 stays the zero pad; the last block's summary is written
    assert float(tc["k"][:, 0].abs().sum()) == 0.0
    assert float(tc["k"][:, BLOCKS].abs().sum()) > 0.0


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_f4_prefill_then_decode_matches_jax(n_blocks):
    """Chunks of n_blocks blocks over the first three quarters of the
    context (each block's last row its summary), then token decode to the
    end."""
    ja, params, ta = make(3)
    jstep = jax.jit(lambda p, c, x, t: ja.decode_step(p, c, x, t))
    jpre = jax.jit(lambda p, c, x, t0, nb: ja.prefill_chunk(p, c, x, t0, nb),
                   static_argnums=(4,))
    jc = ja.init_cache(params, B, jnp.float32)
    tc = ta.init_cache(B, torch.float32, "cpu")
    xs = x_seq(N_CTX, seed=5)
    chunk = n_blocks * BC
    pre = (3 * N_CTX // 4) // chunk * chunk
    with torch.no_grad():
        for t0 in range(0, pre, chunk):
            x = xs[:, t0:t0 + chunk]
            ref, jc = jpre(params, jc, jnp.asarray(x), jnp.int32(t0),
                           n_blocks)
            out = ta.prefill_chunk(tc, torch.from_numpy(x), t0, n_blocks)
            _close(out.numpy(), ref, f"prefill t0={t0}")
            for key in ("k", "v"):
                _close(tc[key].numpy(), jc[key], f"{key} after t0={t0}")
        for t in range(pre, N_CTX):
            x = xs[:, t:t + 1]
            ref, jc = jstep(params, jc, jnp.asarray(x), jnp.int32(t))
            _close(ta.decode_step(tc, torch.from_numpy(x), t).numpy(), ref,
                   f"t={t}")
    for key in ("k", "v"):
        _close(tc[key].numpy(), jc[key], key)


def test_f4_ring_geometry():
    """(rows, write, first read, count): the summary row written only at a
    block's last token and read from that token on; the last block's never
    read."""
    shape = (B, BLOCKS + 1, A)
    assert ring_geometry(4, 0, shape, BC) == (BLOCKS + 1, -1, 0, 1)
    assert ring_geometry(4, BC - 2, shape, BC) == (BLOCKS + 1, -1, 0, 1)
    assert ring_geometry(4, BC - 1, shape, BC) == (BLOCKS + 1, 1, 0, 2)
    assert ring_geometry(4, BC, shape, BC) == (BLOCKS + 1, -1, 0, 2)
    assert ring_geometry(4, 2 * BC - 1, shape, BC) == (BLOCKS + 1, 2, 0, 3)
    last = N_CTX - 1
    assert ring_geometry(4, last - 1, shape, BC) == (BLOCKS + 1, -1, 0,
                                                     BLOCKS)
    assert ring_geometry(4, last, shape, BC) == (BLOCKS + 1, BLOCKS, 0,
                                                 BLOCKS)


# -- priors of orders 3 and 5 ------------------------------------------------

LABELLED = dict(TOP, use_tokens=False, n_tokens=0, single_enc_dec=False,
                prime_loss_fraction=0.0)
PRIORS = {"order5_depth5": dict(LABELLED, attn_order=5, prior_depth=5),
          "order3_depth9": dict(LABELLED, attn_order=3, prior_depth=9)}
# the layers the JAX package's decode plan packs at these depths
PACKED = {"order5_depth5": {0, 2, 3, 4}, "order3_depth9": {0}}


def build(name):
    cfg = PRIORS[name]
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    jp = jmm.make_prior(jhp.setup_hparams("teeny", dict(cfg)), jvq)
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(cfg)), tvq, "cpu")
    from_jax_params(tp.model, jax.tree_util.tree_map(np.asarray, jp.params))
    y = jp.get_y(jp.labeller.get_batch_labels([META] * N), 0)
    z = np.random.RandomState(2).randint(0, VQ["l_bins"], (N, jp.n_ctx))
    return jp, tp, y, z


@pytest.fixture(scope="module", params=sorted(PRIORS))
def prior(request):
    return (request.param, *build(request.param))


def test_prior_decode_logits_match_jax(prior):
    name, jp, tp, y, z = prior
    funcs = [b.attn.attn_func for b in tp.model.prior.transformer.blocks]
    assert 4 in funcs
    jar = jp.model.prior
    params = jp.params
    x_cond, y_cond, _ = jp.model.get_cond(params, None, jnp.asarray(y))
    dec = jar.transformer.prepare_decode_params(params["prior"]["transformer"])
    jc = jar.init_decode_caches(params["prior"], N, dec_params=dec)
    jstep = jax.jit(lambda c, tok, t: jar._decode_one(
        params["prior"], dec, c, tok, t, x_cond, y_cond, None, False, N))
    m = tp.model
    with torch.no_grad():
        tx, ty, _ = m.get_cond(None, torch.as_tensor(np.asarray(y)))
        if tx is None:
            tx = m.prior.default_x_cond(N)
        caches = m.prior.init_decode_caches(N, "cpu")
        tok = np.zeros((N, 1), np.int64)
        for t in range(jp.n_ctx):
            ref, jc = jstep(jc, jnp.asarray(tok), jnp.int32(t))
            out = m.prior._decode_one(None, caches, torch.as_tensor(tok), t,
                                      tx, ty, False, N)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       err_msg=f"{name} t={t}", **LOGIT_TOL)
            tok = z[:, t:t + 1]


def test_prior_top_k1_tokens_with_context_match_jax(prior):
    """Two blocks of context prefilled (one block a chunk), then sampled at
    top_k=1 to the end of the window: the JAX sampler's tokens."""
    name, jp, tp, y, z = prior
    ctx = 2 * (jp.n_ctx // PRIORS[name]["blocks"])
    ref = jp.sample(N, z=z[:, :ctx], y=y, rng=jax.random.key(0), fp16=False,
                    temp=1.0, top_k=1, chunk_size=ctx // 2)
    out = tp.sample(N, z=torch.as_tensor(z[:, :ctx]),
                    y=torch.as_tensor(np.asarray(y)), fp16=False, temp=1.0,
                    top_k=1, chunk_size=ctx // 2)
    assert out.shape == (N, jp.n_ctx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _staged_logits(tp, y, z, quantize=None, fp16=True):
    """Logits [N, n_ctx, bins] of the forced stream z through the staged
    decode (bf16 or int8; the kernels' plain versions on the CPU), or the
    fp32 layer modules."""
    m = tp.model
    dec, int8 = None, False
    if fp16:
        tp.stage_decode(quantize=quantize)
        dec, int8 = tp.staged, quantize == "int8"
    with torch.no_grad():
        x_cond, y_cond, _ = m.get_cond(None, torch.as_tensor(np.asarray(y)))
        if x_cond is None:
            x_cond = m.prior.default_x_cond(N)
        if fp16:
            x_cond = x_cond.to(torch.bfloat16)
        caches = m.prior.init_decode_caches(N, "cpu", fp16=fp16,
                                            dec_params=dec, int8=int8)
        tok = torch.zeros((N, 1), dtype=torch.long)
        out = []
        for t in range(z.shape[1]):
            out.append(m.prior._decode_one(dec, caches, tok, t, x_cond,
                                           y_cond, fp16, N)[:, 0].float())
            tok = torch.as_tensor(z[:, t:t + 1])
    return torch.stack(out, 1), caches


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_staged_decode_within_bound(prior, mode):
    """The bf16 staged decode against the fp32 one, the int8 against the
    bf16; the int8 run's caches int8 on the packed layers alone."""
    name, _, tp, y, z = prior
    ref, _ = (_staged_logits(tp, y, z, fp16=False) if mode == "bf16"
              else _staged_logits(tp, y, z))
    out, caches = _staged_logits(tp, y, z,
                                 "int8" if mode == "int8" else None)
    err = (out - ref).abs() / ref.abs().clamp_min(1.0)
    assert float(err.max()) <= STAGED_TOL, (name, float(err.max()))
    dtypes = [c["k"].dtype for c in caches]
    want = torch.int8 if mode == "int8" else torch.bfloat16
    assert {d for d, c in enumerate(dtypes) if c == want} == (
        PACKED[name] if mode == "int8" else set(range(len(dtypes))))


# -- the packing rule --------------------------------------------------------

PRESETS = ("upsampler_level_0", "upsampler_level_1", "prior_5b",
           "prior_5b_lyrics", "prior_1b_lyrics", "small_prior",
           "small_labelled_prior", "small_single_enc_dec_prior",
           "small_sep_enc_dec_prior", "small_upsampler")
ORDERS = {"order3_depth8": (3, 8), "order3_depth9": (3, 9),
          "order3_depth72": (3, 72), "order5_depth5": (5, 5),
          "order5_depth8": (5, 8), "order5_depth72": (5, 72)}


def _pair(n_depth, attn_order, blocks, n_ctx, width, heads, prime_len=None,
          encoder_dims=None):
    kw = dict(n_ctx=n_ctx, n_head=heads, n_depth=n_depth,
              attn_order=attn_order, blocks=blocks, prime_len=prime_len,
              encoder_dims=encoder_dims)
    return (JTransformer(n_in=width, **kw),
            Transformer(width, device="meta", **kw))


def _jax_packed(jt):
    out = set()
    for seg in jt.decode_plan:
        if seg[0] == "flat":
            if jt._flat_stack_func(seg[1]) is not None:
                out.add(seg[1])
        elif jt._stack_eligible(seg):
            out.update(s + j for s in seg[2] for j in range(len(seg[1])))
    return out


@pytest.mark.parametrize("case", sorted(ORDERS) + list(PRESETS))
def test_packed_layers_match_jax(case):
    if case in ORDERS:
        order, depth = ORDERS[case]
        jt, tt = _pair(depth, order, 64, 6144, 64, 2)
    else:
        h = thp.setup_hparams(case, {})
        lyric = h.single_enc_dec and h.use_tokens
        jt, tt = _pair(h.prior_depth, h.attn_order, h.blocks,
                       h.n_ctx + (h.n_tokens if lyric else 0), h.prior_width,
                       h.heads, h.n_tokens if lyric else None,
                       h.n_tokens if h.use_tokens and not lyric else None)
    assert tt.decode_plan == jt.decode_plan
    assert set(tt.packed) == _jax_packed(jt)
    if case in PRESETS:
        assert tt.packed == frozenset(range(tt.n_depth)), case
    if case in ("order5_depth5", "order3_depth9"):
        assert set(tt.packed) == PACKED[case]


def test_int8_staging_matches_jax_stage_decode(prior, monkeypatch):
    """The JAX package's stage_decode(quantize="int8") on its TPU plan
    (JUKEBOX_STACK_KERNEL=1): the packed segments are exactly the port's
    packed layers; the others hold its quantize_dense_tree, which the
    port's staging equals bit for bit; the port's int8 caches are the
    packed layers'."""
    name, jp, tp, y, z = prior
    monkeypatch.setenv("JUKEBOX_STACK_KERNEL", "1")
    monkeypatch.delenv("JUKEBOX_INT8_CACHE", raising=False)
    jp.stage_decode(quantize="int8")
    jt = jp.model.prior.transformer
    tt = tp.model.prior.transformer
    jpacked = set()
    unpacked = {}
    for seg, p in zip(jt.decode_plan, jp._staged_dec):
        layers = ([seg[1]] if seg[0] == "flat" else
                  [s + j for s in seg[2] for j in range(len(seg[1]))])
        if isinstance(p, dict) and "stack_packed" in p:
            jpacked.update(layers)
        elif seg[0] == "flat":
            unpacked[seg[1]] = p
        else:
            for g, s in enumerate(seg[2]):
                for j in range(len(seg[1])):
                    unpacked[s + j] = jax.tree_util.tree_map(
                        lambda a, g=g: np.asarray(a)[g], p[j])
    assert jpacked == set(tt.packed) == PACKED[name]
    tp.stage_decode(quantize="int8")
    keys = (("qkv", "attn", "c_attn"), ("proj", "attn", "c_proj"),
            ("fc", "mlp", "c_fc"), ("mlp", "mlp", "c_proj"))
    for d, layer in enumerate(tp.staged):
        assert all("w_q" in layer[k] for k, _, _ in keys), d
        if d in unpacked:
            for k, a, b in keys:
                np.testing.assert_array_equal(
                    layer[k]["w_q"].numpy(),
                    np.asarray(unpacked[d][a][b]["w_q"]), err_msg=f"{d} {k}")
    caches = tp.model.prior.init_decode_caches(N, "cpu", fp16=True,
                                               dec_params=tp.staged,
                                               int8=True)
    assert {d for d, c in enumerate(caches)
            if c["k"].dtype == torch.int8} == jpacked
    assert all(c["k"].dtype == torch.bfloat16 and "ks" not in c
               for d, c in enumerate(caches) if d not in jpacked)
