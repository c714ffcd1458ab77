"""The fp32 decode step as a DecodeGraph runs it (models/autoregressive.py:
its StepIndex advanced on the device, the embedding read at it), the form
the in-training sample replays as a CUDA graph on the card, against the
decode loop's host positions, on the CPU (where the graph's step runs op by
op, DecodeGraph.run): equal tokens at temp 0 and, from one generator seed,
at temp 1, and equal caches after, for every attention pattern the decode
path has (f0-f3, f6, f7; an upsampler with x_cond, a single-enc-dec top
with its lyric prefix, a top with a lyric encoder); the positions StepIndex
derives against their host formulas. On the card (gpu): the same through
the captured graph, and the LayerNorm wrapper's launches equal to op by
op's less the replays' (counted in GRAPHS). This file imports no JAX: on
the card, `python -m pytest --noconftest tests/test_torch_decode_graph.py`.
"""

import numpy as np
import pytest
import torch

from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import autoregressive as ar
from jukebox_tpu_torch.models.attention import StepIndex
from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
from jukebox_tpu_torch.models.transformer import ATTN_ORDERS

torch.set_num_threads(1)
VQ = dict(sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
          m_conv=1.0, dilation_growth_rate=1, sr=8000)
META = dict(artist="unknown", genre="unknown", lyrics="la la la la la",
            total_length=8000 * 30, offset=0)
BASE = dict(VQ, n_ctx=32, prior_width=16, heads=2, blocks=4, init_scale=0.7,
            min_duration=0.0, max_duration=600.0)
CONFIGS = {
    # level 0: x_cond from the level above; f1, f2, f3
    "upsampler": dict(BASE, level=0, prior_depth=3, attn_order=2,
                      cond_width=8, cond_depth=1, labels=False),
    # the lyric stream: f7 at 15 and 31, f0 at 47
    "single_enc_dec": dict(BASE, level=2, n_ctx=24, prior_depth=48,
                           attn_order=12, labels=True, labels_v3=True,
                           y_bins=(604, 7898), t_bins=16,
                           max_bow_genre_size=1, n_vocab=79, use_tokens=True,
                           n_tokens=8, single_enc_dec=True),
    # a lyric encoder read by the f6 layer at 9
    "sep_enc_dec": dict(BASE, level=2, n_ctx=16, prior_depth=10,
                        attn_order=8, labels=True, labels_v3=True,
                        y_bins=(604, 7898), t_bins=16, max_bow_genre_size=1,
                        n_vocab=79, use_tokens=True, n_tokens=8,
                        prime_width=16, prime_depth=2, prime_heads=2,
                        prime_attn_order=2, prime_blocks=4),
}


def _prior(name, device="cpu"):
    hps = thp.setup_hparams("teeny", CONFIGS[name])
    return make_prior(hps, make_vqvae(hps, device), device)


def _sample(rt, graph, temp, monkeypatch):
    monkeypatch.setattr(ar.DecodeGraph, "wanted",
                        staticmethod(lambda device, n: graph and n >= 2))
    m = rt.model
    dev = m.prior.x_emb.table.device
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, rt.sample_length, 1)).astype(np.float32)).to(dev)
    zs = rt.encode(x, bs_chunks=2)
    z_conds = zs[1:] or None
    y = None
    if m.y_cond:
        y = torch.from_numpy(m.get_y(m.labeller.get_batch_labels(
            [META] * 2), 0)).to(dev)
    caches, x_tok, x_cond, y_cond = m.sample_init(2, z_conds=z_conds, y=y,
                                                  encoder_kv=(
        m.encoder_kv_from_y(y) if m.prime_prior is not None else None))
    t0 = m.sample_prefix_len(None)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks, _ = m.sample_segment(caches, x_tok, t0, m.prior.input_dims - t0,
                               gen, x_cond, y_cond, temp=temp)
    return toks, caches


@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_positions_decode_as_host_positions(name, monkeypatch):
    rt = _prior(name)
    funcs = {ATTN_ORDERS[rt.model.prior.transformer.attn_order](d)
             for d in range(rt.model.prior.transformer.n_depth)}
    assert funcs >= {"upsampler": {1, 2, 3}, "single_enc_dec": {0, 1, 2, 3, 7},
                     "sep_enc_dec": {1, 2, 3, 6}}[name]
    calls = []

    def op_by_op(self, x_tok):
        # the graph's step as its capture records it, run on the CPU
        calls.append(1)
        self.tok.copy_(x_tok)
        return self.run()
    monkeypatch.setattr(ar.DecodeGraph, "step", op_by_op)
    for temp in (0.0, 1.0):
        want, want_c = _sample(rt, False, temp, monkeypatch)
        assert not calls
        got, got_c = _sample(rt, True, temp, monkeypatch)
        assert len(calls) == got.shape[1] - (rt.model.sample_prefix_len(None)
                                             == 0)
        calls.clear()
        assert torch.equal(got, want), temp
        for a, b in zip(got_c, want_c):
            for k in a:
                assert torch.equal(a[k], b[k]), k


def test_step_index_positions():
    bc, blocks, pl = 8, 4, 16
    pos = StepIndex(0, "cpu", bc, blocks, pl)
    for t in range(40):
        p = {k: int(v) for k, v in pos.positions().items()}
        assert p == dict(t=t, mod=t % bc, div=t // bc,
                         f2=(t % bc) * blocks + t // bc,
                         f3=((t // bc) % 2) * bc + t % bc,
                         f3_prev=(((t // bc) - 1) % 2) * bc,
                         f4=1 + t // bc, f4_keep=int(t % bc == bc - 1),
                         f4_hi=min((t + 1) // bc, blocks - 1),
                         f7=min(t, pl - 1), f7_keep=int(t < pl))
        pos.advance()
    assert set(StepIndex(3, "cpu").positions()) == {"t"}


def test_graph_wanted_on_the_card_only():
    assert not ar.DecodeGraph.wanted("cpu", 100)
    assert ar.DecodeGraph.wanted("cuda", 2)
    assert not ar.DecodeGraph.wanted("cuda", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_graph_decodes_as_op_by_op(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from jukebox_tpu_torch.ops import layer_norm as ln
    rt = _prior(name, "cuda")
    out = {}
    for graph in (False, True):
        ln.reset_launches()
        ar.reset_graph_counts()
        toks, caches = _sample(rt, graph, 0.0, monkeypatch)
        out[graph] = toks, caches, ln.LAUNCHES["layer_norm_fwd"]
    assert torch.equal(out[True][0], out[False][0])
    # one window: one capture, and a replay for each step after the first
    # graphed one; the wrapper counts the capture's launches, no replay's
    assert ar.GRAPHS["captures"] == 1
    replays = ar.GRAPHS["replays"]
    per_step = 2 * rt.model.prior.transformer.n_depth
    assert out[True][2] == out[False][2] - per_step * (replays - 1)
    for a, b in zip(out[True][1], out[False][1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_a_traced_graph_decodes_as_untraced(monkeypatch):
    """The graphed decode with its capture under torch.profiler (the
    recorder's fine spans enter record_function while it captures): the
    same tokens as untraced, a sample.step span a token, and a
    sample.layers span only in the steps that ran the layers on the host
    (the first graphed step and its capture), none in a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from jukebox_tpu_torch.utils import profiler
    rt = _prior("single_enc_dec", "cuda")
    want, _ = _sample(rt, True, 0.0, monkeypatch)
    ar.reset_graph_counts()
    profiler.reset()
    try:
        with torch.profiler.profile():
            got, _ = _sample(rt, True, 0.0, monkeypatch)
        spans = profiler.traced()["spans"]
    finally:
        profiler.reset()
    assert torch.equal(got, want)
    steps = [s for s in spans if s.name == "sample.step"]
    assert len(steps) == got.shape[1]
    hosted = [s for s in steps if any(c.parent is s and c.name ==
                                      "sample.layers" for c in spans)]
    assert len(steps) - len(hosted) == ar.GRAPHS["replays"] > 0
