"""The port's span and counter recorder (jukebox_tpu_torch/utils/profiler.py)
on the CPU: fine spans and counters off while torch.profiler is not recording
(no record kept, no record_function entered), and the flag that says so
following torch.profiler; a span in the exported Chrome trace as a
user_annotation on the recorder's clock; and the spans the program records
where it works: a traced sample_segment's steps with their layers and
token sampler, sample_init's parts with the prefill's token-by-token tail.
This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
from jukebox_tpu_torch.utils import profiler

torch.set_num_threads(1)
META = dict(artist="unknown", genre="unknown", lyrics="la la la la la",
            total_length=8000 * 30, offset=0)
# a single-enc-dec top: 8 lyric tokens, then 24 codes; blocks of 8
TOP = dict(sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
           emb_width=16, l_bins=32, l_mu=0.99, commit=0.02, width=8, depth=1,
           m_conv=1.0, dilation_growth_rate=1, sr=8000, level=2, n_ctx=24,
           prior_width=16, prior_depth=3, heads=2, blocks=4, attn_order=12,
           init_scale=0.7, min_duration=0.0, max_duration=600.0, labels=True,
           labels_v3=True, y_bins=(604, 7898), t_bins=16,
           max_bow_genre_size=1, n_vocab=79, use_tokens=True, n_tokens=8,
           single_enc_dec=True)


@pytest.fixture(autouse=True)
def fresh():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture(scope="module")
def top():
    hps = thp.setup_hparams("teeny", dict(TOP))
    rt = make_prior(hps, make_vqvae(hps, "cpu"), "cpu")
    m = rt.model
    y = torch.from_numpy(m.get_y(m.labeller.get_batch_labels([META] * 2),
                                 0))
    z = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 9)))
    return m, y, z


def test_the_flag_follows_torch_profiler():
    assert not profiler.tracing()
    with torch.profiler.profile():
        assert profiler.tracing()
    assert not profiler.tracing()


def test_fine_spans_and_counters_are_off_without_the_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert profiler.fine_start() == 0
    with profiler.fine("fine") as sp:
        assert sp is None
    profiler.add("launch_host.k", 100)
    with profiler.span("coarse") as sp:
        assert sp.parent is None
    assert profiler.traced() == dict(spans=[], counters={})
    assert entered == []
    assert list(profiler.totals()) == ["coarse"]


def test_a_span_is_a_user_annotation_on_the_recorders_clock(tmp_path):
    with torch.profiler.profile() as prof:
        with profiler.span("outer", k=1) as outer:
            with profiler.fine("inner") as inner:
                torch.ones(4).sum()
            profiler.add("launch_host.k", 7, n=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base_us = float(data.get("baseTimeNanoseconds", 0)) / 1e3
    ann = {e["name"]: e for e in data["traceEvents"]
           if e.get("cat") == "user_annotation"}
    for sp in (outer, inner):
        assert abs(float(ann[sp.name]["ts"]) + base_us
                   - sp.start_ns / 1e3) < 1e3  # within 1 ms
    rec = profiler.traced()
    assert [s.name for s in rec["spans"]] == ["outer", "inner"]
    assert inner.parent is outer and outer.attrs == dict(k=1)
    assert rec["counters"] == {"launch_host.k": dict(calls=2, ns=7)}
    assert profiler.totals()["outer"]["calls"] == 1
    assert "inner" not in profiler.totals()  # fine spans keep no totals


def test_a_traced_segment_records_each_step(top):
    m, y, z = top
    caches, x_tok, x_cond, y_cond = m.sample_init(2, z=z, y=y, chunk_size=8)
    t0, n = m.sample_prefix_len(z), 5
    gen = torch.Generator().manual_seed(0)
    with torch.profiler.profile():
        m.sample_segment(caches, x_tok, t0, n, gen, x_cond, y_cond)
    spans = profiler.traced()["spans"]
    seg, = [s for s in spans if s.name == "sample.segment"]
    assert seg.attrs == dict(rows=2, steps=n, t0=t0)
    steps = [s for s in spans if s.name == "sample.step"]
    assert len(steps) == n and all(s.parent is seg for s in steps)
    for st in steps:
        kids = sorted(s.name for s in spans if s.parent is st)
        assert kids == ["sample.layers", "sample.tok"]
        assert st.start_ns <= min(s.start_ns for s in spans
                                  if s.parent is st)
        assert st.end_ns >= max(s.end_ns for s in spans if s.parent is st)
    # the segment's totals count the loop's progress
    assert profiler.totals()["sample.segment"]["calls"] == 1


def test_sample_init_records_the_prefill_and_its_tail(top):
    m, y, z = top
    with torch.profiler.profile():
        m.sample_init(2, z=z, y=y, chunk_size=8)
    tot = profiler.totals()
    for name in ("sample.init", "sample.cond", "sample.caches",
                 "sample.prefill", "sample.prefill_tail"):
        assert tot[name]["calls"] == 1, name
    by = {s.name: s for s in profiler.traced()["spans"]}
    # 8 lyric tokens + 9 codes: two chunks of 8, then 1 token by itself
    assert by["sample.prefill"].attrs == dict(tokens=17)
    assert by["sample.prefill_tail"].attrs == dict(tokens=1)
    assert by["sample.prefill_tail"].parent is by["sample.prefill"]
    for name in ("sample.cond", "sample.caches", "sample.prefill"):
        assert by[name].parent is by["sample.init"]
    assert "sample.encoder" not in tot  # one stream: no lyric encoder
