"""The port's html pages against jukebox_tpu's on the same inputs: the page
text and the down-sampled alignment JSON equal, and the alignment PNG the
port writes with zlib and struct decodes (with PIL, here only) to the
pixels of the JAX package's PIL image; also without an alignment and with
an empty one."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from jukebox_tpu import save_html as jhtml
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu_torch import save_html as thtml
from jukebox_tpu_torch.hparams import Hyperparams as THyperparams

N, T, SR = 2, 4000, 8000
LYRICS = ["oh la la,\nla la la", "the sea is calm tonight"]


def inputs(kind):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (N, T, 1)).astype(np.float32)
    labels = dict(info=[dict(artist="unknown", genre="unknown", lyrics=l,
                             full_tokens=list(range(len(l))))
                        for l in LYRICS])
    if kind == "none":
        return x, labels, None
    if kind == "empty":
        return x, labels, [np.zeros((0, len(l))) for l in LYRICS]
    # [T codes, chars] rows of a softmax, wider than the JSON's 512 x 256
    alignments = []
    for l in LYRICS:
        a = rng.exponential(size=(1100, len(l)))
        alignments.append(a / a.sum(axis=1, keepdims=True))
    return x, labels, alignments


@pytest.mark.parametrize("kind", ["alignment", "none", "empty"])
def test_save_html_matches_jax(tmp_path, kind):
    x, labels, alignments = inputs(kind)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jhtml.save_html(jd, x, None, labels, alignments, JHyperparams(sr=SR))
    thtml.save_html(td, x, None, labels, alignments, THyperparams(sr=SR))
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for item in range(N):
        with open(f"{td}/item_{item}.html") as f, \
                open(f"{jd}/item_{item}.html") as g:
            assert f.read() == g.read()
        png = f"item_{item}_align.png"
        assert os.path.exists(f"{td}/{png}") == (kind == "alignment")
        if kind == "none":
            continue
        with open(f"{td}/item_{item}_align.json") as f, \
                open(f"{jd}/item_{item}_align.json") as g:
            assert json.load(f) == json.load(g)
        if kind == "alignment":
            with Image.open(f"{td}/{png}") as t, Image.open(f"{jd}/{png}") as j:
                assert t.mode == j.mode == "L"
                got, want = np.asarray(t), np.asarray(j)
            assert got.shape == (len(LYRICS[item]), 1100)
            np.testing.assert_array_equal(got, want)
