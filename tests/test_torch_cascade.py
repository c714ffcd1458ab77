"""The PyTorch port's ancestral cascade against jukebox_tpu's on the CPU:
a tiny 3-level family (VQ-VAE, two upsamplers, an order-12 lyric top prior)
on the same weights, sampled at temp 0 (argmax) in fp32 (the JAX package's
sequential scheduler, the port's default). The codes at every level must be equal; the decoded audio of
each level agrees within 1e-4 (fp32 convs, summation order only); the port
writes data.jkb and one wav per sample under tmp_path."""

import os
import pickle
import wave

import numpy as np
import torch

from _torch_tiny import META, TOP, VQ, family
from jukebox_tpu import hparams as jhp
from jukebox_tpu import sample as jsample
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch import sample as tsample

torch.set_num_threads(1)


def test_ancestral_cascade_matches_jax(tmp_path):
    n = 2
    _, jpriors, _, tpriors = family()

    def hps(name, **kw):
        return dict(n_samples=n, sample_length=VQ["sample_length"],
                    sr=VQ["sr"], hop_fraction=(0.5, 0.5, 0.125), seed=0,
                    name=str(tmp_path / name), **kw)
    skw = [dict(temp=0.0, fp16=False, chunk_size=8, max_batch_size=n)
           for _ in tpriors]
    labels = [p.labeller.get_batch_labels([META] * n) for p in jpriors]
    jzs = jsample.ancestral_sample(
        labels, [dict(s) for s in skw], jpriors,
        jhp.Hyperparams(levels=3, n_tokens=TOP["n_tokens"],
                        pipeline_cascade=False, **hps("jax")))
    tzs = tsample.ancestral_sample(labels, [dict(s) for s in skw], tpriors,
                                   thp.Hyperparams(**hps("torch")))

    for level in range(3):
        want = VQ["sample_length"] // tpriors[level].raw_to_tokens
        assert tzs[level].shape == (n, want)
        np.testing.assert_array_equal(tzs[level], np.asarray(jzs[level]),
                                      err_msg=f"level {level}")
        with open(tmp_path / "jax" / f"level_{level}" / "data.jkb", "rb") as f:
            jx = pickle.load(f)["x"]
        d = tmp_path / "torch" / f"level_{level}"
        with open(d / "data.jkb", "rb") as f:
            tx = pickle.load(f)["x"]
        # the JAX side reads its audio back as 16-bit PCM (1/32767 steps)
        np.testing.assert_allclose(tx, jx, atol=1e-4 + 1 / 32767)
        for i in range(n):
            with wave.open(str(d / f"item_{i}.wav")) as w:
                assert (w.getnchannels(), w.getframerate(),
                        w.getnframes()) == (1, VQ["sr"], VQ["sample_length"])
    assert os.path.exists(tmp_path / "torch" / "level_0" / "item_1.wav")
