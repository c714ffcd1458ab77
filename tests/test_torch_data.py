"""The port's dataset, loader and audio helpers (jukebox_tpu_torch/data,
utils/audio_utils.py) against jukebox_tpu's on the same wav files written
to tmp_path (and a flac beside a wav). The port finds and reads the files
JAX's dataset finds. Host-side integer and numpy float64 arithmetic on both
sides: item windows, chunks, labels, loader batches and the bandwidth
statistics must be equal (bandwidth to 1e-12 relative: the same float64
sums). aug_shift draws from the same (seed, epoch, item) streams, so the
windows agree for every epoch."""

import threading
import wave

import numpy as np
import pytest
import torch

from jukebox_tpu.data import data_processor as jdp
from jukebox_tpu.data import files_dataset as jfd
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu.utils import audio_utils as jau
from jukebox_tpu_torch.data import data_processor as tdp
from jukebox_tpu_torch.data import files_dataset as tfd
from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.utils import audio_utils as tau

SR = 4000
META = ("unknown", "unknown", "the quick brown fox jumps over the lazy dog")
HPS = dict(sr=SR, channels=2, sample_length=1024, min_duration=None,
           max_duration=None, aug_shift=True, labels=True, seed=3,
           max_bow_genre_size=1, n_tokens=16, labels_v3=True, bs=2,
           nworkers=2, train_test_split=0.8, prior=False, aug_blend=False)


def _write_wavs(dirpath, seconds=(2.0, 3.3, 1.7)):
    rs = np.random.RandomState(0)
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * SR)) / SR
        sig = 0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        pcm = np.stack([sig, 0.5 * sig + 0.01 * rs.randn(len(t))], axis=1)
        with wave.open(str(dirpath / f"f{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((pcm * 32767).astype("<i2").tobytes())


class _JLabelled(jfd.FilesAudioDataset):
    def get_metadata(self, filename, test):
        return META


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    _write_wavs(d)
    return d


def test_dataset_windows_chunks_labels(wav_dir):
    kw = dict(HPS, audio_files_dir=str(wav_dir))
    jd = _JLabelled(JHyperparams(**kw))
    td = tfd.FixedMetadataDataset(Hyperparams(**kw), *META)
    assert len(td) == len(jd) >= 6 and td.files == jd.files
    for epoch in range(3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for item in range(len(td)):
            assert td.get_index_offset(item) == jd.get_index_offset(item)
            (tx, ty), (jx, jy) = td[item], jd[item]
            assert tx.dtype == np.float32 and tx.shape == (1024, 2)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_reads_wav_beside_flac_as_jax(tmp_path):
    """A flac beside a wav: both packages' datasets list and read the same
    files, with equal windows; a file that no decoder reads (a flac that is
    not one) raises and names the file."""
    _write_wavs(tmp_path, seconds=(2.0,))
    from jukebox_tpu.utils import avio as javio
    if not javio.available():
        pytest.skip("the ffmpeg libraries are not installed")
    t = np.arange(int(2.5 * SR)) / SR
    sig = np.stack([0.4 * np.sin(2 * np.pi * 330 * t),
                    0.3 * np.sin(2 * np.pi * 550 * t)]).astype(np.float32)
    flac = tmp_path / "sub" / "song.FLAC"
    flac.parent.mkdir()
    assert javio.encode(str(flac.with_suffix(".flac")), sig, SR)
    flac.with_suffix(".flac").rename(flac)
    assert jfd.find_files(str(tmp_path)) == [str(tmp_path / "f0.wav"),
                                             str(flac)]
    assert tfd.find_files(str(tmp_path)) == jfd.find_files(str(tmp_path))
    kw = dict(HPS, audio_files_dir=str(tmp_path), labels=False)
    jd = jfd.FilesAudioDataset(JHyperparams(**kw))
    td = tfd.FilesAudioDataset(Hyperparams(**kw))
    assert td.files == jd.files and td.durations == jd.durations
    assert len(td) == len(jd) >= 4
    for item in range(len(td)):
        assert td.get_index_offset(item) == jd.get_index_offset(item)
        np.testing.assert_array_equal(td[item], jd[item])
    bad = tmp_path / "sub" / "broken.flac"
    bad.write_bytes(b"fLaC")
    with pytest.raises(Exception, match="broken.flac"):
        tfd.FilesAudioDataset(Hyperparams(**kw))


def test_wav_only_directory_matches_jax(wav_dir):
    kw = dict(HPS, audio_files_dir=str(wav_dir), labels=False)
    jd = jfd.FilesAudioDataset(JHyperparams(**kw))
    td = tfd.FilesAudioDataset(Hyperparams(**kw))
    assert td.files == jd.files == jfd.find_files(str(wav_dir))
    assert len(td.files) == 3 and len(td) == len(jd)


def test_unlabelled_base_fails_on_labels(wav_dir):
    td = tfd.FilesAudioDataset(Hyperparams(**dict(
        HPS, audio_files_dir=str(wav_dir))))
    with pytest.raises(AttributeError):  # Labeller on artist None
        td[0]


def test_bandwidth(wav_dir):
    kw = dict(HPS, audio_files_dir=str(wav_dir), labels=False)
    jd = jfd.FilesAudioDataset(JHyperparams(**kw))
    td = tfd.FilesAudioDataset(Hyperparams(**kw))
    for duration in (1, 600):
        ref = jau.calculate_bandwidth(jd, JHyperparams(**kw), duration)
        out = tau.calculate_bandwidth(td, Hyperparams(**kw), duration)
        assert out.keys() == ref.keys()
        for k in ref:
            assert out[k] == pytest.approx(ref[k], rel=1e-12)


def test_loader_batches(wav_dir):
    kw = dict(HPS, audio_files_dir=str(wav_dir), labels=False)
    jproc = jdp.DataProcessor(JHyperparams(**kw))
    tproc = tdp.DataProcessor(Hyperparams(**kw))
    threads = set(threading.enumerate())
    for epoch in range(2):
        jproc.set_epoch(epoch)
        tproc.set_epoch(epoch)
        jb, tb = list(jproc.train_loader), list(tproc.train_loader)
        assert len(tb) == len(jb) == len(tproc.train_loader) > 0
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
    it = iter(tproc.train_loader)
    next(it)
    it.close()  # an abandoned iteration shuts its pool down
    assert not [t for t in set(threading.enumerate()) - threads
                if t.is_alive()]


@pytest.mark.parametrize("channels", [1, 2])
def test_audio_preprocess(channels):
    x = np.random.RandomState(channels).uniform(
        -1, 1, (3, 50, channels)).astype(np.float32)
    hps = Hyperparams(aug_blend=False)
    ref = np.asarray(jau.audio_preprocess(x, JHyperparams(aug_blend=False)))
    out = tau.audio_preprocess(torch.from_numpy(x), hps)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-7)
    blend = tau.audio_preprocess(torch.from_numpy(x), Hyperparams(
        aug_blend=True), gen=torch.Generator().manual_seed(0))
    assert blend.shape == (3, 50, 1)
    if channels == 2:
        lo = np.minimum(x[..., 0], x[..., 1])[..., None]
        hi = np.maximum(x[..., 0], x[..., 1])[..., None]
        assert (blend.numpy() >= lo - 1e-6).all()
        assert (blend.numpy() <= hi + 1e-6).all()
