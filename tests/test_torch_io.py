"""The port's audio input (jukebox_tpu_torch/utils/io.py, wavio.py, avio.py
and the native readers it builds from its own csrc/wavio.cpp and
csrc/avio.cpp) against jukebox_tpu/utils/io.py on the CPU, on audio drawn
from a numpy seed and written to tmp_path.

* wav of every width the native reader reads (8, 16, 24 and 32-bit
  integer PCM, 32 and 64-bit IEEE float), stereo and mono, at 48 kHz,
  windows read at 22050 Hz (resample_poly): equal to JAX's io.load_audio
  within 1e-6.
* mp3, flac, ogg, opus, m4a and aac written by JAX's avio.encode: the
  port's windows equal JAX's (both decode through the same ffmpeg
  libraries), and as near to the encoded signal as tests/test_avio.py
  holds JAX's: mean |error| per codec, the aac (ADTS) window within 600
  samples of its place. These cases skip only where the port's avio is
  unavailable (no ffmpeg libraries).
* durations and their `.dur` sidecars; the dataset over compressed audio
  (a wav, an mp3 and a flac) equal to JAX's windows; a file no decoder can
  read raises and names the file; the port loads its own libraries from
  build/, never the JAX package's shared objects.
"""

import ctypes.util
import wave

import numpy as np
import pytest
from scipy.io import wavfile

from jukebox_tpu.data import files_dataset as jfd
from jukebox_tpu.hparams import Hyperparams as JHyperparams
from jukebox_tpu.utils import avio as javio
from jukebox_tpu.utils import io as jio
from jukebox_tpu_torch.data import files_dataset as tfd
from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.ops import _build
from jukebox_tpu_torch.utils import avio, io, wavio

needs_avio = pytest.mark.skipif(
    not avio.available(), reason="the ffmpeg libraries are not installed")
WAV_SR, SR = 48000, 22050


def _noise(sr, seconds=3, channels=2, seed=7):
    """Smoothed noise (unambiguous for alignment, survives lossy codecs)."""
    rs = np.random.RandomState(seed)
    sig = rs.randn(channels, int(sr * seconds)).astype(np.float32)
    k = np.hanning(33).astype(np.float32)
    k /= k.sum()
    sig = np.stack([np.convolve(c, k, "same") for c in sig])
    return (sig * (0.5 / np.abs(sig).max())).astype(np.float32)


def _write_wav(path, sig, sr, kind):
    """sig [C, T] in [-1, 1] as a wav of `kind`."""
    x = sig.T
    if kind == "int24":
        pcm = np.clip(np.round(x * 8388607), -8388608, 8388607).astype("<i4")
        raw = np.ascontiguousarray(pcm).view(np.uint8).reshape(-1, 4)[:, :3]
        with wave.open(str(path), "wb") as w:
            w.setnchannels(sig.shape[0])
            w.setsampwidth(3)
            w.setframerate(sr)
            w.writeframes(raw.tobytes())
        return
    conv = {"uint8": lambda a: np.round(a * 127 + 128).astype(np.uint8),
            "int16": lambda a: np.round(a * 32767).astype(np.int16),
            "int32": lambda a: np.round(a * 2147483647.0).astype(np.int32),
            "float32": lambda a: a.astype(np.float32),
            "float64": lambda a: a.astype(np.float64)}[kind]
    wavfile.write(str(path), sr, conv(x[:, 0] if sig.shape[0] == 1 else x))


@pytest.mark.parametrize("kind", ["uint8", "int16", "int24", "int32",
                                  "float32", "float64"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_resampled_matches_jax(tmp_path, kind, channels):
    sig = _noise(WAV_SR, seconds=1.5, channels=channels)
    path = str(tmp_path / f"a_{kind}.wav")
    _write_wav(path, sig, WAV_SR, kind)
    info = wavio.probe(path)
    assert info["sample_rate"] == WAV_SR and info["channels"] == channels
    assert info["format"] == (3 if kind.startswith("float") else 1)
    assert io.get_duration_sec(path) == jio.get_duration_sec(path) == 1.5
    for offset, n in ((0, 4096), (5000, 10000), (SR + 777, 20000)):
        out, sr = io.load_audio(path, sr=SR, offset=offset, duration=n)
        ref, _ = jio.load_audio(path, sr=SR, offset=offset, duration=n)
        assert sr == SR and out.shape == (2, n) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        if channels == 1:
            np.testing.assert_array_equal(out[0], out[1])
    # past the end: zeros, as JAX's
    out, _ = io.load_audio(path, sr=SR, offset=SR, duration=SR)
    ref, _ = jio.load_audio(path, sr=SR, offset=SR, duration=SR)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert not out[:, -1000:].any()


def test_wav_at_the_rate_reads_exactly(tmp_path):
    sig = _noise(SR, seconds=1.0)
    path = str(tmp_path / "f.wav")
    _write_wav(path, sig, SR, "float32")
    out, _ = io.load_audio(path, sr=SR, offset=123, duration=4000)
    np.testing.assert_array_equal(out, sig[:, 123:4123])


def test_wave_fallback_matches_native(tmp_path, monkeypatch):
    """Without the native reader integer PCM goes through `wave`, with the
    same values."""
    sig = _noise(WAV_SR, seconds=1.0)
    path = str(tmp_path / "i.wav")
    _write_wav(path, sig, WAV_SR, "int16")
    native, _ = io.load_audio(path, sr=SR, offset=300, duration=5000)
    monkeypatch.setattr(wavio, "probe", lambda p: None)
    assert io.get_duration_sec(path) == 1.0
    plain, _ = io.load_audio(path, sr=SR, offset=300, duration=5000)
    np.testing.assert_array_equal(plain, native)


# -- compressed formats -------------------------------------------------------

# codec: (file rate, mean |error| against the signal, as tests/test_avio.py)
CODECS = {"mp3": (SR, 0.03), "ogg": (SR, 0.01), "flac": (SR, 1e-4),
          "opus": (48000, 0.015), "m4a": (44100, 0.015), "aac": (44100, None)}


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    if not avio.available():
        pytest.skip("the ffmpeg libraries are not installed")
    d = tmp_path_factory.mktemp("codecs")
    out = {}
    for ext, (sr, _) in CODECS.items():
        sig = _noise(sr)
        path = str(d / f"fix.{ext}")
        assert javio.encode(path, sig, sr), ext
        out[ext] = (path, sig, sr)
    return out


@needs_avio
@pytest.mark.parametrize("ext", list(CODECS))
def test_compressed_windows(encoded, ext):
    path, sig, sr = encoded[ext]
    info = avio.probe(path)
    assert info == javio.probe(path)
    assert info["sample_rate"] == sr and info["channels"] == 2
    assert io.get_duration_sec(path) == jio.get_duration_sec(path)
    for offset in (0, 4096, sr, 2 * sr + 123):
        out, _ = io.load_audio(path, sr=sr, offset=offset, duration=4096)
        ref, _ = jio.load_audio(path, sr=sr, offset=offset, duration=4096)
        np.testing.assert_array_equal(out, ref)
        tol = CODECS[ext][1]
        if tol is not None:
            # m4a's first frame carries the encoder's convergence error
            tol = 0.03 if ext == "m4a" and offset == 0 else tol
            err = float(np.abs(out - sig[:, offset:offset + 4096]).mean())
            assert err < tol, (ext, offset, err)
    # resampled as it decodes, to another rate: equal to JAX's
    out, _ = io.load_audio(path, sr=16000, offset=8000, duration=8000)
    ref, _ = jio.load_audio(path, sr=16000, offset=8000, duration=8000)
    np.testing.assert_array_equal(out, ref)


@needs_avio
def test_aac_window_approximate(encoded):
    """ADTS has no priming data and seeks by estimated bitrate: the window
    lies within 600 samples of its place (tests/test_avio.py)."""
    path, sig, sr = encoded["aac"]
    win, _ = io.load_audio(path, sr=sr, offset=sr, duration=4096)
    pad = 1024
    ref = sig[0, sr - pad:sr + 4096 + pad]
    c = np.correlate(ref, win[0], "valid")
    lag = int(np.argmax(np.abs(c))) - pad
    assert abs(lag) < 600
    aligned = sig[0, sr + lag:sr + lag + 4096]
    assert float(np.abs(win[0] - aligned).mean()) < 0.05


@needs_avio
def test_duration_sidecars(encoded, tmp_path):
    path, _, _ = encoded["flac"]
    copy = str(tmp_path / "s.flac")
    with open(path, "rb") as f, open(copy, "wb") as g:
        g.write(f.read())
    dur = io.get_duration_sec(copy, cache=True)
    assert abs(dur - 3.0) < 0.1
    with open(copy + ".dur") as f:
        assert float(f.read()) == dur
    with open(copy + ".dur", "w") as f:  # the sidecar is what both read
        f.write("12.5\n")
    assert io.get_duration_sec(copy) == jio.get_duration_sec(copy) == 12.5


@needs_avio
def test_dataset_over_compressed_audio_matches_jax(encoded, tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    for ext in ("mp3", "flac"):
        path, sig, sr = encoded[ext]
        with open(path, "rb") as f, open(d / f"a.{ext}", "wb") as g:
            g.write(f.read())
    _write_wav(d / "b.wav", _noise(WAV_SR, seconds=2.0, seed=3), WAV_SR,
               "int16")
    kw = dict(sr=SR, channels=2, sample_length=8192, min_duration=None,
              max_duration=None, aug_shift=True, labels=False, seed=1,
              audio_files_dir=str(d))
    td = tfd.FilesAudioDataset(Hyperparams(**kw))
    jd = jfd.FilesAudioDataset(JHyperparams(**kw))
    assert td.files == jd.files and len(td.files) == 3
    assert td.durations == jd.durations and len(td) == len(jd) >= 12
    for epoch in range(2):
        td.set_epoch(epoch)
        jd.set_epoch(epoch)
        for item in range(len(td)):
            np.testing.assert_allclose(td[item], jd[item], rtol=0, atol=1e-6)


def test_unreadable_files_raise_and_name_the_file(tmp_path, monkeypatch):
    bad = str(tmp_path / "junk.mp3")
    with open(bad, "wb") as f:
        f.write(b"\xff" * 2048)
    if avio.available():
        with pytest.raises(RuntimeError, match="junk.mp3"):
            io.load_audio(bad, sr=SR, offset=0, duration=1024)
    # no decoder on the machine: no native library, no PyAV, no ffmpeg
    monkeypatch.setattr(avio, "available", lambda: False)
    monkeypatch.setattr(io, "_have_av", lambda: False)
    monkeypatch.setattr(io.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cannot decode .*junk.mp3"):
        io.load_audio(bad, sr=SR, offset=0, duration=1024)
    with pytest.raises(RuntimeError, match="cannot probe .*junk.mp3"):
        io.get_duration_sec(bad)


def test_libraries_are_the_ports_own():
    assert wavio.available()
    wav_lib = wavio._load_lib()._name
    assert wav_lib.startswith(str(_build.BUILD_DIR)) and "libwavio_" in wav_lib
    if avio.available():  # only where the ffmpeg libraries are installed
        assert all(ctypes.util.find_library(n) for n in avio.LIBS)
        assert avio._load_lib()._name.startswith(str(_build.BUILD_DIR))


def test_load_prompts_read_any_rate_and_format(tmp_path, encoded):
    """The primed mode's prompts: a wav at the rate and a float32 wav at
    48 kHz equal JAX's load_prompts (which resamples the whole file and
    averages every channel) within 1e-7, the resampled window's last
    samples included; an mp3 equals the channel mean of JAX's io.load_audio
    window, which JAX's prompt loader reads for a compressed file where
    PyAV is installed (the port needs only its own ffmpeg-library reader)."""
    from jukebox_tpu import sample as jsample
    from jukebox_tpu.hparams import Hyperparams as JH
    from jukebox_tpu_torch import sample as tsample
    hps, jhps = Hyperparams(sr=SR, n_samples=3), JH(sr=SR, n_samples=3)
    same = str(tmp_path / "same.wav")
    _write_wav(same, _noise(SR, seconds=1.0), SR, "int16")
    other = str(tmp_path / "other.wav")
    _write_wav(other, _noise(WAV_SR, seconds=1.0), WAV_SR, "float32")
    for path in (same, other):
        out = tsample.load_prompts([path], 5000, hps).numpy()
        ref = np.asarray(jsample.load_prompts([path], 5000, jhps))
        assert out.shape == (3, 5000, 1)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)
    mp3 = encoded["mp3"][0]
    out = tsample.load_prompts([mp3, other], 5000, hps).numpy()
    ref, _ = jio.load_audio(mp3, sr=SR, offset=0, duration=5000)
    np.testing.assert_allclose(out[0, :, 0], ref.mean(axis=0), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(out[2], out[0])


@pytest.mark.parametrize("file_sr,channels,seconds,kind", [
    (48000, 2, 1.0, "int16"), (44100, 4, 1.0, "float32"),
    (8000, 1, 1.0, "int32"), (96000, 3, 0.3, "int16"),
    (16000, 2, 0.2, "float32")])
def test_load_prompts_wav_equal_jax(tmp_path, file_sr, channels, seconds,
                                    kind):
    """A wav prompt at another rate, of one to four channels, equals JAX's
    load_prompts within 1e-7: the port resamples only the frames the
    window and the filter's reach need, JAX the whole file, and the
    window's tail (inside the filter's edge) still agrees; every channel
    enters the mean. The shorter files end inside the window (zeros after
    the resampled end, as JAX pads)."""
    from jukebox_tpu import sample as jsample
    from jukebox_tpu.hparams import Hyperparams as JH
    from jukebox_tpu_torch import sample as tsample
    path = str(tmp_path / f"p_{file_sr}_{channels}.wav")
    _write_wav(path, _noise(file_sr, seconds=seconds, channels=channels),
               file_sr, kind)
    n = 7000
    out = tsample.load_prompts([path], n, Hyperparams(sr=SR, n_samples=1))
    ref = jsample.load_prompts([path], n, JH(sr=SR, n_samples=1))
    assert out.shape == (1, n, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)

