"""The port's STFT and spectral losses (jukebox_tpu_torch/ops/stft.py)
against jukebox_tpu/ops/stft.py on the CPU, on audio drawn from a numpy
seed: magnitudes at the spectral loss's STFT and at each STFT of the
multispectral bank, and the four losses on mono and stereo batches, within
rtol 1e-5 (both fp32 FFTs of the same frames; the roundings differ, the
windows are equal: float64 Hann rounded once to fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.hparams import setup_hparams as jsetup
from jukebox_tpu.ops import stft as jstft
from jukebox_tpu_torch.hparams import setup_hparams
from jukebox_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)
RTOL = 1e-5
HPS = setup_hparams("teeny", {})
BANK = [(2048, 256, 1536)] + list(zip(HPS.multispec_loss_n_fft,
                                      HPS.multispec_loss_hop_length,
                                      HPS.multispec_loss_window_size))


def _audio(seed, shape):
    rs = np.random.RandomState(seed)
    t = np.arange(shape[1]) / 8000.0
    tone = 0.3 * np.sin(2 * np.pi * rs.uniform(100, 900) * t)
    x = tone[None, :, None] + 0.2 * rs.standard_normal(shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win", BANK)
def test_stft_mag(n_fft, hop, win):
    x = _audio(0, (3, 4096, 1))[..., 0]
    ref = np.asarray(jstft.stft_mag(jnp.asarray(x),
                                    jstft.STFTParams(n_fft, hop, win)))
    out = tstft.stft_mag(torch.from_numpy(x),
                         tstft.STFTParams(n_fft, hop, win)).numpy()
    assert out.shape == ref.shape == (3, n_fft // 2 + 1, 1 + 4096 // hop)
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("loss", ["spectral_loss", "multispectral_loss",
                                  "spectral_convergence",
                                  "log_magnitude_loss"])
@pytest.mark.parametrize("channels", [1, 2])
def test_losses(loss, channels):
    a, b = _audio(1, (2, 4096, channels)), _audio(2, (2, 4096, channels))
    ref = np.asarray(getattr(jstft, loss)(jnp.asarray(a), jnp.asarray(b),
                                          jsetup("teeny", {})))
    out = getattr(tstft, loss)(torch.from_numpy(a), torch.from_numpy(b),
                               HPS).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_spectral_convergence_masks_silence():
    x = np.zeros((2, 4096, 1), np.float32)
    x[1] = _audio(3, (1, 4096, 1))[0]
    y = _audio(4, (2, 4096, 1))
    out = tstft.spectral_convergence(torch.from_numpy(x),
                                     torch.from_numpy(y), HPS).numpy()
    ref = np.asarray(jstft.spectral_convergence(jnp.asarray(x), jnp.asarray(y),
                                                jsetup("teeny", {})))
    assert out[0] == ref[0] == 0.0
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_rejects_more_channels():
    with pytest.raises(ValueError):
        tstft.spectral_loss(torch.zeros(1, 4096, 3), torch.zeros(1, 4096, 3),
                            HPS)
