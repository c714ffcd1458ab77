"""STFT magnitudes and the spectral losses of VQ-VAE training in the
PyTorch port (counterpart of jukebox_tpu/ops/stft.py), through torch.stft
(cuFFT on the card).

The semantics are the JAX package's: a periodic Hann window of
`window_size`, computed in float64 and rounded to fp32, zero-padded and
centred in an `n_fft` frame; reflect padding of n_fft // 2 on both sides
(center=True); `hop_length` stride; the one-sided spectrum in the
[N, n_fft // 2 + 1, frames] layout, frames = 1 + T // hop_length; stereo
or mono [N, T, C] input averaged over its channels first.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class STFTParams:
    n_fft: int
    hop_length: int
    window_size: int


# the spectral loss's STFT (jukebox_tpu/ops/stft.py default_stft)
DEFAULT_STFT = STFTParams(n_fft=2048, hop_length=256, window_size=6 * 256)


def _hann_window(window_size, n_fft, device):
    n = np.arange(window_size)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / window_size))
    left = (n_fft - window_size) // 2
    padded = np.zeros(n_fft, dtype=np.float32)
    padded[left:left + window_size] = win
    return torch.from_numpy(padded).to(device)


def stft_mag(x, p: STFTParams):
    """|STFT(x)| of x [N, T]: fp32 [N, n_fft // 2 + 1, 1 + T // hop]."""
    x = x.float()
    window = _hann_window(p.window_size, p.n_fft, x.device)
    spec = torch.stft(x, p.n_fft, hop_length=p.hop_length, win_length=p.n_fft,
                      window=window, center=True, pad_mode="reflect",
                      onesided=True, return_complex=True)
    return spec.abs()


def _squeeze(x):
    """[N, T, C] with C in {1, 2} -> [N, T] by the channel mean."""
    if x.dim() == 3:
        if x.shape[-1] not in (1, 2):
            raise ValueError(f"expected 1 or 2 channels, got {x.shape}")
        x = x.mean(dim=-1)
    if x.dim() != 2:
        raise ValueError(f"Unknown input shape {tuple(x.shape)}")
    return x


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                dim=-1))


def _mags(x_in, x_out, p):
    return stft_mag(_squeeze(x_in), p), stft_mag(_squeeze(x_out), p)


def spectral_loss(x_in, x_out, hps):
    """Per-item L2 norm of the magnitude-spectrogram difference [N]."""
    spec_in, spec_out = _mags(x_in, x_out, DEFAULT_STFT)
    return _norm(spec_in - spec_out)


def multispectral_loss(x_in, x_out, hps):
    """Mean of the per-item spectral losses over the STFT bank of
    hps.multispec_loss_n_fft / _hop_length / _window_size [N]."""
    bank = (hps.multispec_loss_n_fft, hps.multispec_loss_hop_length,
            hps.multispec_loss_window_size)
    if not len(bank[0]) == len(bank[1]) == len(bank[2]):
        raise ValueError(f"multispec bank of unequal lengths {bank}")
    losses = []
    for n_fft, hop, win in zip(*bank):
        spec_in, spec_out = _mags(x_in, x_out, STFTParams(n_fft, hop, win))
        losses.append(_norm(spec_in - spec_out))
    return sum(losses) / len(losses)


def spectral_convergence(x_in, x_out, hps, epsilon=2e-3):
    """Residual norm over the target's norm, 0 where the target's norm is
    at most epsilon [N]."""
    spec_in, spec_out = _mags(x_in, x_out, DEFAULT_STFT)
    gt_norm = _norm(spec_in)
    residual_norm = _norm(spec_in - spec_out)
    mask = (gt_norm > epsilon).float()
    return (residual_norm * mask) / torch.clamp(gt_norm, min=epsilon)


def log_magnitude_loss(x_in, x_out, hps, epsilon=1e-4):
    spec_in, spec_out = _mags(x_in, x_out, DEFAULT_STFT)
    return torch.mean(torch.abs(torch.log(spec_in + epsilon)
                                - torch.log(spec_out + epsilon)))
