"""Host-side audio helpers of the PyTorch port (counterpart of
jukebox_tpu/utils/audio_utils.py): the dataset bandwidth statistics,
channel preprocessing, resampling and writing wav files. Reading audio is
utils/io.py's.
"""

import math
import os
import wave

import numpy as np
import torch


def _np_stft_mag(x, n_fft, hop_length, win_length):
    """Magnitude STFT of a 1-D numpy signal with center=True reflect padding
    and a periodic Hann window."""
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    left = (n_fft - win_length) // 2
    window = np.zeros(n_fft)
    window[left:left + win_length] = win
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = x[idx] * window
    return np.abs(np.fft.rfft(frames, axis=-1)).T


def calculate_bandwidth(dataset, hps, duration=600):
    """Mean / L1 / L2 / spectral-norm statistics over ~`duration` seconds of
    every 16th item of the dataset (audio_utils.py:22-56); they normalise
    the VQ-VAE's reconstruction losses."""
    n_fft, hop_length, window_size = 2048, 256, 6 * 256
    n_samples = int(dataset.sr * duration)
    l1, total, total_sq, n_seen, idx = 0.0, 0.0, 0.0, 0.0, 0
    spec_norm_total, spec_nelem = 0.0, 0.0
    while n_seen < n_samples and idx < len(dataset):
        x = dataset[idx]
        if isinstance(x, (tuple, list)):
            x, _ = x
        samples = np.asarray(x, dtype=np.float64)
        mag = _np_stft_mag(np.mean(samples, axis=1), n_fft, hop_length,
                           window_size)
        spec_norm_total += np.linalg.norm(mag)
        spec_nelem += 1
        n_seen += int(np.prod(samples.shape))
        l1 += np.sum(np.abs(samples))
        total += np.sum(samples)
        total_sq += np.sum(samples ** 2)
        idx += 16
    mean = total / n_seen
    return dict(l2=total_sq / n_seen - mean ** 2, l1=l1 / n_seen,
                spec=spec_norm_total / spec_nelem)


def audio_preprocess(x, hps, gen=None):
    """Audio [N, T, C] -> fp32 [N, T, 1] on x's device: stereo blended to
    mono, with a random per-item blend under hps.aug_blend when a
    torch.Generator is given (audio_utils.py:58-77)."""
    x = torch.as_tensor(x).float()
    if x.shape[-1] == 2:
        if hps.get("aug_blend", False) and gen is not None:
            mix = torch.rand((x.shape[0], 1), generator=gen,
                             device=gen.device).to(x.device)
        else:
            mix = 0.5
        x = mix * x[:, :, 0] + (1 - mix) * x[:, :, 1]
    elif x.shape[-1] == 1:
        x = x[:, :, 0]
    else:
        raise ValueError(f"Got unknown {x.shape[-1]} channels")
    return x[:, :, None]


def resample(x, from_sr, to_sr):
    """x [C, T] from rate from_sr to to_sr by scipy's polyphase
    resample_poly (jukebox_tpu/utils/audio_utils.py _resample), fp32."""
    from scipy.signal import resample_poly
    g = math.gcd(int(from_sr), int(to_sr))
    return resample_poly(x, int(to_sr) // g, int(from_sr) // g,
                         axis=-1).astype(np.float32)


def resample_reach(from_sr, to_sr):
    """Input frames past an output sample's place that resample reads for
    it: resample_poly's filter half-length, 10 * max(up, down) taps at the
    upsampled rate, in input frames, plus one."""
    g = math.gcd(int(from_sr), int(to_sr))
    up, down = int(to_sr) // g, int(from_sr) // g
    return -(-10 * max(up, down) // up) + 1


def save_wav(fname, aud, sr):
    """Write each batch item of aud [N, T, C] in [-1, 1] as 16-bit PCM
    {fname}/item_{i}.wav (jukebox_tpu/utils/audio_utils.py save_wav)."""
    aud = np.clip(np.asarray(aud, dtype=np.float32), -1, 1)
    os.makedirs(fname, exist_ok=True)
    for i in range(aud.shape[0]):
        pcm = (aud[i] * 32767).astype("<i2")
        with wave.open(os.path.join(fname, f"item_{i}.wav"), "wb") as w:
            w.setnchannels(pcm.shape[1])
            w.setsampwidth(2)
            w.setframerate(int(sr))
            w.writeframes(pcm.tobytes())
