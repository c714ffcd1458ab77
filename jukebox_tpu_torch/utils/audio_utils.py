"""Host-side audio helpers of the PyTorch port (counterpart of
jukebox_tpu/utils/audio_utils.py and the wav path of jukebox_tpu/utils/io.py):
the dataset bandwidth statistics, channel preprocessing, and wav IO through
the stdlib `wave` module and numpy (no scipy, no C extension).
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


def get_duration_sec(file):
    """Duration of a wav file in seconds, from its header."""
    with wave.open(file, "rb") as w:
        return w.getnframes() / w.getframerate()


def load_audio(file, sr, offset, duration, mono=False):
    """`duration` samples of a wav file at `offset` (both in samples at sr),
    as float32 [2, duration] (mono duplicated to stereo, zero-padded past
    the end), and sr (utils/io.py load_audio); with mono=True the mean of
    the file's channels, [1, duration] (the prompt read of
    jukebox_tpu/utils/audio_utils.py load_audio). The file must be at sr:
    the port does not resample."""
    offset, duration = int(offset), int(duration)
    with wave.open(file, "rb") as w:
        file_sr, n_channels = w.getframerate(), w.getnchannels()
        width = w.getsampwidth()
        if file_sr != sr:
            raise ValueError(f"{file} is at {file_sr} Hz, not {sr}: "
                             f"resampling is not ported")
        start = min(offset, w.getnframes())
        n = min(int(math.ceil(duration)), w.getnframes() - start)
        w.setpos(start)
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {width} in {file}")
    sig = data.reshape(-1, n_channels).T
    if sig.shape[1] < duration:
        sig = np.pad(sig, ((0, 0), (0, duration - sig.shape[1])))
    if mono:
        return np.mean(sig, axis=0, keepdims=True), sr
    if sig.shape[0] == 1:
        sig = np.concatenate([sig, sig], axis=0)
    return sig[:2], sr


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
