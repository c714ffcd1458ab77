"""Audio files of the PyTorch port (counterpart of jukebox_tpu/utils/io.py):
a window of samples at a given rate from any of the dataset's formats, and
a file's duration, cached in a `.dur` sidecar.

wav goes through the native reader (utils/wavio.py: integer PCM of 8 to 32
bits and IEEE float), else the stdlib `wave` module; the window is read at
the file's rate and resampled to the target rate with scipy's
resample_poly. Other formats (mp3, opus, m4a, aac, ogg, flac) are decoded
in the JAX package's order: the native ffmpeg-library reader
(utils/avio.py, which resamples as it decodes), else PyAV, else the
`ffmpeg` command. Where none of them exists, reading such a file raises
and names it.
"""

import math
import shutil
import subprocess
import wave

import numpy as np

from jukebox_tpu_torch.utils import audio_utils, avio, wavio


def _have_av():
    try:
        import av
        return hasattr(av, "open")  # a stub module is no decoder
    except ImportError:
        return False


def get_duration_sec(file, cache=False):
    """The file's duration in seconds, from its `.dur` sidecar when there
    is one; with cache, a probed duration is written to the sidecar."""
    try:
        with open(file + ".dur", "r") as f:
            return float(f.readline().strip("\n"))
    except FileNotFoundError:
        duration = _probe_duration(file)
        if cache:
            with open(file + ".dur", "w") as f:
                f.write(str(duration) + "\n")
        return duration


def _probe_duration(file):
    if file.lower().endswith(".wav"):
        info = wavio.probe(file)
        if info is not None:
            return info["n_frames"] / info["sample_rate"]
        with wave.open(file, "rb") as w:
            return w.getnframes() / w.getframerate()
    if avio.available():
        info = avio.probe(file)
        if info is not None and info["duration_sec"] > 0:
            return info["duration_sec"]
    if _have_av():
        import av
        container = av.open(file)
        return container.streams.audio[0].duration * float(
            container.streams.audio[0].time_base)
    ffprobe = shutil.which("ffprobe")
    if ffprobe:
        out = subprocess.run(
            [ffprobe, "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", file],
            capture_output=True, check=True)
        return float(out.stdout.strip())
    raise RuntimeError(
        f"cannot probe {file}: decoding it needs the ffmpeg libraries "
        f"(libavformat, libavcodec, libavutil, libswresample), the `av` "
        f"package or an `ffprobe` binary on PATH")


def load_audio(file, sr, offset, duration):
    """`duration` samples at `offset` (both in samples at sr) as float32
    [2, duration] (a mono file repeated, zeros past the end), and sr."""
    offset, duration = int(offset), int(duration)
    if file.lower().endswith(".wav"):
        sig, file_sr = _load_wav_window(file, offset, duration, sr)
    elif avio.available():
        sig = avio.read_window(file, offset, duration, sr)
        if sig is None:
            raise RuntimeError(f"native decode failed for {file}")
        file_sr = sr  # swresample resampled as it decoded
    elif _have_av():
        sig, file_sr = _load_av_window(file, offset, duration, sr)
    else:
        sig, file_sr = _load_ffmpeg_window(file, offset, duration, sr)
    if file_sr != sr:
        sig = audio_utils.resample(sig, file_sr, sr)[:, :duration]
    if sig.shape[1] < duration:
        sig = np.pad(sig, ((0, 0), (0, duration - sig.shape[1])))
    if sig.shape[0] == 1:
        sig = np.concatenate([sig, sig], axis=0)
    return sig[:2], sr


def load_prompt(file, sr, duration):
    """The first `duration` samples at sr of file, mono float32
    [duration], as the JAX package's prompt loader reads them
    (jukebox_tpu/utils/audio_utils.py load_audio with mono): a wav's
    channels all averaged, after resampling frames that run past the
    window as far as the filter reaches, so the window's last samples are
    those of the whole file resampled; other formats through load_audio,
    their two channels averaged."""
    duration = int(duration)
    if not file.lower().endswith(".wav"):
        return load_audio(file, sr, 0, duration)[0].mean(axis=0)
    sig, file_sr = _load_wav_window(file, 0, duration, sr, past=True)
    if file_sr != sr:
        sig = audio_utils.resample(sig, file_sr, sr)
    sig = sig[:, :duration]
    if sig.shape[1] < duration:
        sig = np.pad(sig, ((0, 0), (0, duration - sig.shape[1])))
    return sig.mean(axis=0)


def _load_wav_window(file, offset, duration, sr, past=False):
    """The file frames that cover [offset, offset + duration) at sr, at the
    file's rate: ([C, n] float32, file rate). With past, also the frames
    after them that resampling to sr reads, as far as the file goes."""
    info = wavio.probe(file)
    if info is not None:
        file_sr = info["sample_rate"]
        start = int(offset * file_sr / sr)
        n = int(math.ceil(duration * file_sr / sr))
        if past:
            n = min(n + audio_utils.resample_reach(file_sr, sr),
                    info["n_frames"] - start)
        data = wavio.read_window(file, start, max(n, 2),
                                 out_channels=info["channels"])
        if data is not None:
            return data[:, :n] if past else data, file_sr
    with wave.open(file, "rb") as w:
        file_sr, n_channels = w.getframerate(), w.getnchannels()
        width = w.getsampwidth()
        start = min(int(offset * file_sr / sr), w.getnframes())
        n = int(math.ceil(duration * file_sr / sr))
        if past:
            n += audio_utils.resample_reach(file_sr, sr)
        n = min(n, w.getnframes() - start)
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
    return data.reshape(-1, n_channels).T, file_sr


def _load_ffmpeg_window(file, offset, duration, sr):
    """A window decoded by the ffmpeg command: seek, resample to sr, f32le
    stereo over a pipe."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError(
            f"cannot decode {file}: decoding it needs the ffmpeg libraries "
            f"(libavformat, libavcodec, libavutil, libswresample), the `av` "
            f"package or an `ffmpeg` binary on PATH")
    cmd = [ffmpeg, "-v", "error", "-ss", f"{offset / sr:.6f}", "-i", file,
           "-t", f"{duration / sr + 0.05:.6f}", "-f", "f32le", "-ac", "2",
           "-ar", str(sr), "pipe:1"]
    out = subprocess.run(cmd, capture_output=True, check=True)
    sig = np.frombuffer(out.stdout, dtype=np.float32)
    sig = sig[: 2 * (sig.size // 2)].reshape(-1, 2).T
    return sig[:, :duration], sr


def _load_av_window(file, offset, duration, sr):
    """A window decoded by PyAV, resampled to sr as it decodes."""
    import av
    container = av.open(file)
    audio = container.streams.audio[0]
    audio_duration = audio.duration * float(audio.time_base) * sr
    if offset + duration > audio_duration:
        raise ValueError(f"{file}: window [{offset}, {offset + duration}] "
                         f"past its end {audio_duration}")
    resampler = av.AudioResampler(format="fltp", layout="stereo", rate=sr)
    offset_pts = int(offset / sr / float(audio.time_base))
    sig = np.zeros((2, duration), dtype=np.float32)
    container.seek(offset_pts, stream=audio)
    total_read = 0
    for frame in container.decode(audio=0):
        frame.pts = None
        resampled = resampler.resample(frame)
        if not isinstance(resampled, list):
            resampled = [resampled]
        for f in resampled:
            frame_np = f.to_ndarray(format="fltp")
            read = min(frame_np.shape[-1], duration - total_read)
            sig[:, total_read:total_read + read] = frame_np[:, :read]
            total_read += read
            if total_read == duration:
                return sig, sr
    return sig, sr
