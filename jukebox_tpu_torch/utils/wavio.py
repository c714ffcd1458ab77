"""ctypes binding of the port's native wav window reader (csrc/wavio.cpp,
a copy of the JAX package's), built by g++ at first use into the checkout's
build/ directory (ops/_build.py build_host). It reads integer PCM of 8,
16, 24 and 32 bits and IEEE-float wav of 32 and 64 bits, and releases the
GIL for the whole read, so the loader's threads read in parallel.
available() is False where g++ is missing or fails; io.py then reads
integer PCM through the stdlib `wave` module, as the JAX package does."""

import ctypes
import threading

import numpy as np

from jukebox_tpu_torch.ops import _build

_LIB = None
_LOCK = threading.Lock()


class _WavInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_int32),
                ("channels", ctypes.c_int32),
                ("bits", ctypes.c_int32),
                ("format", ctypes.c_int32),  # 1 = int PCM, 3 = IEEE float
                ("n_frames", ctypes.c_int64),
                ("data_offset", ctypes.c_int64)]


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(_build.build_host("wavio")))
            except (RuntimeError, OSError):
                _LIB = False
                return _LIB
            lib.wav_probe.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(_WavInfo)]
            lib.wav_probe.restype = ctypes.c_int
            lib.wav_read_window.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
            lib.wav_read_window.restype = ctypes.c_int64
            _LIB = lib
    return _LIB


def available():
    return bool(_load_lib())


def probe(path):
    """dict(sample_rate, channels, bits, format, n_frames), or None."""
    lib = _load_lib()
    if not lib:
        return None
    info = _WavInfo()
    if lib.wav_probe(path.encode(), ctypes.byref(info)) != 0:
        return None
    return dict(sample_rate=info.sample_rate, channels=info.channels,
                bits=info.bits, format=info.format, n_frames=info.n_frames)


def read_window(path, start, n_frames, out_channels=2):
    """Frames [start, start + n_frames) of the file as float32
    [out_channels, n_frames] (a mono file's channel repeated; zeros past
    the end), or None when the file cannot be read."""
    lib = _load_lib()
    if not lib:
        return None
    out = np.zeros((out_channels, n_frames), dtype=np.float32)
    got = lib.wav_read_window(
        path.encode(), int(start), int(n_frames),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_channels)
    return None if got < 0 else out
