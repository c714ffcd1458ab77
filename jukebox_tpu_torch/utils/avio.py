"""ctypes binding of the port's native compressed-audio reader
(csrc/avio.cpp, a copy of the JAX package's), which drives the system's
ffmpeg libraries (libavformat, libavcodec, libavutil, libswresample): probe
a file's duration, decode a window of samples at a target rate as stereo
float. One C call per window releases the GIL for the whole decode. It is
built by g++ at first use into the checkout's build/ directory
(ops/_build.py build_host); available() is False where the libraries are
not installed or the build fails."""

import ctypes
import ctypes.util
import threading

import numpy as np

from jukebox_tpu_torch.ops import _build

LIBS = ("avformat", "avcodec", "avutil", "swresample")
_LIB = None
_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not all(ctypes.util.find_library(n) for n in LIBS):
                _LIB = False
                return _LIB
            try:
                lib = ctypes.CDLL(str(_build.build_host("avio")))
            except (RuntimeError, OSError):
                _LIB = False
                return _LIB
            lib.jav_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.jav_probe.restype = ctypes.c_int
            lib.jav_read_window.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
            lib.jav_read_window.restype = ctypes.c_int64
            _LIB = lib
    return _LIB


def available():
    return bool(_load_lib())


def probe(path):
    """dict(duration_sec, sample_rate, channels), or None."""
    lib = _load_lib()
    if not lib:
        return None
    dur, sr, ch = ctypes.c_double(), ctypes.c_int32(), ctypes.c_int32()
    if lib.jav_probe(path.encode(), ctypes.byref(dur), ctypes.byref(sr),
                     ctypes.byref(ch)) != 0:
        return None
    return dict(duration_sec=dur.value, sample_rate=sr.value,
                channels=ch.value)


def read_window(path, offset, n, target_sr):
    """Samples [offset, offset + n) at target_sr as float32 [2, n] (seek to
    the keyframe before, decode and drop up to the offset; zeros past the
    end), or None when the decode fails."""
    lib = _load_lib()
    if not lib:
        return None
    out = np.zeros((2, n), dtype=np.float32)
    got = lib.jav_read_window(
        path.encode(), int(offset), int(n), int(target_sr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return None if got < 0 else out

