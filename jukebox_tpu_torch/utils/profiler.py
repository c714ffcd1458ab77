"""Profiling hooks of the PyTorch port (counterpart of
jukebox_tpu/utils/profiler.py): torch.profiler traces written as Chrome
trace files (chrome://tracing, Perfetto), and per-step wall timing."""

import contextlib
import os
import time

import torch

_ACTIVE = {}


def start_trace(logdir):
    """Start a torch.profiler trace of the host and, where CUDA is
    available, of the card, for stop_trace to write under `logdir`."""
    if _ACTIVE:
        raise RuntimeError("a trace is already running")
    prof = torch.profiler
    activities = [prof.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(prof.ProfilerActivity.CUDA)
    p = prof.profile(activities=activities)
    p.start()
    _ACTIVE.update(prof=p, logdir=logdir)


def stop_trace():
    """Stop the running trace and write it as
    {logdir}/trace_<pid>_<time>.json. Returns the path."""
    p, logdir = _ACTIVE.pop("prof"), _ACTIVE.pop("logdir")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    p.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time())}.json")
    p.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """A torch.profiler trace of the block, written under `logdir`."""
    if not enabled:
        yield
        return
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


class StepTimer:
    """Rolling per-step timing with compile-step exclusion."""

    def __init__(self, skip_first=1):
        self.skip_first = skip_first
        self.times = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip_first:
            self.times.append(dt)

    @property
    def mean(self):
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self):
        if not self.times:
            return "no steps timed"
        return (f"steps={len(self.times)} mean={self.mean*1e3:.2f}ms "
                f"min={min(self.times)*1e3:.2f}ms max={max(self.times)*1e3:.2f}ms")
