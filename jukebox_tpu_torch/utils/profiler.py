"""Profiling of the PyTorch port (counterpart of jukebox_tpu/utils/profiler.py):
one recorder of spans and counters that times the program's layers where
they work, and torch.profiler traces written as Chrome trace files
(chrome://tracing, Perfetto).

The recorder has two levels, fixed at each call site:

* span(name, **attrs), a coarse span: once per set-up phase, window,
  segment, cascade stage or training step. Always on: it adds its seconds
  to totals() (calls, seconds, min and max per name).
* fine(name, **attrs) and add(name, ns, n=1), a fine span and a counter of
  time and calls: once per token or per launch. They cost one flag test
  while torch.profiler is not recording, and record only while it is
  (train.py --debug_speed's trace, a benchmark's traced part).

While torch.profiler records, every span is also kept for traced() (its name,
start and end in ns on time.time_ns, its parent: the span around it in the
same thread, and its attributes) and enters torch.profiler.record_function
(name): in the exported Chrome trace it is a user_annotation on the
kernels' own clock (its `ts` plus the trace's baseTimeNanoseconds / 1000 is
time.time_ns() / 1000), and its device extent a gpu_user_annotation.
Nothing here synchronises the device, creates a CUDA event or allocates
device memory: a span times the host, and device work it enqueued may end
after it. Totals and counters are kept under one lock, since the pipelined
cascade samples from worker threads.
"""

import functools
import os
import threading
import time
from contextlib import nullcontext

import torch
import torch.autograd.profiler as _autograd_profiler

_ACTIVE = {}
_LOCK = threading.Lock()
_TOTALS = {}  # name -> [calls, seconds, min, max] of the coarse spans
_SPANS = []  # the spans entered while torch.profiler recorded, in order of entry
_COUNTERS = {}  # name -> [calls, ns], added while torch.profiler recorded
_LOCAL = threading.local()  # .stack: the thread's open spans
_OFF = nullcontext()


def tracing():
    """Whether torch.profiler is recording: fine spans and counters
    record only then."""
    return _autograd_profiler._is_profiler_enabled


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """One span: name, attrs, start_ns and end_ns (time.time_ns), parent
    (the enclosing Span of the thread, or None); `seconds` once ended."""

    __slots__ = ("name", "attrs", "coarse", "start_ns", "end_ns", "parent",
                 "_annotation")

    def __init__(self, name, attrs, coarse):
        self.name, self.attrs, self.coarse = name, attrs, coarse
        self.start_ns = self.end_ns = None
        self.parent = self._annotation = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        # stamped around the annotation, which then lies inside the span:
        # a process's first record_function takes ~1 ms to enter
        self.start_ns = time.time_ns()
        if tracing():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
            with _LOCK:
                _SPANS.append(self)
        return self

    def __exit__(self, *exc):
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        self.end_ns = time.time_ns()
        _stack().pop()
        if self.coarse:
            s = self.seconds
            with _LOCK:
                t = _TOTALS.get(self.name)
                if t is None:
                    _TOTALS[self.name] = [1, s, s, s]
                else:
                    t[0] += 1
                    t[1] += s
                    t[2] = min(t[2], s)
                    t[3] = max(t[3], s)
        return False

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9


def span(name, **attrs):
    """A coarse span of the block (always on; see the module's
    docstring). The `with` target is the Span."""
    return Span(name, attrs, True)


def fine(name, **attrs):
    """A fine span of the block: a Span while torch.profiler is
    recording, else a shared no-op context (its `with` target is None)."""
    return Span(name, attrs, False) if tracing() else _OFF


def timed(name):
    """Decorator: each call of the function is a coarse span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with Span(name, {}, True):
                return fn(*args, **kwargs)
        return call
    return wrap


def fine_start():
    """time.time_ns() while torch.profiler is recording, else 0: the
    start of an interval for add(), which a caller adds only when
    non-zero."""
    return time.time_ns() if _autograd_profiler._is_profiler_enabled else 0


def add(name, ns, n=1):
    """Add n calls that took ns nanoseconds to the counter `name`, while a
    torch.profiler is recording (fine; nothing otherwise)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            _COUNTERS[name] = [n, ns]
        else:
            c[0] += n
            c[1] += ns


def totals():
    """{name: {"calls", "seconds", "min", "max"}} of the coarse spans
    since the process started or reset() (seconds on the host's clock;
    spans on worker threads overlap, so their sum can exceed the wall)."""
    with _LOCK:
        return {k: dict(calls=c, seconds=s, min=lo, max=hi)
                for k, (c, s, lo, hi) in _TOTALS.items()}


def traced():
    """What was recorded while torch.profiler recorded: {"spans": [Span]
    in order of entry, "counters": {name: {"calls", "ns"}}}."""
    with _LOCK:
        return dict(spans=list(_SPANS),
                    counters={k: dict(calls=c, ns=ns)
                              for k, (c, ns) in _COUNTERS.items()})


def reset():
    """Clear the totals, the kept spans and the counters."""
    with _LOCK:
        _TOTALS.clear()
        _SPANS.clear()
        _COUNTERS.clear()


def counters():
    """One snapshot of the kernel wrappers' launch counts (the LAUNCHES of
    ops/decode_stack.py, flash_attention.py, layer_norm.py, bias_gelu.py
    and adam.py) and the decode graphs' captures and replays
    (models/autoregressive.py GRAPHS, as graph_captures and graph_replays),
    read together under the lock the counts are kept under."""
    from jukebox_tpu_torch.models import autoregressive
    from jukebox_tpu_torch.ops import (_build, adam, bias_gelu, decode_stack,
                                       flash_attention, layer_norm)
    with _build._COUNT_LOCK:
        out = {}
        for mod in (decode_stack, flash_attention, layer_norm, bias_gelu,
                    adam):
            out.update(mod.LAUNCHES)
        out.update({f"graph_{k}": v
                    for k, v in autoregressive.GRAPHS.items()})
    return out


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
