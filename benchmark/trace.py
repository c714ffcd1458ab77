"""A traced part of a run under torch.profiler, reduced to what the
per-layer readers and the result's breakdown need: the device's operations
(kernels, copies, sets), the host's launch calls and what the host was
doing in each idle gap."""

import bisect
import json
import os
import tempfile

import torch

from benchmark import common

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
# the runtime and driver calls that start work on the device
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
    "cudaGraphLaunch", "cuGraphLaunch"))


class Trace:
    """ops: [(name, start_us, dur_us)] of the device, sorted by start;
    launches: the host's launch calls; window_s: the traced part's length
    on the host clock, synchronised at both ends; gaps: [(host activity,
    seconds)] of every idle gap between device operations."""

    def __init__(self, events, window_s):
        self.window_s = window_s
        self.ops = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                           for e in events if e.get("cat") in DEVICE_CATS
                           and "dur" in e), key=lambda o: o[1])
        host = [e for e in events if e.get("cat") in HOST_CATS]
        self.launches = sum(1 for e in host if e["name"] in LAUNCH_CALLS)
        self.gaps = self._gaps(events, host)

    def kernels(self, pattern):
        """[(name, dur_us)] of the device operations whose name matches
        the compiled regular expression `pattern`."""
        return [(n, d) for n, _, d in self.ops if pattern.search(n)]

    @property
    def busy_s(self):
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, None
        for _, ts, dur in self.ops:
            if end is None or ts >= end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def _gaps(self, events, host):
        """Each gap before a device operation, named by the innermost host
        operation around the call that launched it (else that call)."""
        corr = {}
        for e in host:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr[c] = e
        cpu = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") == "cpu_op" and "dur" in e))
        starts = [c[0] for c in cpu]
        by_start = {}
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                by_start.setdefault(float(e["ts"]), e)
        out, end = [], None
        for _, ts, dur in self.ops:
            if end is not None and ts > end:
                e = by_start.get(ts)
                call = corr.get(e.get("args", {}).get("correlation")) \
                    if e is not None else None
                name = "unknown"
                if call is not None:
                    name = call["name"]
                    t = float(call["ts"])
                    i = bisect.bisect_right(starts, t)
                    for s, f, n in reversed(cpu[max(0, i - 64):i]):
                        if f >= t:
                            name = n
                            break
                out.append((name, (ts - end) / 1e6))
            end = ts + dur if end is None else max(end, ts + dur)
        return out

    def breakdown(self, top=10):
        ops, gaps = {}, {}
        for n, _, d in self.ops:
            ops[n] = ops.get(n, 0.0) + d / 1e6
        for n, s in self.gaps:
            gaps[n] = gaps.get(n, 0.0) + s

        def best(d):
            return [[k[:120], v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}


def profile(fn, device):
    """Run fn() under torch.profiler (host and device activity) and return
    its Trace. The trace goes through a temporary file, removed after."""
    prof = torch.profiler
    acts = [prof.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(prof.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with prof.profile(activities=acts) as p:
        t0 = common.now()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = common.now() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Trace(events, window_s)
