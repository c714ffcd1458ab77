"""Where the bf16 decode's device idle time goes, by the port's own spans,
on one NVIDIA GPU:

    python3 scripts/chip_decode_idle_split.py [--seed 3300000017]

Sets up the benchmark's top1b.decode.b16 cell (benchmark/drivers/
prior_windows.py: weights and inputs from --seed), runs two segments, then
one more segment of 256 steps under torch.profiler (host and device) and
exports its Chrome trace to a temporary file, removed after. Prints: the
segment's synchronised wall a step; the recorder's sample.step,
sample.layers and sample.tok host ms a step (jukebox_tpu_torch/utils/
profiler.py) and the wrappers' launch_host counters; the traced window's
device busy and idle time; and how much of the idle time between device
operations lies inside the sample.step user annotations, inside
sample.layers, inside sample.tok, and in the rest of the step (its self
time: the embedding and the output head). Host spans and device
operations share the trace's clock.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark import common, harness  # noqa: E402
from jukebox_tpu_torch.utils import profiler  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals):
    out = []
    for s, f in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], f)
        else:
            out.append([s, f])
    return out


def overlap(gaps, intervals):
    """The length of `gaps` that `intervals` cover (both [(start, end)],
    gaps disjoint and sorted)."""
    iv, total, j = union(intervals), 0.0, 0
    for s, f in gaps:
        while j < len(iv) and iv[j][1] <= s:
            j += 1
        for a, b in iv[j:]:
            if a >= f:
                break
            total += min(f, b) - max(s, a)
    return total


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=3300000017)
    args = p.parse_args()
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, "top1b.decode.b16")
    drv = harness.driver_of(traffic).Driver(cfg, traffic, args.seed,
                                            torch.device("cuda"))
    drv.setup()
    drv.run_window(common.Spans(), segments=2)
    profiler.reset()
    path = os.path.join(tempfile.mkdtemp(), "decode_trace.json")
    wall = {}

    def traced(fn):
        act = torch.profiler.ProfilerActivity
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall["s"] = time.perf_counter() - t0
        prof.export_chrome_trace(path)

    _, work = drv.traced(traced, common.Spans())
    drv.release()
    n = len(work)
    rec = profiler.traced()

    def ms(name):
        return sum(s.end_ns - s.start_ns for s in rec["spans"]
                   if s.name == name) / n / 1e6
    launch = {k: v for k, v in rec["counters"].items()
              if k.startswith("launch_host.")}
    calls = sum(v["calls"] for v in launch.values())
    launch_ns = sum(v["ns"] for v in launch.values())
    print(f"{n} steps, wall {1e3 * wall['s'] / n:.4f} ms a step; host ms a "
          f"step: sample.step {ms('sample.step'):.4f}, sample.layers "
          f"{ms('sample.layers'):.4f}, sample.tok {ms('sample.tok'):.4f}; "
          f"{calls / n:.2f} launches a step at "
          f"{launch_ns / max(calls, 1) / 1e3:.3f} us, "
          f"{launch_ns / n / 1e6:.4f} ms a step")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in DEVICE_CATS
                 and "dur" in e)
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    gaps, end = [], None
    for s, f in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = f if end is None else max(end, f)
    gap_us = sum(f - s for s, f in gaps)
    busy_us = sum(f - s for s, f in union(ops))
    idle_us = wall["s"] * 1e6 - busy_us
    inside = {k: overlap(gaps, spans.get(k, []))
              for k in ("sample.step", "sample.layers", "sample.tok")}
    inside["step self"] = (inside["sample.step"] - inside["sample.layers"]
                           - inside["sample.tok"])
    print(json.dumps(dict(
        steps=n, wall_s=wall["s"], busy_s=busy_us / 1e6,
        idle_s=idle_us / 1e6, gaps_s=gap_us / 1e6,
        annotations={k: len(v) for k, v in spans.items()},
        inside_step_share_of_idle=inside["sample.step"] / idle_us,
        share_of_gaps={k: v / gap_us for k, v in inside.items()})))


if __name__ == "__main__":
    main()
