"""One run of one cell: set-up, the measured window, the traced part (with
--trace 1), the check against the reference, the result line."""

import importlib
import subprocess
import sys

import torch

from benchmark import common, trace as tracing

CONTRACT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


class Reading:
    """What a per-layer reader reads: the configuration's hparams, the
    traffic, the window's spans and totals, and the traced part (trace,
    work: the steps it ran) or None."""

    def __init__(self, cfg, traffic, spans, window, trace=None, work=()):
        self.cfg, self.hp, self.traffic = cfg, cfg["hparams"], traffic
        self.spans, self.window = spans, window
        self.trace, self.work = trace, list(work)


def cell_files(bench, cell_name, base=common.BENCH_DIR):
    """(cell, config, traffic, limits) of a workload of BENCHMARK.json."""
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cfg = common.load_json(common.find("configs", cell["config"], base))
    traffic = common.load_json(common.find("traffic", cell["traffic"], base))
    limits = common.load_json(common.find("limits", cell["name"], base))
    return cell, cfg, traffic, limits


def metrics_of(bench, cell_name, kind):
    """The end-to-end or per-layer metrics that the cell reports."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def driver_of(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def power_limit_w():
    """The card's power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(bench, cell_name, seed, seconds, trace, device, t_start,
        driver_kwargs=None, base=common.BENCH_DIR):
    """Run the cell once; returns the result dict (the contract's keys,
    "breakdown" with a trace, then "checks" last)."""
    device = torch.device(device)
    cell, cfg, traffic, limits = cell_files(bench, cell_name, base)
    drv = driver_of(traffic).Driver(cfg, traffic, seed, device,
                                    **(driver_kwargs or {}))
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = common.now() - t_start
    spans = common.Spans()
    window = drv.run_window(spans, seconds=seconds)
    metrics = {}
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                     "count": cell["chips"]}
    breakdown = None
    if trace:
        tr, work = drv.traced(lambda fn: tracing.profile(fn, device), spans)
        r = Reading(cfg, traffic, spans, window, tr, work)
        for m in metrics_of(bench, cell_name, "per_layer"):
            v = common.load_module("metrics", m["name"], base).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result_device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
    if device.type == "cuda":
        result_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
        result_device["power_limit_w"] = power_limit_w()
    else:
        result_device["memory_peak_bytes"] = 0
    if not trace:
        values = dict(drv.end_to_end(window), setup_s=setup_s,
                      memory_peak_gib=result_device["memory_peak_bytes"]
                      / 2 ** 30)
        for m in metrics_of(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    attempted = drv.attempted()
    drv.release()
    t_check = common.now()
    found = drv.check()
    print(f"note: set-up {setup_s:.3f} s, window {window['seconds']:.3f} s"
          f" ({window}), check {common.now() - t_check:.3f} s",
          file=sys.stderr)
    checks = {}
    for name, value in found:
        if name in limits:
            checks[name] = {"value": value, "limit": limits[name]}
        else:
            print(f"note: {name} {value!r} (not compared)", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def foreign_loaded():
    return common.foreign_modules(list(sys.modules))
