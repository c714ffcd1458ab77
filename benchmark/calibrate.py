"""Readings that set a cell's limits: the program's numbers compared over
many seeds, and the control's, in one process that builds the program
once (the benchmark's own runs never run this):

    python3 -m benchmark.calibrate --workload top1b.decode.b16 \
        --seeds 1,2,3 --control-seeds 4,5,6 --fp8-seeds 7,8,9 --segments 6

Each seed draws its weights and inputs anew. A sampling cell runs its
set-up (the first window's start and warm steps) and `--segments`
segments of its traffic (the first greedy, as in a run), then the check.
It has two controls below the bf16 that the configuration states: the
program's own weight-only int8 decode (--control-seeds), and the
reference with every product in fp8 in the program's place
(--fp8-seeds), read at each position of the same prompts and tokens. The training cell runs its set-up (the
checked steps) and the check; its control (--control-seeds) is the
reference with every product in fp8 in the program's place, and
--fault-seeds plant a step that leaves half its rows out. One JSON line
per seed on standard output."""

import argparse
import json
import sys
import time

import torch

from benchmark import common, harness


def readings(cell_name, seeds, mode, segments, device="cuda",
             base=common.BENCH_DIR, bench=None, program=None):
    """[(seed, {check: value}, numbers compared, seconds)] of each seed and
    the program built (reused by the next call). mode: "program", "control"
    (the sampling cells' int8 decode; the training cell's reference in
    fp8 in the program's place) or "half_batch" (a training step that
    leaves half its rows out, a planted fault)."""
    bench = bench or common.load_json(common.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, cell_name, base)
    Driver = harness.driver_of(traffic).Driver
    train = traffic["driver"] == "prior_train"
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        if train:
            drv = Driver(cfg, traffic, seed, torch.device(device),
                         half_batch=mode == "half_batch")
            if mode == "control":
                drv.recipe()
                checks = dict(drv.control_check())
            else:
                drv.setup()
                drv.release()
                checks = dict(drv.check())
        else:
            drv = Driver(cfg, traffic, seed, torch.device(device),
                         quantize="int8" if mode == "control" else None,
                         program=program)
            drv.setup()
            program = drv.program
            drv.run_window(common.Spans(), segments=segments)
            drv.release(keep_program=True)
            checks = dict(drv.check(
                torch.float8_e4m3fn if mode == "control_fp8" else None))
        out.append((seed, checks, drv.compared, time.perf_counter() - t0))
    return out, program


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fp8-seeds", default="",
                   help="a sampling cell's reference in fp8 as the control")
    p.add_argument("--fault-seeds", default="",
                   help="a training cell's half_batch fault")
    p.add_argument("--segments", type=int, default=6)
    a = p.parse_args(argv)
    program = None
    for mode, spec in (("program", a.seeds), ("control", a.control_seeds),
                       ("control_fp8", a.fp8_seeds),
                       ("half_batch", a.fault_seeds)):
        seeds = [int(s) for s in spec.split(",") if s]
        if not seeds:
            continue
        res, program = readings(a.workload, seeds, mode, a.segments,
                                program=program)
        for seed, checks, n, sec in res:
            print(json.dumps(dict(workload=a.workload, seed=seed, mode=mode,
                                  checks=checks, compared=n, seconds=sec)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
