"""Run one cell of the port's benchmark once and print its result:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the checks: each number compared with its limit); the
checks are also the last lines of standard error. Exits 2 without enough
CUDA devices, 3 if a JAX module was loaded, printing no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import common  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout; the
# program's own (ops/_build.py) is build/jukebox_tpu_torch/
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/benchmark/triton",
              "TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions"}
# the benchmark chooses the decode mode itself
PROGRAM_SWITCHES = ("JUKEBOX_INT8_DECODE", "JUKEBOX_INT8_CACHE")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(common.ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    for key in PROGRAM_SWITCHES:
        os.environ.pop(key, None)
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark import harness
    result = harness.run(bench, args.workload, args.seed, args.seconds,
                         args.trace, "cuda", T_START)
    bad = harness.foreign_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
