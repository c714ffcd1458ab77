"""Files of the benchmark found by name, seeds, and the harness's spans."""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names the process that prints a result may not hold
FOREIGN = frozenset(("jax", "jaxlib", "flax", "jukebox_tpu"))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(kind, name, base=BENCH_DIR):
    """The file of `name` under base/kind/: a configuration, traffic mix or
    limits file is <name>.json, a metric reader or kernel family
    <name>.py."""
    suffix = ".py" if kind in ("metrics", "kernels") else ".json"
    path = Path(base) / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def names(kind, base=BENCH_DIR):
    """Every name that base/kind/ holds a file for."""
    suffix = ".py" if kind in ("metrics", "kernels") else ".json"
    return sorted(p.name[:-len(suffix)] for p in (Path(base) / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


def load_module(kind, name, base=BENCH_DIR):
    """The module of a metric reader or kernel family, loaded from its file
    (its name may hold dots, so it is not imported by name)."""
    path = find(kind, name, base)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive(seed, *keys):
    """A 63-bit seed of (seed, *keys): every stream a run draws from
    (weights, inputs, sampling, the rows checked) has its own."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    return int(state.generate_state(1, np.uint64)[0]) >> 1


def foreign_modules(modules):
    """The names in `modules` whose top-level name (before the first dot)
    is one the benchmark's process may not load, compared whole."""
    return sorted(n for n in modules if n.split(".", 1)[0] in FOREIGN)


class Spans:
    """The harness's spans: name -> list of (start, end, attrs), host clock
    in seconds, each ended after a device synchronise."""

    def __init__(self):
        self.items = {}

    def add(self, name, start, end, **attrs):
        self.items.setdefault(name, []).append((start, end, attrs))

    def get(self, name):
        return self.items.get(name, [])


def now():
    return time.perf_counter()
