"""The harness: files found by name, a new file found without an edit,
the result line's keys, names and units of BENCHMARK.json, and no module
of JAX or the JAX package in the benchmark's process."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import common, harness
from benchmark.tests import _tiny

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cell, cfg, traffic, limits = harness.cell_files(BENCH, w["name"])
        assert cfg["name"] == w["config"]
        assert harness.driver_of(traffic).Driver
        assert limits
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert common.load_json(common.ROOT / c["file"])["name"] == c["name"]
    for m in BENCH["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)
    for fam in common.names("kernels"):
        mod = common.load_module("kernels", fam)
        assert mod.PATTERN.pattern and callable(mod.launches)


def test_a_new_file_is_found_without_an_edit(tmp_path):
    base = tmp_path / "b"
    for kind in ("configs", "traffic", "metrics", "kernels", "limits"):
        shutil.copytree(common.BENCH_DIR / kind, base / kind)
    (base / "metrics" / "new_metric.sample.py").write_text(
        "def read(r):\n    return 1.5\n")
    (base / "traffic" / "new.mix.json").write_text('{"driver": "x"}')
    (base / "kernels" / "new_family.py").write_text(
        "import re\nPATTERN = re.compile('k')\n"
        "def launches(work, hp):\n    return []\n")
    assert "new_metric.sample" in common.names("metrics", base)
    assert "new.mix" in common.names("traffic", base)
    assert "new_family" in common.names("kernels", base)
    assert common.load_module("metrics", "new_metric.sample", base).read(
        None) == 1.5
    assert common.load_json(common.find("traffic", "new.mix", base)) == {
        "driver": "x"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_holds_the_contract_keys(tmp_path, trace):
    base, bench = _tiny.tree(tmp_path)
    out = harness.run(bench, "top.tiny", 2 ** 31 + 12345, 0.5, trace, "cpu",
                      common.now(), base=base)
    keys = list(out)
    want = list(harness.CONTRACT_KEYS) + (["breakdown"] if trace else [])
    assert keys == want + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"memory_peak_gib", "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_names_and_units_of_benchmark_json():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + [w["name"] for w in
                                             BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_foreign_modules_compare_whole_top_level_names():
    mods = ["jukebox_tpu_torch", "jukebox_tpu_torch.ops.core", "jax",
            "jax.numpy", "jaxlib.xla_client", "jukebox_tpu",
            "jukebox_tpu.models", "flax", "flaxy", "jaxtyping", "benchmark"]
    assert common.foreign_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "jukebox_tpu",
         "jukebox_tpu.models", "flax"])


def test_the_benchmark_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import benchmark.run, benchmark.harness, benchmark.calibrate\n"
        "import benchmark.drivers.prior_windows, benchmark.readers\n"
        "from benchmark import common\n"
        "from jukebox_tpu_torch.models import make_models\n"
        "for kind in ('metrics', 'kernels'):\n"
        "    for n in common.names(kind):\n"
        "        common.load_module(kind, n)\n"
        "print(common.foreign_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
