"""The tiny copy of the level-0 upsampler's cell for CPU tests, beside
_tiny.py's: the upsampler_level_0 preset cut in width, depth and context
(n_ctx 128 over 4 blocks of 32, so its hop-0.5 windows condition on 32
level-1 codes each), its traffic at 3 rows, the first window 2 codes from
its end: set-up's warm steps finish it, so the window's first segment
starts the second window however slow the host. Importing this module names the tiny copy in _tiny.TINY, so that
_tiny.tree maps the cell's metrics too."""

import json

from benchmark import common
from benchmark.tests import _tiny

UP0 = dict(n_ctx=128, prior_width=32, prior_depth=6, blocks=4,
           cond_width=16, cond_depth=3, init_scale=5.0)
UP0_TRAFFIC = dict(batch=3, segment=16, chunk_size=32, check_rows=2,
                   drawn=62)
CELL = "up0.window.b16"
_tiny.TINY.setdefault(CELL, "up0.tiny")


def config():
    return _tiny.tiny_config("upsampler_level_0", UP0)


def tree(tmp_path):
    """_tiny.tree's benchmark tree with the cell up0.tiny added; returns
    (base, bench)."""
    base, bench = _tiny.tree(tmp_path)
    cell = common.load_json(common.ROOT / "BENCHMARK.json")
    cell = next(w for w in cell["workloads"] if w["name"] == CELL)
    cfg = dict(config(), name="upsampler_level_0.tiny")
    tr = dict(common.load_json(common.find("traffic", cell["traffic"])),
              **UP0_TRAFFIC)
    (base / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (base / "traffic" / f"{cell['traffic']}.tiny.json").write_text(
        json.dumps(tr))
    (base / "limits" / "up0.tiny.json").write_text(json.dumps(_tiny.LIMITS))
    bench["workloads"].append(dict(name="up0.tiny", config=cfg["name"],
                                   traffic=cell["traffic"] + ".tiny",
                                   chips=1, why="a CPU test"))
    return base, bench
