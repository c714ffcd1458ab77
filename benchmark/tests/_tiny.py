"""Tiny copies of the benchmark's cells for CPU tests: the same presets,
cut in width and depth through the configurations' program overrides, in
a benchmark tree of their own under a temporary directory."""

import copy
import json
import shutil

from benchmark import common

TOP = dict(n_ctx=120, prior_width=32, prior_depth=16, heads=2, blocks=4,
           n_tokens=8, init_scale=5.0)
TOP_TRAFFIC = dict(batch=3, segment=16, chunk_size=32, check_rows=2)
TRAIN_TRAFFIC = dict(batch=2)
LIMITS = {"out_of_range": 0, "logit_gap_max": 0.05, "logit_gap_mean": 1e-3,
          "logit_kl": 2e-3, "logit_err": 0.03, "int8_share": 0.4,
          "loss_gap": 1e-2,
          "grad_gap": 0.1, "change_gap": 0.2, "skipped_steps": 0}


# each cell of BENCHMARK.json -> its tiny copy
TINY = {"top1b.decode.b16": "top.tiny", "top1b.train": "train.tiny"}


def tiny_config(name, over):
    cfg = common.load_json(common.find("configs", name))
    cfg = copy.deepcopy(cfg)
    cfg["program"]["overrides"] = dict(over)
    cfg["hparams"].update(over)
    return cfg


def tree(tmp_path):
    """A benchmark tree with the tiny cells top.tiny and train.tiny;
    returns (base, bench)."""
    base = tmp_path / "bench"
    for kind in ("configs", "traffic", "limits"):
        (base / kind).mkdir(parents=True)
    shutil.copytree(common.BENCH_DIR / "metrics", base / "metrics")
    cells = [("top.tiny", "prior_1b_lyrics", "decode.hop0.5.b16", TOP,
              TOP_TRAFFIC),
             ("train.tiny", "prior_1b_lyrics", "finetune.bs16", TOP,
              TRAIN_TRAFFIC)]
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    bench = copy.deepcopy(bench)
    bench["workloads"] = []
    for cell, cfg_name, tr_name, over, tr_over in cells:
        cfg = tiny_config(cfg_name, over)
        cfg["name"] = cfg_name + ".tiny"
        tr = dict(common.load_json(common.find("traffic", tr_name)), **tr_over)
        (base / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (base / "traffic" / f"{tr_name}.tiny.json").write_text(json.dumps(tr))
        (base / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
        bench["workloads"].append(dict(name=cell, config=cfg["name"],
                                       traffic=tr_name + ".tiny", chips=1,
                                       why="a CPU test"))
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w] for w in m["workloads"]]
    return base, bench
