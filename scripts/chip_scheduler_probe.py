"""The cascade's two schedulers on one NVIDIA GPU, in turns, on the smoke's
phase 4 cascade (1b_lyrics from random weights drawn from --seed, the
upsamplers cut to chip_smoke.UPS_DEPTH layers, 4 x 262144 samples, hop
fractions 0.5, 0.5, 0.125, temp 0.99):

    python3 scripts/chip_scheduler_probe.py [--rounds 1] [--seed 0]

Each round runs the sequential scheduler with the inline finalize
(pipeline_cascade=False, JUKEBOX_ASYNC_FINALIZE=0) and the default one
(pipelined, the finalize and the next level's staging on worker threads)
as s, p, p, s, each through chip_smoke.run_cascade (its launch counts and
alignment checks included). Per run: the wall of the sampling call (host
clock, ending in a synchronize), the time from the call's start at which
each level's data.jkb was written (that level's audio on disk), peak
device memory and the stage thread-seconds. Every run's codes must equal
the first run's. At this length the levels do not interleave (the top
samples one partial window and level 1 one window, which level 0's first
window waits for), so the two differ by their threads alone. Prints the
card's name and power limit, each run, then one JSON line; exits non-zero
if a run's codes differ.
"""

import argparse
import faulthandler
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from jukebox_tpu_torch.hparams import Hyperparams  # noqa: E402
from jukebox_tpu_torch.models.make_models import make_model  # noqa: E402


def one_run(priors, seed, sequential):
    hps = Hyperparams(n_samples=chip_smoke.N_SAMPLES,
                      sample_length=chip_smoke.SAMPLE_LENGTH, sr=44100,
                      hop_fraction=chip_smoke.HOPS, seed=seed,
                      name=tempfile.mkdtemp(prefix="jukebox_sched_"))
    skw = [dict(temp=chip_smoke.TEMP, fp16=True, chunk_size=256,
                max_batch_size=chip_smoke.N_SAMPLES) for _ in priors]
    t0 = time.time()
    try:
        rep = chip_smoke.run_cascade(priors, hps, skw, sequential=sequential)
        files = {level: os.path.getmtime(os.path.join(
            hps.name, f"level_{level}", "data.jkb")) - t0
            for level in range(len(priors))}
    finally:
        shutil.rmtree(hps.name, ignore_errors=True)
    return dict(scheduler=rep["scheduler"], wall_s=rep["wall_s"],
                file_s=files, peak_mem_gb=rep.get("peak_mem_gb"),
                stages=chip_smoke._stages(rep)), rep["zs"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    name, _ = chip_smoke.phase_device()
    # four cascades a round: a watchdog longer than the smoke's
    faulthandler.dump_traceback_later(300 + 900 * args.rounds, exit=True)
    chip_smoke.phase_build()
    hps = Hyperparams(sample_length=chip_smoke.SAMPLE_LENGTH, seed=args.seed)
    _, priors = make_model("1b_lyrics", hps, "cuda", prior_overrides=[
        {"prior_depth": chip_smoke.UPS_DEPTH},
        {"prior_depth": chip_smoke.UPS_DEPTH}, {}])
    runs, first = [], None
    for _ in range(args.rounds):
        for sequential in (True, False, False, True):
            run, zs = one_run(priors, args.seed, sequential)
            if first is None:
                first = zs
            same = all(np.array_equal(a, b) for a, b in zip(zs, first))
            run["codes_equal_first"] = same
            chip_smoke.log(f"{run['scheduler']}: wall {run['wall_s']:.2f}s, "
                           f"data.jkb at {run['file_s']}, peak "
                           f"{run['peak_mem_gb']:.2f} GB, stages "
                           f"{run['stages']}, codes equal: {same}")
            runs.append(run)
            if not same:
                raise SystemExit("the schedulers' codes differ")
            torch.cuda.empty_cache()
    walls = {s: [r["wall_s"] for r in runs if r["scheduler"] == s]
             for s in ("sequential", "pipelined")}
    print(json.dumps({"device": name, "runs": runs, "walls": walls}),
          flush=True)


if __name__ == "__main__":
    main()
