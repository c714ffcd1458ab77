"""On the card: each control of a cell fails one of the cell's limits, at
the cell's own size, and a sound seed passes them: the decode's two (the
program's own int8 decode, and the reference with its products in fp8 in
the program's place) and training's (the reference in fp8). Skips
without a CUDA device:

    python -m pytest benchmark/tests/test_benchmark_control_gpu.py -q
"""

import pytest
import torch

from benchmark import calibrate, common

SEGMENTS = {"top1b.decode.b16": 6, "top1b.train": 0}
CONTROLS = {"top1b.decode.b16": ("control", "control_fp8"),
            "top1b.train": ("control",)}


def _limits(cell):
    return common.load_json(common.find("limits", cell))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SEGMENTS))
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size")
    limits = _limits(cell)
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    sound, prog = calibrate.readings(cell, [7001], "program", SEGMENTS[cell])
    assert all(sound[0][1][k] <= v for k, v in limits.items()), sound
    for i, mode in enumerate(CONTROLS[cell]):
        ctrl, prog = calibrate.readings(cell, [7002 + i], mode,
                                        SEGMENTS[cell], program=prog)
        assert any(ctrl[0][1][k] > v for k, v in limits.items()), (mode,
                                                                    ctrl)
