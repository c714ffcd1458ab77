"""On the card: each control of up0.window.b16 fails one of its limits at
the cell's own size, and a sound seed passes them: the program's own int8
decode, the reference with its products in fp8 in the program's place,
and the program's conditioner with its output one position late. Each run
decodes 6 segments, past the first window's end into the second. Skips
without a CUDA device:

    python -m pytest benchmark/tests/test_benchmark_control_up0_gpu.py -q
"""

import pytest
import torch

from benchmark import calibrate, common
from benchmark.drivers import upsampler_windows as uw

CELL = "up0.window.b16"
SEGMENTS = 6


@pytest.mark.gpu
def test_the_up0_controls_fail_and_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    limits = common.load_json(common.find("limits", CELL))
    sound, prog = calibrate.readings(CELL, [7101], "program", SEGMENTS)
    assert all(sound[0][1][k] <= v for k, v in limits.items()), sound
    for i, mode in enumerate(("control", "control_fp8")):
        ctrl, prog = calibrate.readings(CELL, [7102 + i], mode, SEGMENTS,
                                        program=prog)
        assert any(ctrl[0][1][k] > v for k, v in limits.items()), (mode,
                                                                    ctrl)
    fault, _ = uw.fault_readings(CELL, [7104], "x_cond_late", SEGMENTS,
                                 program=prog)
    assert any(fault[0][1][k] > v for k, v in limits.items()), fault
