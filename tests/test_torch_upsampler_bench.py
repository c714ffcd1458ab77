"""The benchmark's level-0 upsampler checks in the port's CPU suite: its
plain reference (conditioner included) against the port's forward and
Conditioner at a tiny width, the cell's driver across a window boundary
on the port's plain paths, the planted faults each not correct, a traced
run's metrics and the port's sample.x_cond span
(benchmark/tests/test_benchmark_upsampler.py defines them; python -m
pytest benchmark/tests -q runs them there)."""

import torch

from benchmark.tests.test_benchmark_upsampler import (  # noqa: F401
    test_a_planted_upsampler_fault_is_not_correct,
    test_a_sound_upsampler_run_crosses_a_window_and_is_correct,
    test_a_traced_upsampler_run_reports_its_metrics,
    test_the_programs_int8_decode_is_not_correct_at_the_upsampler,
    test_the_upsampler_driver_loads_no_jax,
    test_upsampler_reference_logits_equal_the_port_forward,
    test_upsampler_reference_x_cond_equals_the_port_conditioner,
    test_x_cond_reads_the_span_and_none_without_it)

torch.set_num_threads(1)
