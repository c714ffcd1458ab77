"""The yardstick's arithmetic against counts by hand at tiny shapes."""

import pytest

from benchmark import peaks, readers, trace
from benchmark.kernels import decode_attn, decode_gemv

HP = dict(prior_width=8, m_attn=0.25, m_mlp=1.0, prior_depth=16,
          attn_order=12, n_ctx=24, n_tokens=8, blocks=4, l_bins=10,
          n_vocab=3, single_enc_dec=True)


def test_bound_takes_the_larger_time():
    assert peaks.bound(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert peaks.bound(0.0, 989e9) == pytest.approx((1.0, "operations"))
    assert peaks.bound(0.0, 67e9, "fp32")[0] == pytest.approx(1.0)


def test_gemv_bytes_and_flops_of_a_layer():
    launches = decode_gemv.step_launches(HP, batch=2)
    assert len(launches) == 4 * 16
    W, A, B = 8, 2, 2
    # c_attn: weight, bias, x, LayerNorm g and b, out bf16 and fp32
    assert launches[0] == (W * 3 * A * 2 + 3 * A * 2 + B * W * 2
                           + B * 3 * A * 2 + 2 * W * 4 + B * 3 * A * 4,
                           2 * B * W * 3 * A)
    # attn.c_proj: weight, bias, x, out, residual
    assert launches[1] == (A * W * 2 + W * 2 + B * A * 2 + B * W * 2
                           + B * W * 2, 2 * B * A * W)


def test_attention_rows_follow_each_pattern():
    # stream length 32, 4 blocks of 8; the prime span is 12
    assert decode_attn.rows(HP, 0, 13) == (14, True, True)
    assert decode_attn.rows(HP, 1, 13) == (6, True, True)
    assert decode_attn.rows(HP, 2, 13) == (2, True, True)
    assert decode_attn.rows(HP, 3, 13) == (8, False, True)
    assert decode_attn.rows(HP, 7, 5) == (6, True, True)
    assert decode_attn.rows(HP, 7, 20) == (12, False, False)
    B, A = 1, 2
    (nbytes, flops), = decode_attn.step_launches(
        dict(HP, prior_depth=1), B, 13)
    # layer 0 is pattern 1: rows 8..13 of the block, the new one among them
    assert nbytes == B * A * 4 + B * 2 * A * 2 + B * 5 * 2 * A * 2 \
        + B * 2 * A * 2 + B * A * 2
    assert flops == 4 * B * 6 * A


def test_the_whole_step_adds_the_head():
    nbytes, flops = readers.step_bytes_flops(HP, 2, 13)
    parts = (decode_gemv.step_launches(HP, 2)
             + decode_attn.step_launches(HP, 2, 13))
    bins = 13
    assert nbytes == sum(b for b, _ in parts) + bins * 8 * 4 \
        + 2 * bins * 4 + 2 * 8 * 4 * 3
    assert flops == sum(f for _, f in parts) + 2 * 2 * 8 * bins


def _ev(cat, name, ts, dur, corr=None):
    e = dict(cat=cat, name=name, ts=ts, dur=dur)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_busy_time_launches_and_gaps():
    events = [
        _ev("cpu_op", "aten::mm", 0, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 20, 1, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 21, 1, 3),
        _ev("kernel", "k1", 10, 10, 1),
        _ev("kernel", "k2", 15, 10, 3),
        _ev("kernel", "gemv_kernel<a>", 40, 5, 2),
    ]
    t = trace.Trace(events, window_s=1e-4)
    assert t.busy_s == pytest.approx(20e-6)
    assert t.launches == 2
    assert t.gaps == [("cudaLaunchKernelExC", pytest.approx(15e-6))]
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("k1", "k2")
    assert bd["idle_gaps"] == [["cudaLaunchKernelExC", pytest.approx(15e-6)]]
