"""A run with its timed path broken underneath comes out not correct:
each fault that a sampling cell can have, planted in the program at a
tiny size on the CPU (the harness's look for a chip is skipped)."""

import pytest
import torch

from benchmark import common, harness
from benchmark.tests import _tiny
from jukebox_tpu_torch.models import autoregressive as ar
from jukebox_tpu_torch.models import transformer as tf


def _run(tmp_path, cell, seed):
    base, bench = _tiny.tree(tmp_path)
    return harness.run(bench, cell, seed, 0.2, 0, "cpu", common.now(),
                       base=base)


def _altered_token(monkeypatch):
    real = ar.ConditionalAutoregressive2D._sample_tok

    def sample_tok(logits, gen, temp, top_k, top_p):
        tok = real(logits, gen, temp, top_k, top_p)
        return (tok + 1) % logits.shape[-1]
    monkeypatch.setattr(ar.ConditionalAutoregressive2D, "_sample_tok",
                        staticmethod(sample_tok))


def _state_unchanged(monkeypatch):
    real = tf.stack_layer_step

    def step(p, cache, x, *a, **k):
        return real(p, {n: c.clone() for n, c in cache.items()}, x, *a, **k)
    monkeypatch.setattr(tf, "stack_layer_step", step)


def _half_batch(monkeypatch):
    real = ar.ConditionalAutoregressive2D._decode_one

    def decode_one(self, dec, caches, x_tok, t, x_cond, y_cond, fp16, n):
        logits = real(self, dec, caches, x_tok, t, x_cond, y_cond, fp16, n)
        h = n // 2
        out = logits.clone()
        out[h:] = logits[:n - h].mean(dim=0, keepdim=True)
        return out
    monkeypatch.setattr(ar.ConditionalAutoregressive2D, "_decode_one",
                        decode_one)


def test_a_sound_run_is_correct(tmp_path):
    out = _run(tmp_path, "top.tiny", 987654321012)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,number", [(_altered_token, "logit_gap_max"),
                                          (_state_unchanged, "logit_err"),
                                          (_half_batch, "logit_err")])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault, number):
    fault(monkeypatch)
    out = _run(tmp_path, "top.tiny", 987654321012)
    assert not out["correct"], out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_programs_int8_decode_is_not_correct(tmp_path):
    base, bench = _tiny.tree(tmp_path)
    out = harness.run(bench, "top.tiny", 987654321012, 0.2, 0, "cpu",
                      common.now(), base=base,
                      driver_kwargs=dict(quantize="int8"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["int8_share"]["value"] > \
        out["checks"]["int8_share"]["limit"]


def test_a_sound_training_run_is_correct(tmp_path):
    out = _run(tmp_path, "train.tiny", 24680135790)
    assert out["correct"], out["checks"]


def test_a_training_state_left_unchanged_is_not_correct(tmp_path,
                                                         monkeypatch):
    from jukebox_tpu_torch import train

    def no_update(params, grads, opt_state, *args, **kwargs):
        return torch.zeros(()), torch.zeros(()), True
    monkeypatch.setattr(train, "apply_update", no_update)
    out = _run(tmp_path, "train.tiny", 24680135790)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_training_step_that_leaves_half_its_rows_out_is_not_correct(
        tmp_path):
    base, bench = _tiny.tree(tmp_path)
    out = harness.run(bench, "train.tiny", 24680135790, 0.2, 0, "cpu",
                      common.now(), base=base,
                      driver_kwargs=dict(half_batch=True))
    assert not out["correct"], out["checks"]
