"""Arithmetic the per-layer readers share: a kernel family's share of its
roofline in the traced part, and the decode step's time and least time
over the measured window."""

import sys

from benchmark import common, peaks
from benchmark.kernels import decode_attn, decode_gemv
from benchmark.reference import prior as ref


def roofline(r, family):
    """Percent: the least time of the family's launches in the traced work
    (from its bytes and FLOPs) over the time its kernels took in the
    trace; None without a trace or without such kernels in it."""
    if r.trace is None:
        return None
    fam = common.load_module("kernels", family)
    seen = r.trace.kernels(fam.PATTERN)
    if not seen:
        return None
    want = fam.launches(r.work, r.hp)
    if len(want) != len(seen):
        print(f"note: {family}: {len(seen)} kernels traced, {len(want)} "
              f"launches in the traced work", file=sys.stderr)
    return 100.0 * peaks.least_ms(want) / (sum(d for _, d in seen) / 1e3)


def segments(r):
    return r.spans.get("segment")


def decode_step_ms(r):
    """The window's segments: synchronised wall over their steps."""
    segs = segments(r)
    steps = sum(a["steps"] for _, _, a in segs)
    if not steps:
        return None
    return 1e3 * sum(e - s for s, e, _ in segs) / steps


def step_bytes_flops(hp, batch, t):
    """The whole decode step's bytes and FLOPs at stream position t: the
    GEMVs, the attention, and the output head (the fp32 token table read
    once, the logits written) with the input row's embedding lookups."""
    _, bins, _ = ref.geometry(hp)
    W = hp["prior_width"]
    parts = (decode_gemv.step_launches(hp, batch)
             + decode_attn.step_launches(hp, batch, t))
    nbytes = sum(b for b, _ in parts) + bins * W * 4 + batch * bins * 4 \
        + batch * W * 4 * 3
    flops = sum(f for _, f in parts) + 2 * batch * W * bins
    return nbytes, flops


def decode_mfu(r):
    """Percent: the window's steps' least time over their wall."""
    segs = segments(r)
    if not segs:
        return None
    least = 0.0
    for _, _, a in segs:
        for i in range(a["steps"]):
            least += peaks.bound(*step_bytes_flops(r.hp, a["batch"],
                                                   a["t"] + i))[0]
    wall_ms = 1e3 * sum(e - s for s, e, _ in segs)
    return 100.0 * least / wall_ms


def idle_share(r):
    if r.trace is None or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def attention_pairs(hp, func):
    """Query-key pairs of one row's full-context attention of pattern
    `func` (causal masks counted as attended only)."""
    L, _, bc = ref.geometry(hp)
    nb = hp["blocks"]
    if func == 0:
        return L * (L + 1) // 2
    if func == 1:
        return nb * bc * (bc + 1) // 2
    if func == 2:
        return bc * nb * (nb + 1) // 2
    if func == 3:
        return L * bc
    if func == 7:
        pl = (hp["n_tokens"] // nb + 1) * nb
        return sum(min(i + 1, pl) for i in range(L))
    raise NotImplementedError(f"pattern {func}")


def train_model_flops(hp, batch):
    """6 x non-embedding parameters x tokens + the attention's products,
    forward and backward (3 x the forward's 4 x pairs x width)."""
    L, _, _ = ref.geometry(hp)
    W = hp["prior_width"]
    A, M = int(hp["m_attn"] * W), int(hp["m_mlp"] * W)
    per_layer = W * 3 * A + 3 * A + A * W + W + W * M + M + M * W + W + 4 * W
    flops = 6 * per_layer * hp["prior_depth"] * batch * L
    for d in range(hp["prior_depth"]):
        flops += 3 * 4 * batch * A * attention_pairs(hp, ref.attn_func(hp, d))
    return flops


def train_mfu(r):
    steps = r.spans.get("step")
    if not steps:
        return None
    wall = sum(e - s for s, e, _ in steps) / len(steps)
    return 100.0 * train_model_flops(r.hp, r.traffic["batch"]) / (
        wall * peaks.PEAK_FLOPS["bf16"])
