"""csrc/decode_stack.cu attn_kernel: one launch a layer and decode step
(ring_attn_decode over the layer's ring cache). Rows read follow each
pattern's ring (the yardstick's copy of ops/decode_stack.py
ring_geometry's rules). Bytes: the fp32 query, the new key and value row,
the cache rows read besides it, the row written and the output; FLOPs:
the scores and the weighted sum."""

import re

from benchmark.reference import prior as ref

PATTERN = re.compile(r"attn_kernel")


def rows(hp, func, t):
    """(rows read, whether the written row is among them, whether the step
    writes) of a pattern-`func` layer at stream position t."""
    L, _, bc = ref.geometry(hp)
    if func == 0:
        return t + 1, True, True
    if func == 1:
        return t % bc + 1, True, True
    if func == 2:
        return t // bc + 1, True, True
    if func == 3:
        return bc, False, True
    if func == 7:
        pl = (hp["n_tokens"] // hp["blocks"] + 1) * hp["blocks"]
        return min(t, pl - 1) + 1, t < pl, t < pl
    raise NotImplementedError(f"pattern {func}")


def step_launches(hp, batch, t):
    """[(bytes, flops)] of one decode step's attention launches at t."""
    A = int(hp["m_attn"] * hp["prior_width"])
    B = batch
    out = []
    for d in range(hp["prior_depth"]):
        n, inside, writes = rows(hp, ref.attn_func(hp, d), t)
        old = n - 1 if inside else n
        nbytes = (B * A * 4 + B * 2 * A * 2 + B * old * 2 * A * 2
                  + (B * 2 * A * 2 if writes else 0) + B * A * 2)
        out.append((nbytes, 4 * B * n * A))
    return out


def launches(work, hp):
    out = []
    for w in work:
        if w["kind"] == "decode_step":
            out += step_launches(hp, w["batch"], w["t"])
    return out
