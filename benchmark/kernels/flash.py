"""csrc/flash_attention.cu flash_fwd_kernel, flash_dq_kernel,
flash_dkv_kernel: the dense (pattern 0) layers of a training step, at
[batch, heads, L, head dim] bf16, causal. A step runs the forward once,
and once more where each block is recomputed in the backward (c_res),
then dq and dk/dv once. Bytes: q, k, v and the output (and for the
backward the output's gradient, the row statistics and the gradients
written), each once; FLOPs: the causal half of each product (forward 2,
dq 3, dk/dv 4 products of L x L x head dim)."""

import re

from benchmark.reference import prior as ref

PATTERN = re.compile(r"flash_(fwd|dq|dkv)_kernel")


def layer_launches(B, H, L, hd, recompute):
    elems = B * H * L * hd
    pairs = B * H * L * (L + 1) // 2
    fwd = (4 * elems * 2 + B * H * L * 4, 2 * 2 * pairs * hd)
    dq = (5 * elems * 2 + 2 * B * H * L * 4, 3 * 2 * pairs * hd)
    dkv = (6 * elems * 2 + 2 * B * H * L * 4, 4 * 2 * pairs * hd)
    return [fwd] * (2 if recompute else 1) + [dq, dkv]


def launches(work, hp):
    out = []
    L, _, _ = ref.geometry(hp)
    A = int(hp["m_attn"] * hp["prior_width"])
    H = hp["heads"]
    for w in work:
        if w["kind"] != "train_step":
            continue
        for d in range(hp["prior_depth"]):
            if ref.attn_func(hp, d) == 0:
                out += layer_launches(w["batch"], H, L, A // H,
                                      w["recompute"])
    return out
