"""csrc/adam.cu adam_kernel: one launch a training step over every
trainable tensor. Bytes per parameter: the fp32 master read and written,
the fp32 gradient read, each moment read and written (2 bytes each in
fp16, 4 in fp32); FLOPs about 12 a parameter."""

import re

PATTERN = re.compile(r"adam_kernel")


def launches(work, hp):
    out = []
    for w in work:
        if w["kind"] != "train_step":
            continue
        mb = 2 if w["fp16_moments"] else 4
        n = w["params"]
        out.append((n * (4 + 4 + 4 + 4 * mb), 12 * n))
    return out
