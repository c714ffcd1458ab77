"""The whole training step's share of the chip's peak: model FLOPs (6 x
non-embedding parameters x tokens, plus the attention of each layer's
pattern, forward and backward; no recompute) over the window's mean step
wall x 989 TFLOP/s, percent."""

from benchmark import readers


def read(r):
    return readers.train_mfu(r)
