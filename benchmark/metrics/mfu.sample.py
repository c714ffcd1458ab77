"""The whole decode step's share of the chip's peak: the least time of
each step of the window (the larger of its FLOPs at 989 TFLOP/s and its
bytes at 3.35 TB/s) over the steps' wall, percent. At decode the peak that
binds is bandwidth."""

from benchmark import readers


def read(r):
    return readers.decode_mfu(r)
