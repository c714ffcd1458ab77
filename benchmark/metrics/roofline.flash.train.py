"""csrc/flash_attention.cu flash_fwd, flash_dq, flash_dkv: percent of
their roofline in the traced step."""

from benchmark import readers


def read(r):
    return readers.roofline(r, "flash")
