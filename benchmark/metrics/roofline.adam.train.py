"""csrc/adam.cu adam_update: percent of its roofline in the traced
step."""

from benchmark import readers


def read(r):
    return readers.roofline(r, "adam")
