"""The device: percent of the traced segment with no operation running."""

from benchmark import readers


def read(r):
    return readers.idle_share(r)
