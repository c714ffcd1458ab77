"""The device: percent of the traced step with no operation running."""

from benchmark import readers


def read(r):
    return readers.idle_share(r)
