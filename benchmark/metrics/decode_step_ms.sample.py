"""models/autoregressive.py token loop and models/transformer.py decode
step: the window's segments, synchronised wall over their steps, ms."""

from benchmark import readers


def read(r):
    return readers.decode_step_ms(r)
