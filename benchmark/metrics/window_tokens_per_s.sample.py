"""models/autoregressive.py token loop: codes sampled by all rows over the
whole window (every segment and every sample_init in it) per second of the
host's clock. The host's own speed moves it by 10-25% from one run to the
next, so it is read here and not held to a bound."""

from benchmark import readers


def read(r):
    if not readers.segments(r):
        return None
    return r.window["tokens"] / r.window["seconds"]
