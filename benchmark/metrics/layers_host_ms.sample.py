"""models/transformer.py decode step: the host's ms a decode step in the
layers' decode_step (the port's sample.layers spans) over the traced
segment's sample.step spans; None without traced steps, or where the
layers ran without the host (a CUDA graph's replay)."""

from benchmark import recorder


def read(r):
    found = recorder.decode_steps()
    if found is None or not found[2]:
        return None
    steps, _, layers_ns = found
    return layers_ns / len(steps) / 1e6
