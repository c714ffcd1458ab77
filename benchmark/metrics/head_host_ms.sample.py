"""models/autoregressive.py token loop: the host's ms a decode step outside
the layers (the embedding, the output head and the token sampler: the
port's sample.step spans less their sample.layers children) in the traced
segment; None without traced steps."""

from benchmark import recorder


def read(r):
    found = recorder.decode_steps()
    if found is None:
        return None
    steps, step_ns, layers_ns = found
    return (step_ns - layers_ns) / len(steps) / 1e6
