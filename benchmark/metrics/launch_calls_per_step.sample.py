"""ops/decode_stack.py wrappers, the host launch path: the traced
segment's runtime and driver launch calls (kernels and graph replays) per
decode step; None where the trace holds no launch call."""

def read(r):
    steps = sum(1 for w in r.work if w["kind"] == "decode_step")
    if r.trace is None or not steps or not r.trace.launches:
        return None
    return r.trace.launches / steps
