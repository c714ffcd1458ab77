"""The port's own span and counter recorder (jukebox_tpu_torch/utils/
profiler.py), read in the harness's process by the per-layer metrics of
source program_span and program_counter. Each reading is None where the
recorder holds nothing to read, and where the port has no recorder."""


def _profiler():
    try:
        from jukebox_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "traced") else None


def traced():
    """What the recorder kept while torch.profiler ran (the traced part):
    {"spans", "counters"}, or None."""
    p = _profiler()
    return None if p is None else p.traced()


def mean_seconds(*names):
    """The sum over `names` of each coarse span's mean seconds a call, from
    the recorder's totals; None if it timed none of them."""
    p = _profiler()
    tot = {} if p is None else p.totals()
    seen = [tot[n] for n in names if n in tot and tot[n]["calls"]]
    if not seen:
        return None
    return sum(t["seconds"] / t["calls"] for t in seen)


def decode_steps():
    """(traced sample.step spans, their host ns, the host ns of their
    sample.layers children), or None without a traced step."""
    rec = traced()
    if rec is None:
        return None
    steps = [s for s in rec["spans"] if s.name == "sample.step"]
    if not steps:
        return None
    ids = {id(s) for s in steps}
    layers = sum(s.end_ns - s.start_ns for s in rec["spans"]
                 if s.name == "sample.layers" and id(s.parent) in ids)
    return steps, sum(s.end_ns - s.start_ns for s in steps), layers


def counter_mean_us(prefix):
    """Mean host us a call over the traced counters named prefix*, or
    None without such calls."""
    rec = traced()
    if rec is None:
        return None
    seen = [c for k, c in rec["counters"].items() if k.startswith(prefix)]
    calls = sum(c["calls"] for c in seen)
    return sum(c["ns"] for c in seen) / calls / 1e3 if calls else None
