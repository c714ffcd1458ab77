"""train.py _finish / apply_update (the gradient norm, the scaled Adam
kernel) and the EMA's step: from the backward's mark to the EMA's,
synchronised (the traced run's timed step), ms."""

def read(r):
    parts = [r.spans.get(f"part.{p}") for p in ("update", "ema")]
    if not all(parts):
        return None
    return 1e3 * sum(e - s for p in parts for s, e, _ in p)
