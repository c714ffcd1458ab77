"""train.py make_prior_train_step: the VQ-VAE encode, the forward and
the backward of one step, its marks synchronised (the traced run's timed
step), ms."""

def read(r):
    parts = [r.spans.get(f"part.{p}") for p in ("encode", "forward",
                                                  "backward")]
    if not all(parts):
        return None
    return 1e3 * sum(e - s for p in parts for s, e, _ in p)
