"""The yardstick's peaks and the least time of a piece of work, copied
from chip_smoke.py (HBM_BYTES_PER_S, PEAK_FLOPS, bound): NVIDIA's data
sheet for the H100 SXM, dense rates without sparsity, at the card's full
700 W. A run reports the card's power limit beside the shares it reads
against them."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}


def bound(nbytes, flops, kind="bf16"):
    """(least milliseconds, "bytes" or "operations"): each input byte read
    once and each output byte written once, at the peak bandwidth, against
    the operations at the peak rate of `kind`; the larger binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def least_ms(launches, kind="bf16"):
    """Sum of each launch's least time, launches [(bytes, flops)]."""
    return sum(bound(b, f, kind)[0] for b, f in launches)
