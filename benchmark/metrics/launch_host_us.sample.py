"""ops/decode_stack.py wrappers: the host's us a launch in the traced
segment, from the wrapper's checks to the return of its ctypes call (the
port's counters launch_host.<kernel>, all kernels' ns over their calls);
None where no wrapper launched (the CPU's plain paths)."""

from benchmark import recorder


def read(r):
    return recorder.counter_mean_us("launch_host.")
