"""models/prior.py sample_init: the seconds of a window's context prefill
(the port's coarse sample.prefill span, its token-by-token tail inside),
the mean over every sample_init of the run; None where none ran."""

from benchmark import recorder


def read(r):
    return recorder.mean_seconds("sample.prefill")
