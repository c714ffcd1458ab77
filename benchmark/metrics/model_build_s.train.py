"""models/make_models.py factories: the seconds make_vqvae and make_prior
took to build the models (the port's coarse make.vqvae and make.prior
spans, each a call's mean), part of the set-up; None where neither ran."""

from benchmark import recorder


def read(r):
    return recorder.mean_seconds("make.vqvae", "make.prior")
