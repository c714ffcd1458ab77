"""Kernel families: each file holds the names its kernels take in a trace
(PATTERN) and the bytes and FLOPs of its launches computed from shapes
(launches(work, hparams))."""
