"""The benchmark of jukebox_tpu_torch on NVIDIA GPUs.

`python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of ../BENCHMARK.json once and prints one JSON
line. Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel family sits in a file of its own (configs/, traffic/,
metrics/, kernels/, limits/), found by the name BENCHMARK.json gives it.
"""
