"""The benchmark's tests: CPU tests at tiny sizes, and `gpu` tests that
run on the card and skip themselves without one:

    python -m pytest benchmark/tests -q
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself without one")
