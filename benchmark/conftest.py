"""pytest's hooks for the benchmark's tests (python -m pytest benchmark/tests
-q from the root of a checkout): the tiny copies of the cells added after
benchmark/tests/_tiny.py are named before any test builds a tiny tree."""

from benchmark.tests import _tiny_up0  # noqa: F401
