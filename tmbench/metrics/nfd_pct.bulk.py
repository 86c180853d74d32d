"""Share of the window in the program's ``nfd`` span: the normalizer's
pass (NFD through ``unicodedata``, ``core/normalize.py::_nfd``)."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "nfd")
