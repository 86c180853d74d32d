"""Share of the window in the program's ``capcode`` span: the native capcode
encoder (``core/capcode.py::encode``)."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "capcode")
