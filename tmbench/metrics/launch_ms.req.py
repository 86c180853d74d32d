"""Mean wall milliseconds a request spends in the program's ``launch`` span:
each group's graph load, replay and clones (``GpuTokenizer._run_captured``)."""

from tmbench.harness.program import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "launch")
