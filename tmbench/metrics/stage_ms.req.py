"""Mean wall milliseconds a request spends in the program's ``stage`` span:
the dispatch plan, the pinned buffer, the host copy and the upload's
enqueue (``GpuTokenizer.stage``)."""

from tmbench.harness.program import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "stage")
