"""The program's ``rescore`` spans (the strips whose first pass did not
hold, scored again op by op) over the window, summed over the worker
threads: the worker shares may sum past 100%."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "rescore")
