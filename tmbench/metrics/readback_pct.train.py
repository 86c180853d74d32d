"""The program's ``readback`` spans (the one read of a candidate's sums,
which waits for its batches on the card) over the window, summed over
the worker threads: the worker shares may sum past 100%."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "readback")
