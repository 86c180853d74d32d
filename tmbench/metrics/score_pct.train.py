"""The program's ``score`` spans (a candidate's strips staged, replayed
16 a batch and their sums read back, ``parallel/score.py``) over the
window, summed over the worker threads: the worker shares may sum past
100%."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "score")
