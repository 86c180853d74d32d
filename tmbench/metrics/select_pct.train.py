"""Share of the window in the program's ``select`` spans: the master
thread's read of each candidate's result (the deletion votes,
``_select_deletions``, and their tally)."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "select")
