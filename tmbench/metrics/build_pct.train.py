"""The program's ``build`` spans (each candidate's vocabulary,
``scorer.build``) over the window, summed over the worker threads: two
workers score at once, so this share and the other worker shares may sum
past 100%."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "build")
