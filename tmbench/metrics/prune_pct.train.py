"""Share of the window in the program's ``prune`` spans: the master
thread's list work in ``train_vocab``'s rounds (the shuffle and draw of
candidates, then the prune and checkpoints)."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "prune")
