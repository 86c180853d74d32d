"""Mean wall milliseconds a request spends in the program's ``wait`` span:
the host blocked on the card (the reads' ``Event.synchronize()``)."""

from tmbench.harness.program import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "wait")
