"""Mean wall milliseconds a request spends in the program's ``expand`` span:
the host's delete expansion of the downloaded ids (``finish.host_ids``)."""

from tmbench.harness.program import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "expand")
