"""Share of the window in the program's ``expand`` span: the host's delete
expansion of the downloaded ids (``finish.host_ids``)."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "expand")
