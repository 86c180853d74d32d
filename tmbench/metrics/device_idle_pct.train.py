"""Share of the traced window in which no operation ran on the card
(the union of the trace's device operations)."""

from tmbench.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
