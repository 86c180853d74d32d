"""Share, in %, of the card's idle time in the window during which no
``tokenize`` span of the program is open on any thread: what the
program's spans leave unaccounted for."""

from tmbench.harness.program import idle_outside_pct


def read(ctx):
    return idle_outside_pct(ctx, "tokenize")
