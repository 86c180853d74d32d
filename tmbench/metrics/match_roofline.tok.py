"""The match kernel's share of its roofline on the tokenizer's
dispatches: the least time of each staged dispatch's work, by the
benchmark's frozen arithmetic, over the card time of the match kernels in
the trace."""

from tmbench.harness.readers import match_roofline_pct


def read(ctx):
    return match_roofline_pct(ctx)
