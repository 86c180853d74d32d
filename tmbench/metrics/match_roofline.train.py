"""The match kernel's share of its roofline in the trainer's window: the
least time of every dispatch it matched (each batch row with text, each
strip scored again, each repair lane; the superset's match tables, 22-bit
fields at 2,475,011 entries) by the benchmark's frozen arithmetic, over
the card time of the match kernels in the trace."""

from tmbench.harness.readers import match_roofline_pct


def read(ctx):
    if ctx.get("tables") is None:
        return None
    return match_roofline_pct(ctx)
