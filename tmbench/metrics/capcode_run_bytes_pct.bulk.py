"""Share, in %, of the bytes the window's ``capcode`` spans take in that the
native encoder copies as runs (the ``n`` of its ``runs`` spans): how much
of capcode's input needs no decision.  None where the window has no
``runs`` span: a program whose encoder counts no runs, or one that took
the Python encoder throughout."""

from tmbench.harness.program import spans


def read(ctx):
    recs = spans(ctx)
    if recs is None:
        return None
    runs = [s.n for s in recs if s.name == "runs"]
    capcode = sum(s.n for s in recs if s.name == "capcode")
    if not runs or not capcode:
        return None
    return 100.0 * sum(runs) / capcode
