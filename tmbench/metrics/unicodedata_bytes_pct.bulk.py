"""Share, in %, of the bytes the window's ``nfd`` spans take in that reach
``unicodedata`` (the ``n`` of its spans): how much of the normalizer's
input still goes through Python's NFD, which a text's ASCII bytes need
not.  0 where ``nfd`` spans hold none.  None where the window has no
``nfd`` span, and for a program whose NFD pass opens no ``unicodedata``
span: one without the runs route (``core/normalize.py``'s
``RUNS_MIN_BYTES``), whose every ``nfd`` byte reaches ``unicodedata``
uncounted."""

from tmbench.harness.program import spans


def read(ctx):
    try:
        from tokenmonster_tpu_torch.core.normalize import RUNS_MIN_BYTES  # noqa: F401
    except ImportError:
        return None
    recs = spans(ctx)
    if recs is None:
        return None
    nfd = sum(s.n for s in recs if s.name == "nfd")
    if not nfd:
        return None
    return 100.0 * sum(s.n for s in recs if s.name == "unicodedata") / nfd
