"""Mean wall milliseconds a request spends inside the vocabulary's
normalize call (the benchmark's span around it)."""

from tmbench.harness.readers import spans_ns


def read(ctx):
    if not ctx["units"] or not ctx["spans"].by_name.get("normalize"):
        return None
    return spans_ns(ctx, "normalize") / 1e6 / ctx["units"]
