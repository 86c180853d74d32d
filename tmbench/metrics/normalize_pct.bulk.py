"""Share of the traced window inside the vocabulary's normalize call
(host normalization and capcode; the benchmark's span around it)."""

from tmbench.harness.readers import spans_ns, window_ns


def read(ctx):
    if not ctx["spans"].by_name.get("normalize"):
        return None
    return 100.0 * spans_ns(ctx, "normalize") / window_ns(ctx)
