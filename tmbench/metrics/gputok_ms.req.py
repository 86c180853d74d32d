"""Mean wall milliseconds a request spends inside
``GpuTokenizer.tokenize`` (the benchmark's span around it)."""

from tmbench.harness.readers import spans_ns


def read(ctx):
    if not ctx["units"] or not ctx["spans"].by_name.get("gputok"):
        return None
    return spans_ns(ctx, "gputok") / 1e6 / ctx["units"]
