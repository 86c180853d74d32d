"""Share of the traced window inside ``GpuTokenizer.tokenize`` (staging,
graph replay, metadata read, download, delete expansion; the benchmark's
span around it)."""

from tmbench.harness.readers import spans_ns, window_ns


def read(ctx):
    if not ctx["spans"].by_name.get("gputok"):
        return None
    return 100.0 * spans_ns(ctx, "gputok") / window_ns(ctx)
