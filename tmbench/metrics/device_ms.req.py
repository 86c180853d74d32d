"""Mean wall milliseconds a request spends in the program's ``device`` span
(``GpuTokenizer.tokenize``), the inside counterpart of ``gputok_ms.req``."""

from tmbench.harness.program import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "device")
