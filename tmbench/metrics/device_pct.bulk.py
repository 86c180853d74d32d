"""Share of the window in the program's ``device`` span
(``GpuTokenizer.tokenize``), the inside counterpart of ``gputok_pct.bulk``."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "device")
