"""Share, in %, of the window's ``device`` spans that hold a ``rerun``
span: the calls whose first pass did not hold and ran again op by op
(``GpuTokenizer.run_repaired``)."""

from tmbench.harness.program import holding_pct


def read(ctx):
    return holding_pct(ctx, "device", "rerun")
