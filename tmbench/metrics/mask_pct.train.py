"""The program's ``mask`` spans (a candidate's host masking of the
superset's tables, ``candidate_host_state``, and their upload) over the
window, summed over the worker threads: the worker shares may sum past
100%."""

from tmbench.harness.program import pct_of_window


def read(ctx):
    return pct_of_window(ctx, "mask")
