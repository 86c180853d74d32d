"""Strips scored again op by op over strips scored, in %, in the window:
the device scorer's counters (``trainvocab.scorer_counters``) at the
window's last boundary less those at its first."""


def read(ctx):
    first, last = ctx.get("counters") or ({}, {})
    if "strips_scored" not in last:
        return None
    scored = last["strips_scored"] - first.get("strips_scored", 0)
    if not scored:
        return None
    again = last["strips_rescored"] - first.get("strips_rescored", 0)
    return 100.0 * again / scored
