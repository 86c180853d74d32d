"""Arithmetic of a measured window: every end-to-end number is taken over
all the work and all the time of the window."""

from __future__ import annotations

import statistics


def rate(amount: float, seconds: float) -> float:
    """Work a second over the whole window."""
    return amount / seconds


def tail(values: list, pct: int = 95) -> float:
    """The ``pct``-th percentile of every value (statistics' inclusive
    method: linear between the two nearest ranks)."""
    if len(values) < 2:
        raise ValueError(f"a tail of {len(values)} values")
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]

