"""The percentile of a run's call times."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between the closest
    ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

