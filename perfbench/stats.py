"""Order statistics of the benchmark's own (a copy of the serving
metrics' linear-interpolation percentile, so that no program change moves
the yardstick)."""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values`` by linear
    interpolation between the two nearest order statistics."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    pos = q / 100.0 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def median(values) -> float:
    return percentile(values, 50.0)
