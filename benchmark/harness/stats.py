"""The arithmetic of the end-to-end metrics, over all the work and all
the time of a window: no medians of chunks, no sampling."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest
    value with at least q % of `values` at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def tail_percentile(n: int, q: float, beyond: int = 10) -> float:
    """The highest percentile no higher than q that leaves at least
    `beyond` of n samples strictly above its rank; 100 (the largest)
    where n samples cannot leave that many."""
    if n <= beyond:
        return 100.0
    return min(q, 100.0 * (n - beyond) / n)


def rate(units: float, seconds: float) -> float:
    """All units done over all the seconds they took."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return units / seconds

