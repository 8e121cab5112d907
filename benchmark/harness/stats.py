"""Whole-window statistics and the spread that sets a bound."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of all values at
    or below it, over every sample of the window."""
    if not sorted_values:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q * len(sorted_values)))
    return sorted_values[rank - 1]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, with the quartiles
    of ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
