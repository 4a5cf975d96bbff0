"""The statistics the end-to-end metrics and the bounds are taken with."""
from __future__ import annotations

import statistics

import numpy as np


def rate(units: int, seconds: float) -> float:
    """All the work of the window over all of its time."""
    return units / seconds


def p95(values) -> float:
    """The 95th percentile of every value (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, np.float64), 95.0))


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, the quartiles as `statistics.quantiles(values, n=4)`
    gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
