"""Distribution distance between two profiles (reference
analyzers/Distance.scala:19-87; the port's copy of
``deequ_tpu/analyzers/distance.py``, host numpy).

The L-infinity, two-sample Kolmogorov-Smirnov distance between two
numeric KLL sketches or two categorical count maps. Unless the caller
passes ``correct_for_low_number_of_samples=True`` (which returns the raw
statistic, the reference's flag as it is), the robust correction
``linf - 1.8 * sqrt((n + m) / (n * m))`` is applied, floored at 0."""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np

from deequ_tpu_torch.ops.kll import KLLSketchState


def _select_metrics(
    linf_simple: float, n: float, m: float, correct_for_low_number_of_samples: bool
) -> float:
    if correct_for_low_number_of_samples:
        return linf_simple
    return max(0.0, linf_simple - 1.8 * math.sqrt((n + m) / (n * m)))


def _cdf_at(items: np.ndarray, weights: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """The weight of the sketch's items at or below each key."""
    pos = np.searchsorted(items, keys, side="right")
    return np.cumsum(weights)[np.clip(pos - 1, 0, None)] * (pos > 0)


def numerical_distance(
    sample1: KLLSketchState,
    sample2: KLLSketchState,
    correct_for_low_number_of_samples: bool = False,
) -> float:
    """The KS / L-infinity distance between the CDFs of two KLL sketches;
    NaN when either is empty."""
    items1, weights1 = sample1._weighted_items()
    items2, weights2 = sample2._weighted_items()
    if len(items1) == 0 or len(items2) == 0:
        return float("nan")
    n = float(weights1.sum())
    m = float(weights2.sum())
    keys = np.union1d(items1, items2)
    cdf1 = _cdf_at(items1, weights1, keys)
    cdf2 = _cdf_at(items2, weights2, keys)
    linf_simple = float(np.max(np.abs(cdf1 / n - cdf2 / m)))
    return _select_metrics(linf_simple, n, m, correct_for_low_number_of_samples)


def categorical_distance(
    sample1: Mapping[str, int],
    sample2: Mapping[str, int],
    correct_for_low_number_of_samples: bool = False,
) -> float:
    """The L-infinity distance between two categorical count maps; NaN
    when either is empty."""
    n = float(sum(sample1.values()))
    m = float(sum(sample2.values()))
    if n == 0 or m == 0:
        return float("nan")
    keys = set(sample1) | set(sample2)
    linf_simple = max(
        abs(sample1.get(k, 0) / n - sample2.get(k, 0) / m) for k in keys
    )
    return _select_metrics(linf_simple, n, m, correct_for_low_number_of_samples)
