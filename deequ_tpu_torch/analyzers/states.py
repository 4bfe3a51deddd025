"""Concrete algebraic states for the scan analyzers.

Each state mirrors the reference's algebra exactly (merge rules cited per
class) so that incremental computation (state persisted yesterday + today's
delta) is bit-for-bit the same operation as a cross-device merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from deequ_tpu_torch.analyzers.base import DoubleValuedState, State


@dataclass(frozen=True)
class NumMatches(DoubleValuedState):
    """Row-count state (reference analyzers/Size.scala:23-33)."""

    num_matches: int

    def sum(self, other: "NumMatches") -> "NumMatches":
        return NumMatches(self.num_matches + other.num_matches)

    def metric_value(self) -> float:
        return float(self.num_matches)


@dataclass(frozen=True)
class NumMatchesAndCount(DoubleValuedState):
    """Ratio state: matches / count (reference analyzers/Analyzer.scala:230-244)."""

    num_matches: int
    count: int

    def sum(self, other: "NumMatchesAndCount") -> "NumMatchesAndCount":
        return NumMatchesAndCount(
            self.num_matches + other.num_matches, self.count + other.count
        )

    def metric_value(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.num_matches / self.count


@dataclass(frozen=True)
class MinState(DoubleValuedState):
    min_value: float

    def sum(self, other: "MinState") -> "MinState":
        return MinState(min(self.min_value, other.min_value))

    def metric_value(self) -> float:
        return self.min_value


@dataclass(frozen=True)
class MaxState(DoubleValuedState):
    max_value: float

    def sum(self, other: "MaxState") -> "MaxState":
        return MaxState(max(self.max_value, other.max_value))

    def metric_value(self) -> float:
        return self.max_value


@dataclass(frozen=True)
class MeanState(DoubleValuedState):
    """(sum, count) state (reference analyzers/Mean.scala:25-39)."""

    total: float
    count: int

    def sum(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.total / self.count


@dataclass(frozen=True)
class SumState(DoubleValuedState):
    total: float

    def sum(self, other: "SumState") -> "SumState":
        return SumState(self.total + other.total)

    def metric_value(self) -> float:
        return self.total


@dataclass(frozen=True)
class StandardDeviationState(DoubleValuedState):
    """Welford/Chan mergeable moment state (n, avg, m2).

    Merge follows the parallel-variance combination rule used by the
    reference (analyzers/StandardDeviation.scala:37-44).
    """

    n: float
    avg: float
    m2: float

    def sum(self, other: "StandardDeviationState") -> "StandardDeviationState":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        new_n = self.n + other.n
        delta = other.avg - self.avg
        new_avg = self.avg + delta * other.n / new_n
        new_m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / new_n
        return StandardDeviationState(new_n, new_avg, new_m2)

    def metric_value(self) -> float:
        if self.n == 0:
            return float("nan")
        return math.sqrt(self.m2 / self.n)  # population stddev


@dataclass(frozen=True)
class CorrelationState(DoubleValuedState):
    """Pearson co-moment state (n, xAvg, yAvg, ck, xMk, yMk) with the
    pairwise merge rule (reference analyzers/Correlation.scala:37-52)."""

    n: float
    x_avg: float
    y_avg: float
    ck: float  # co-moment  sum((x - xAvg)(y - yAvg))
    x_mk: float  # sum((x - xAvg)^2)
    y_mk: float  # sum((y - yAvg)^2)

    def sum(self, other: "CorrelationState") -> "CorrelationState":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        n1, n2 = self.n, other.n
        new_n = n1 + n2
        dx = other.x_avg - self.x_avg
        dy = other.y_avg - self.y_avg
        new_x_avg = self.x_avg + dx * n2 / new_n
        new_y_avg = self.y_avg + dy * n2 / new_n
        new_ck = self.ck + other.ck + dx * dy * n1 * n2 / new_n
        new_x_mk = self.x_mk + other.x_mk + dx * dx * n1 * n2 / new_n
        new_y_mk = self.y_mk + other.y_mk + dy * dy * n1 * n2 / new_n
        return CorrelationState(new_n, new_x_avg, new_y_avg, new_ck, new_x_mk, new_y_mk)

    def metric_value(self) -> float:
        denom = math.sqrt(self.x_mk) * math.sqrt(self.y_mk)
        if denom == 0 or self.n == 0:
            return float("nan")
        return self.ck / denom


@dataclass(frozen=True)
class DataTypeHistogram(State):
    """Counts of inferred value types; element-wise additive
    (reference analyzers/DataType.scala:44-51). Nulls count as Unknown."""

    num_null: int
    num_fractional: int
    num_integral: int
    num_boolean: int
    num_string: int

    def sum(self, other: "DataTypeHistogram") -> "DataTypeHistogram":
        return DataTypeHistogram(
            self.num_null + other.num_null,
            self.num_fractional + other.num_fractional,
            self.num_integral + other.num_integral,
            self.num_boolean + other.num_boolean,
            self.num_string + other.num_string,
        )

    @property
    def total(self) -> int:
        return (
            self.num_null + self.num_fractional + self.num_integral
            + self.num_boolean + self.num_string
        )
