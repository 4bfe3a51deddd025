"""Scan-shareable single-pass analyzers (reference §2.3 of SURVEY.md;
the counterpart of ``deequ_tpu/analyzers/scan.py``).

Each analyzer contributes a ScanOp to the fused device pass. Null/where
semantics mirror the reference exactly:

- denominators use "conditional count" = number of rows satisfying the
  ``where`` filter (ALL such rows, including nulls in the target column —
  reference analyzers/Analyzer.scala:428-434);
- numerators and value aggregates skip nulls (Spark aggregate semantics).

Per-chunk moments (stddev/correlation) are centred on the chunk-local
mean on the device and combined across chunks with the reference's
Chan/Welford merge (StandardDeviation.scala:37-44, Correlation.scala:37-52).

PatternMatch, MinLength/MaxLength and DataType wait for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from deequ_tpu_torch.analyzers.base import (
    ScanShareableAnalyzer,
    State,
    has_column,
    is_numeric,
    metric_from_failure,
    metric_from_value,
)
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    SumState,
)
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.exceptions import EmptyStateException
from deequ_tpu_torch.expr.eval import compile_predicate
from deequ_tpu_torch.metrics import DoubleMetric, Entity
from deequ_tpu_torch.ops.scan_engine import (
    ScanOp,
    masked_comoments,
    masked_count,
    masked_extremum,
    masked_moments,
    masked_sum,
)


def _compile_where(where: Optional[str]):
    """Compile an optional where filter -> (predicate fn or None, columns)."""
    if where is None:
        return None, set()
    return compile_predicate(where)


def _rows(vals, row_valid, n, predicate):
    if predicate is None:
        return row_valid
    return row_valid & predicate(vals, n, row_valid.device)


def _col_mask(val):
    """Validity mask of a column Val (string columns: code >= 0)."""
    if val.kind == "str":
        return val.data >= 0
    return val.mask


def _empty_state_failure(analyzer: "StandardScanAnalyzer"):
    return EmptyStateException(
        f"Empty state for analyzer {analyzer!r}, all input values were NULL."
    )


class StandardScanAnalyzer(ScanShareableAnalyzer):
    """Shortcut base for analyzers producing one DoubleMetric
    (reference StandardScanShareableAnalyzer, Analyzer.scala:200-226)."""

    metric_name: str = ""

    @property
    def instance(self) -> str:
        return getattr(self, "column", "*")

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def compute_metric_from(self, state: Optional[State]) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(_empty_state_failure(self))
        return metric_from_value(
            state.metric_value(), self.metric_name, self.instance, self.entity
        )

    def to_failure_metric(self, exception: Exception) -> DoubleMetric:
        return metric_from_failure(
            exception, self.metric_name, self.instance, self.entity
        )


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Size(StandardScanAnalyzer):
    """Row count, optionally filtered (reference analyzers/Size.scala:23-48)."""

    where: Optional[str] = None

    metric_name = "Size"

    @property
    def instance(self) -> str:
        return "*"

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, cols = _compile_where(self.where)

        def update(vals, row_valid, n, capacity):
            return {"n": masked_count(_rows(vals, row_valid, n, pred))}

        return ScanOp(tuple(sorted(cols)), update, {"n": "sum"})

    def state_from_scan_result(self, result) -> Optional[NumMatches]:
        return NumMatches(int(result["n"]))


@dataclass(frozen=True)
class Completeness(StandardScanAnalyzer):
    """Fraction of non-null values (reference analyzers/Completeness.scala)."""

    column: str
    where: Optional[str] = None

    metric_name = "Completeness"

    def preconditions(self):
        return [has_column(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column

        def update(vals, row_valid, n, capacity):
            rows = _rows(vals, row_valid, n, pred)
            return {
                "matches": masked_count(rows & _col_mask(vals[col])),
                "count": masked_count(rows),
            }

        return ScanOp(
            tuple(sorted(wcols | {col})), update,
            {"matches": "sum", "count": "sum"},
        )

    def state_from_scan_result(self, result) -> Optional[NumMatchesAndCount]:
        return NumMatchesAndCount(int(result["matches"]), int(result["count"]))


@dataclass(frozen=True)
class Compliance(StandardScanAnalyzer):
    """Fraction of rows satisfying a predicate
    (reference analyzers/Compliance.scala:24-53)."""

    instance_name: str
    predicate: str
    where: Optional[str] = None

    metric_name = "Compliance"

    @property
    def instance(self) -> str:
        return self.instance_name

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        crit, ccols = compile_predicate(self.predicate)

        def update(vals, row_valid, n, capacity):
            rows = _rows(vals, row_valid, n, pred)
            return {
                "matches": masked_count(rows & crit(vals, n, row_valid.device)),
                "count": masked_count(rows),
            }

        return ScanOp(
            tuple(sorted(wcols | ccols)), update,
            {"matches": "sum", "count": "sum"},
        )

    def state_from_scan_result(self, result) -> Optional[NumMatchesAndCount]:
        return NumMatchesAndCount(int(result["matches"]), int(result["count"]))


class _ExtremumAnalyzer(StandardScanAnalyzer):
    """Shared machinery for Minimum/Maximum (value) analyzers."""

    _tag: str = "min"

    def preconditions(self):
        return [has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column
        tag = self._tag

        def update(vals, row_valid, n, capacity):
            v = vals[col]
            ok = _rows(vals, row_valid, n, pred) & v.mask
            return {
                "value": masked_extremum(v.data, ok, tag),
                "n": masked_count(ok),
            }

        return ScanOp(
            tuple(sorted(wcols | {col})), update, {"value": tag, "n": "sum"}
        )

    def state_from_scan_result(self, result):
        if int(result["n"]) == 0:
            return None
        value = float(result["value"])
        return MinState(value) if self._tag == "min" else MaxState(value)


@dataclass(frozen=True)
class Minimum(_ExtremumAnalyzer):
    column: str
    where: Optional[str] = None
    metric_name = "Minimum"
    _tag = "min"


@dataclass(frozen=True)
class Maximum(_ExtremumAnalyzer):
    column: str
    where: Optional[str] = None
    metric_name = "Maximum"
    _tag = "max"


class _SumAnalyzer(StandardScanAnalyzer):
    """Shared machinery for Mean/Sum: (sum, count) of non-null values."""

    def preconditions(self):
        return [has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column

        def update(vals, row_valid, n, capacity):
            v = vals[col]
            ok = _rows(vals, row_valid, n, pred) & v.mask
            return {"sum": masked_sum(v.data, ok), "n": masked_count(ok)}

        return ScanOp(
            tuple(sorted(wcols | {col})), update, {"sum": "sum", "n": "sum"}
        )


@dataclass(frozen=True)
class Mean(_SumAnalyzer):
    """Mean over non-null values (reference analyzers/Mean.scala:25-54)."""

    column: str
    where: Optional[str] = None

    metric_name = "Mean"

    def state_from_scan_result(self, result) -> Optional[MeanState]:
        if int(result["n"]) == 0:
            return None
        return MeanState(float(result["sum"]), int(result["n"]))


@dataclass(frozen=True)
class Sum(_SumAnalyzer):
    column: str
    where: Optional[str] = None

    metric_name = "Sum"

    def state_from_scan_result(self, result) -> Optional[SumState]:
        if int(result["n"]) == 0:
            return None
        return SumState(float(result["sum"]))


@dataclass(frozen=True)
class StandardDeviation(StandardScanAnalyzer):
    """Population stddev via mergeable (n, avg, m2) moments
    (reference analyzers/StandardDeviation.scala:25-73)."""

    column: str
    where: Optional[str] = None

    metric_name = "StandardDeviation"

    def preconditions(self):
        return [has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column

        def update(vals, row_valid, n, capacity):
            v = vals[col]
            ok = _rows(vals, row_valid, n, pred) & v.mask
            cnt, mean, m2 = masked_moments(v.data, ok)
            return {"n": cnt, "avg": mean, "m2": m2}

        return ScanOp(
            tuple(sorted(wcols | {col})), update,
            {"n": "gather", "avg": "gather", "m2": "gather"},
        )

    def state_from_scan_result(self, result) -> Optional[StandardDeviationState]:
        state = StandardDeviationState(0.0, 0.0, 0.0)
        for n, avg, m2 in zip(result["n"], result["avg"], result["m2"]):
            state = state.sum(StandardDeviationState(float(n), float(avg), float(m2)))
        if state.n == 0:
            return None
        return state


@dataclass(frozen=True)
class Correlation(StandardScanAnalyzer):
    """Pearson correlation via mergeable co-moment state
    (reference analyzers/Correlation.scala:26-105). Only rows where BOTH
    columns are non-null participate (Spark Corr semantics)."""

    first_column: str
    second_column: str
    where: Optional[str] = None

    metric_name = "Correlation"

    _FIELDS = ("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk")

    @property
    def instance(self) -> str:
        return f"{self.first_column},{self.second_column}"

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def preconditions(self):
        return [
            has_column(self.first_column),
            is_numeric(self.first_column),
            has_column(self.second_column),
            is_numeric(self.second_column),
        ]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        ca, cb = self.first_column, self.second_column

        def update(vals, row_valid, n, capacity):
            va, vb = vals[ca], vals[cb]
            ok = _rows(vals, row_valid, n, pred) & va.mask & vb.mask
            return dict(zip(self._FIELDS, masked_comoments(va.data, vb.data, ok)))

        return ScanOp(
            tuple(sorted(wcols | {ca, cb})), update,
            {k: "gather" for k in self._FIELDS},
        )

    def state_from_scan_result(self, result) -> Optional[CorrelationState]:
        arrays = [np.atleast_1d(result[f]) for f in self._FIELDS]
        state = CorrelationState(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        for row in zip(*arrays):
            state = state.sum(CorrelationState(*(float(x) for x in row)))
        if state.n == 0:
            return None
        return state
