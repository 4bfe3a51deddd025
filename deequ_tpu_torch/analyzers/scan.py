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

The string analyzers (PatternMatch, MinLength/MaxLength, DataType) run
their per-value work once per distinct dictionary value on the host — a
regex, a length, a type class, the last two in the native C++ batch of
``deequ_tpu_torch/native`` — and gather the resulting lookup table by code
on the device inside the fused scan.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from deequ_tpu_torch import native
from deequ_tpu_torch.analyzers.base import (
    ScanShareableAnalyzer,
    State,
    has_column,
    is_numeric,
    is_string,
    metric_from_failure,
    metric_from_value,
)
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    DataTypeHistogram,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    SumState,
)
from deequ_tpu_torch.data.table import ColumnarTable, DType
from deequ_tpu_torch.exceptions import EmptyStateException, wrap_if_necessary
from deequ_tpu_torch.expr.eval import compile_predicate
from deequ_tpu_torch.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
)
from deequ_tpu_torch.tryresult import Failure, Success
from deequ_tpu_torch.ops import masked_reduce as k1
from deequ_tpu_torch.ops.scan_engine import ScanOp


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
            return {"n": k1.count(_rows(vals, row_valid, n, pred))}

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
                "matches": k1.count(rows, _col_mask(vals[col])),
                "count": k1.count(rows),
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
                "matches": k1.count(rows, crit(vals, n, row_valid.device)),
                "count": k1.count(rows),
            }

        return ScanOp(
            tuple(sorted(wcols | ccols)), update,
            {"matches": "sum", "count": "sum"},
        )

    def state_from_scan_result(self, result) -> Optional[NumMatchesAndCount]:
        return NumMatchesAndCount(int(result["matches"]), int(result["count"]))


class Patterns:
    """Built-in patterns (reference analyzers/PatternMatch.scala:57-72):
    RFC-5322-style email, the stephenhay URL pattern, US SSN with
    invalid-range exclusions, and major-brand credit card numbers."""

    # the full public RFC-5322 pattern (emailregex.com), incl. the
    # quoted-local-part and IP-literal alternatives the reference carries
    # (PatternMatch.scala:61)
    EMAIL = (
        r"""(?:[a-z0-9!#$%&'*+/=?^_`{|}~-]+(?:\.[a-z0-9!#$%&'*+/=?^_`{|}~-]+)*"""
        r"""|"(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21\x23-\x5b\x5d-\x7f]"""
        r"""|\\[\x01-\x09\x0b\x0c\x0e-\x7f])*")"""
        r"""@(?:(?:[a-z0-9](?:[a-z0-9-]*[a-z0-9])?\.)+"""
        r"""[a-z0-9](?:[a-z0-9-]*[a-z0-9])?"""
        r"""|\[(?:(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?)\.){3}"""
        r"""(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?|[a-z0-9-]*[a-z0-9]:"""
        r"""(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21-\x5a\x53-\x7f]"""
        r"""|\\[\x01-\x09\x0b\x0c\x0e-\x7f])+)\])"""
    )
    URL = r"""(https?|ftp)://[^\s/$.?#].[^\s]*"""
    SOCIAL_SECURITY_NUMBER_US = (
        r"""(?!219[- ]?09[- ]?9999|078[- ]?05[- ]?1120)"""
        r"""(?!666|000|9\d{2})\d{3}[- ]?(?!00)\d{2}[- ]?(?!0{4})\d{4}"""
    )
    CREDITCARD = (
        r"""\b(?:3[47]\d{2}([ -]?)\d{6}\1\d|"""
        r"""(?:(?:4\d|5[1-5]|65)\d{2}|6011)([ -]?)\d{4}\2\d{4}\2)\d{4}\b"""
    )


@dataclass(frozen=True)
class PatternMatch(StandardScanAnalyzer):
    """Fraction of values matching a regex (reference PatternMatch.scala):
    the regex runs once per distinct dictionary value on the host, and
    the device gathers the boolean LUT by code in the fused scan."""

    column: str
    pattern: str
    where: Optional[str] = None

    metric_name = "PatternMatch"

    def preconditions(self):
        return [has_column(self.column), is_string(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column
        rx = re.compile(self.pattern)
        lut_kind = f"regex:{self.pattern}"

        def build_lut(dictionary):
            return np.array(
                [rx.search(s) is not None for s in dictionary], dtype=np.bool_
            )

        def update(vals, row_valid, n, capacity):
            rows = _rows(vals, row_valid, n, pred)
            v = vals[col]
            hit = v.lut(lut_kind)[v.data.clamp(min=0).long()]
            return {
                "matches": k1.count(rows, hit, v.data >= 0),
                "count": k1.count(rows),
            }

        return ScanOp(
            tuple(sorted(wcols | {col})), update,
            {"matches": "sum", "count": "sum"},
            luts=((col, lut_kind, build_lut),),
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
            rows = _rows(vals, row_valid, n, pred)
            return {
                "value": k1.extremum(v.data, tag, rows, v.mask),
                "n": k1.count(rows, v.mask),
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
            rows = _rows(vals, row_valid, n, pred)
            return {"sum": k1.total(v.data, rows, v.mask), "n": k1.count(rows, v.mask)}

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
            r = k1.moments(v.data, _rows(vals, row_valid, n, pred), v.mask)
            return {"n": r[0], "avg": r[1], "m2": r[2]}

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
            r = k1.comoments(va.data, vb.data, _rows(vals, row_valid, n, pred),
                             va.mask, vb.mask)
            return {f: r[i] for i, f in enumerate(self._FIELDS)}

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


def _utf8_length_lut(dictionary) -> np.ndarray:
    """Length of each dictionary value in code points (native batch), as
    int32, which K1 reads and widens to f64 exactly."""
    return native.utf8_lengths(dictionary).astype(np.int32)


class _LengthAnalyzer(StandardScanAnalyzer):
    """Shared machinery for MinLength/MaxLength (string length extrema):
    lengths are a host LUT over the dictionary; the device gathers it and
    takes the masked min/max in the fused scan."""

    _tag: str = "min"

    def preconditions(self):
        return [has_column(self.column), is_string(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column
        tag = self._tag

        def update(vals, row_valid, n, capacity):
            v = vals[col]
            rows, valid = _rows(vals, row_valid, n, pred), v.data >= 0
            lengths = v.lut("utf8len")[v.data.clamp(min=0).long()]
            return {
                "value": k1.extremum(lengths, tag, rows, valid),
                "n": k1.count(rows, valid),
            }

        return ScanOp(
            tuple(sorted(wcols | {col})), update, {"value": tag, "n": "sum"},
            luts=((col, "utf8len", _utf8_length_lut),),
        )

    def state_from_scan_result(self, result):
        if int(result["n"]) == 0:
            return None
        value = float(result["value"])
        return MinState(value) if self._tag == "min" else MaxState(value)


@dataclass(frozen=True)
class MinLength(_LengthAnalyzer):
    column: str
    where: Optional[str] = None
    metric_name = "MinLength"
    _tag = "min"


@dataclass(frozen=True)
class MaxLength(_LengthAnalyzer):
    column: str
    where: Optional[str] = None
    metric_name = "MaxLength"
    _tag = "max"


class DataTypeInstances(enum.Enum):
    """Inferred value types (reference analyzers/DataType.scala:25-30)."""

    UNKNOWN = "Unknown"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"


# value-classification regexes mirroring StatefulDataType.scala:36-38
_FRACTIONAL_RE = re.compile(r"^(-|\+)? ?\d*\.\d*$")
_INTEGRAL_RE = re.compile(r"^(-|\+)? ?\d*$")
_BOOLEAN_RE = re.compile(r"^(true|false)$")


def _classify_string(s: str) -> int:
    """Slot index for one string value (0 is reserved for null): the plain
    version of the native ``classify_batch``."""
    if _FRACTIONAL_RE.match(s):
        return 1
    if _INTEGRAL_RE.match(s):
        return 2
    if _BOOLEAN_RE.match(s):
        return 3
    return 4


def _classify_dictionary(values) -> np.ndarray:
    """Type class of every distinct value, in the native batch."""
    return native.classify_strings(values)


@dataclass(frozen=True)
class DataType(ScanShareableAnalyzer):
    """Per-value type inference histogram (reference analyzers/DataType.scala):
    each distinct dictionary value is classified once on the host, and the
    device counts a five-slot vector (null, fractional, integral, boolean,
    string) in the fused scan. A column typed numeric or boolean has one
    class for every valid row."""

    column: str
    where: Optional[str] = None

    def preconditions(self):
        return [has_column(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column
        dtype = table[col].dtype

        def update(vals, row_valid, n, capacity):
            rows = _rows(vals, row_valid, n, pred)
            v = vals[col]
            if dtype == DType.STRING:
                lut = v.lut("datatype")[v.data.clamp(min=0).long()]
                classes = torch.where(v.data >= 0, lut, 0)
            else:
                const = {DType.FRACTIONAL: 1, DType.INTEGRAL: 2, DType.BOOLEAN: 3}[dtype]
                classes = torch.where(v.mask, const, 0)
            return {"counts": [k1.count(rows, classes == k) for k in range(5)]}

        luts = (
            ((col, "datatype", _classify_dictionary),)
            if dtype == DType.STRING
            else ()
        )
        return ScanOp(
            tuple(sorted(wcols | {col})), update, {"counts": "sum"}, luts=luts,
        )

    def state_from_scan_result(self, result) -> Optional[DataTypeHistogram]:
        c = np.asarray(result["counts"]).astype(np.int64)
        return DataTypeHistogram(*(int(x) for x in c))

    def compute_metric_from(self, state: Optional[DataTypeHistogram]) -> HistogramMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        return HistogramMetric(self.column, Success(to_distribution(state)))

    def to_failure_metric(self, exception: Exception) -> HistogramMetric:
        return HistogramMetric(self.column, Failure(wrap_if_necessary(exception)))


def to_distribution(hist: DataTypeHistogram) -> Distribution:
    """DataTypeHistogram -> 5-bin Distribution (DataType.scala:95-115).
    Nulls are reported under 'Unknown'; ratios over ALL observations."""
    total = hist.total
    counts = {
        DataTypeInstances.UNKNOWN.value: hist.num_null,
        DataTypeInstances.FRACTIONAL.value: hist.num_fractional,
        DataTypeInstances.INTEGRAL.value: hist.num_integral,
        DataTypeInstances.BOOLEAN.value: hist.num_boolean,
        DataTypeInstances.STRING.value: hist.num_string,
    }
    values = {
        k: DistributionValue(v, (v / total) if total else 0.0)
        for k, v in counts.items()
    }
    return Distribution(values, number_of_bins=5)


def determine_type(dist: Distribution) -> DataTypeInstances:
    """The type a DataType histogram decides (reference DataType.scala:
    116-143): Unknown when every value is null; String when any value is
    a string, or booleans mix with numbers; then Boolean, Fractional,
    Integral."""

    def ratio_of(key: DataTypeInstances) -> float:
        dv = dist.values.get(key.value)
        return dv.ratio if dv else 0.0

    if ratio_of(DataTypeInstances.UNKNOWN) == 1.0:
        return DataTypeInstances.UNKNOWN
    if ratio_of(DataTypeInstances.STRING) > 0.0 or (
        ratio_of(DataTypeInstances.BOOLEAN) > 0.0
        and (
            ratio_of(DataTypeInstances.INTEGRAL) > 0.0
            or ratio_of(DataTypeInstances.FRACTIONAL) > 0.0
        )
    ):
        return DataTypeInstances.STRING
    if ratio_of(DataTypeInstances.BOOLEAN) > 0.0:
        return DataTypeInstances.BOOLEAN
    if ratio_of(DataTypeInstances.FRACTIONAL) > 0.0:
        return DataTypeInstances.FRACTIONAL
    return DataTypeInstances.INTEGRAL
