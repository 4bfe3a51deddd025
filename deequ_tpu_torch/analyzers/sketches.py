"""Sketch-based analyzers: ApproxCountDistinct (HLL++), KLLSketch,
ApproxQuantile(s) — the counterpart of ``deequ_tpu/analyzers/sketches.py``.

ApproxCountDistinct fuses into the shared scan: its partial state is the
HLL register file (elementwise-max monoid, the reference's register-max
merge, StatefulHyperloglogPlus.scala:121-139), which the scan folds with
the ``max`` tag. Each chunk's registers come from one launch of the
hand-written kernel of ``csrc/hll.cu`` on the card (``ops/hll.py``).

KLLSketch and ApproxQuantile(s) are scan-shareable: the sketch is built
inside the same fused pass (per-chunk sort + deterministic strata
compaction, ops/kll_device.py) and folded on the host from the one fetch.
Where-free KLL ops of one sketch size are coalesced by the runner into one
batched sort a chunk (:func:`_kll_multi_scan_op`). Each KLL op of a sketch
size up to ``MAX_SELECT_SKETCH_SIZE`` also carries a ``select_update``
that makes the same summary with the radix select (ops/select_device.py);
a scan of a persisted table runs it (ops/scan_plan.py).

ApproxQuantile(s): the reference uses Spark's GK percentile digest
(StatefulApproxQuantile). Here, as in ``deequ_tpu``, both are backed by
the same KLL sketch, with the sketch size chosen from the requested
relative error.
"""

from __future__ import annotations

import math
import numbers
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import (
    DoubleValuedState,
    ScanShareableAnalyzer,
    State,
    has_column,
    is_numeric,
    metric_from_failure,
    metric_from_value,
)
from deequ_tpu_torch.analyzers.scan import _compile_where, _rows
from deequ_tpu_torch.data.table import ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    wrap_if_necessary,
)
from deequ_tpu_torch.metrics import (
    BucketDistribution,
    BucketValue,
    DoubleMetric,
    Entity,
    KeyedDoubleMetric,
    KLLMetric,
)
from deequ_tpu_torch.ops import hll as hll_ops
from deequ_tpu_torch.ops.kll import (
    DEFAULT_SHRINKING_FACTOR,
    DEFAULT_SKETCH_SIZE,
    KLLSketchState,
)
from deequ_tpu_torch.ops.kll_device import (
    chunk_summary,
    chunk_summary_batched,
    fold_summaries,
)
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, ScanOp
from deequ_tpu_torch.ops.select_device import (
    MAX_SELECT_SKETCH_SIZE,
    chunk_summary_select,
    chunk_summary_select_batched,
)
from deequ_tpu_torch.tryresult import Failure, Success, Try


# -- ApproxCountDistinct ----------------------------------------------------


@dataclass(frozen=True)
class ApproxCountDistinctState(DoubleValuedState):
    """HLL register file; merge = elementwise register max.

    ``hash_version`` stamps which hash suite filled the registers (2 = the
    u32 fmix32 suite of numeric and boolean columns, 1 = host xxHash64 of
    string columns). Registers hashed with different suites count
    DIFFERENT bucketings of the same values — merging them double-counts,
    so sum() refuses."""

    registers: Tuple[int, ...]
    hash_version: int = hll_ops.HASH_VERSION

    def sum(self, other: "ApproxCountDistinctState") -> "ApproxCountDistinctState":
        if len(self.registers) != len(other.registers):
            raise ValueError("cannot merge HLL states with different precision")
        if self.hash_version != other.hash_version:
            raise ValueError(
                f"cannot merge HLL registers hashed with different suites "
                f"(v{self.hash_version} vs v{other.hash_version}); recompute "
                f"the older state with this version"
            )
        return ApproxCountDistinctState(
            tuple(max(a, b) for a, b in zip(self.registers, other.registers)),
            self.hash_version,
        )

    def metric_value(self) -> float:
        return hll_ops.estimate_cardinality(np.array(self.registers))


@dataclass(frozen=True)
class ApproxCountDistinct(ScanShareableAnalyzer):
    """Approximate distinct count via HLL++
    (reference analyzers/ApproxCountDistinct.scala:26-64)."""

    column: str
    where: Optional[str] = None

    metric_name = "ApproxCountDistinct"

    def preconditions(self):
        return [has_column(self.column)]

    @property
    def instance(self) -> str:
        return self.column

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        pred, wcols = _compile_where(self.where)
        col = self.column
        string = table[col].dtype == DType.STRING
        p = hll_ops.precision_from_relative_sd()
        lut_key = f"hll_ir_p{p}"
        hash_version = hll_ops.STRING_HASH_VERSION if string else hll_ops.HASH_VERSION

        def update(vals, row_valid, n, capacity):
            v = vals[col]
            rows = _rows(vals, row_valid, n, pred)
            if string:
                # the kernel drops null codes itself; gathers the host LUT
                valid = None if pred is None else rows
                regs = hll_ops.registers(v.data, valid, p, lut=v.lut(lut_key))
            else:
                valid = None if pred is None and v.mask is row_valid else rows & v.mask
                regs = hll_ops.registers(v.data, valid, p)
            # the suite rides the result (tag "max": identity across chunk
            # merges) so state_from_scan_result can stamp the state
            return {
                "registers": regs,
                "hash_version": torch.full(
                    (), hash_version, dtype=torch.int32, device=regs.device
                ),
            }

        luts = (
            ((col, lut_key, lambda d, _p=p: hll_ops.string_idx_rank_lut(d, _p)),)
            if string else ()
        )
        return ScanOp(
            tuple(sorted(wcols | {col})), update,
            {"registers": "max", "hash_version": "max"}, luts=luts,
        )

    def state_from_scan_result(self, result) -> Optional[ApproxCountDistinctState]:
        regs = np.asarray(result["registers"]).astype(np.int64)
        return ApproxCountDistinctState(
            tuple(int(r) for r in regs), int(np.asarray(result["hash_version"]))
        )

    def compute_metric_from(self, state) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        return metric_from_value(
            state.metric_value(), self.metric_name, self.instance, Entity.COLUMN
        )

    def to_failure_metric(self, exception: Exception) -> DoubleMetric:
        return metric_from_failure(
            exception, self.metric_name, self.instance, Entity.COLUMN
        )


# -- KLL state shared by KLLSketch / ApproxQuantile(s) ----------------------


@dataclass
class KLLState(State):
    """KLL sketch + global min/max (reference analyzers/KLLSketch.scala:42-73)."""

    sketch: KLLSketchState
    global_min: float
    global_max: float

    def sum(self, other: "KLLState") -> "KLLState":
        return KLLState(
            self.sketch.merge(other.sketch),
            min(self.global_min, other.global_min),
            max(self.global_max, other.global_max),
        )


@dataclass(frozen=True)
class KLLParameters:
    """(reference analyzers/KLLSketch.scala:82)"""

    sketch_size: int = DEFAULT_SKETCH_SIZE
    shrinking_factor: float = DEFAULT_SHRINKING_FACTOR
    number_of_buckets: int = 100


MAXIMUM_ALLOWED_DETAIL_BINS = 100

_KLL_TAGS = {
    "items": "gather",
    "weights": "gather",
    "count": "sum",
    "min": "min",
    "max": "max",
}


def _kll_scan_op(column: str, sketch_size: int, where: Optional[str] = None) -> ScanOp:
    """Device KLL summary as a fused-scan op: sort the chunk, compact to
    strata midpoints + exact remainder (ops/kll_device.py), gather the
    small weighted summary. Its width comes from the scan's chunk
    capacity, so a short last chunk gives a summary of the same width."""
    pred, wcols = _compile_where(where)

    def update(vals, row_valid, n, capacity):
        v = vals[column]
        SCAN_STATS.record_kll_sort(1)
        return chunk_summary(
            v.data, _rows(vals, row_valid, n, pred) & v.mask, sketch_size, capacity
        )

    def update_select(vals, row_valid, n, capacity):
        v = vals[column]
        return chunk_summary_select(
            v.data, _rows(vals, row_valid, n, pred) & v.mask, sketch_size, capacity
        )

    # where-free single-column KLL ops are coalescible into one batched
    # sort (see _kll_multi_scan_op / runner._coalesce_scan_ops)
    hint = ("kll", sketch_size, column) if where is None else None
    return ScanOp(
        tuple(sorted(wcols | {column})), update, dict(_KLL_TAGS), batch_hint=hint,
        sorts_chunk=True,
        select_update=update_select if sketch_size <= MAX_SELECT_SKETCH_SIZE else None,
        select_size=sketch_size,
    )


def _kll_multi_scan_op(columns: Tuple[str, ...], sketch_size: int) -> ScanOp:
    """N same-parameter KLL columns as ONE op: stack to (K, n) and run one
    batched sort + strata compaction (ops/kll_device.py). The runner builds
    it from coalescible single-column ops and slices each analyzer's result
    back out (:func:`_kll_multi_extract`)."""

    def stacked(vals):
        return (torch.stack([vals[c].data for c in columns]),
                torch.stack([vals[c].mask for c in columns]))

    def update(vals, row_valid, n, capacity):
        SCAN_STATS.record_kll_sort(len(columns))
        return chunk_summary_batched(*stacked(vals), sketch_size, capacity)

    def update_select(vals, row_valid, n, capacity):
        return chunk_summary_select_batched(*stacked(vals), sketch_size, capacity)

    return ScanOp(
        tuple(sorted(set(columns))), update, dict(_KLL_TAGS), sorts_chunk=True,
        select_update=update_select if sketch_size <= MAX_SELECT_SKETCH_SIZE else None,
        select_size=sketch_size,
    )


def _kll_multi_extract(result, j: int) -> dict:
    """Column j's summary out of a batched KLL result: gathered leaves are
    (chunks, K, k+W), the others (K,)."""
    return {
        "items": np.asarray(result["items"])[:, j].ravel(),
        "weights": np.asarray(result["weights"])[:, j].ravel(),
        "count": np.asarray(result["count"])[j],
        "min": np.asarray(result["min"])[j],
        "max": np.asarray(result["max"])[j],
    }


def _kll_state_from_result(
    result, sketch_size: int, shrinking_factor: float
) -> Optional[KLLState]:
    count = int(np.asarray(result["count"]))
    if count == 0:
        return None
    sketch = fold_summaries(
        result["items"], result["weights"], sketch_size, shrinking_factor
    )
    if sketch is None:
        return None
    # the summary weights must account for every valid row (compaction is
    # weight-preserving): a mismatch means the device summary dropped data
    if sketch.count != count:
        raise AssertionError(
            f"KLL summary weight total {sketch.count} != row count {count}; "
            "device chunk summary lost rows"
        )
    return KLLState(
        sketch, float(np.asarray(result["min"])), float(np.asarray(result["max"]))
    )


@dataclass(frozen=True)
class KLLSketch(ScanShareableAnalyzer):
    """KLL quantile sketch -> equi-width BucketDistribution
    (reference analyzers/KLLSketch.scala:90-176)."""

    column: str
    kll_parameters: Optional[KLLParameters] = None

    @property
    def params(self) -> KLLParameters:
        return self.kll_parameters or KLLParameters()

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self):
        def param_check(schema):
            if self.params.number_of_buckets > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    f"Cannot return KLL Sketch related values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )

        return [param_check, has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        return _kll_scan_op(self.column, self.params.sketch_size)

    def state_from_scan_result(self, result) -> Optional[KLLState]:
        p = self.params
        return _kll_state_from_result(result, p.sketch_size, p.shrinking_factor)

    def compute_metric_from(self, state: Optional[KLLState]) -> KLLMetric:
        if state is None:
            return KLLMetric(
                self.column,
                Failure(EmptyStateException(f"Empty state for analyzer {self!r}.")),
            )

        def build() -> BucketDistribution:
            sketch = state.sketch
            start, end = state.global_min, state.global_max
            nb = self.params.number_of_buckets
            buckets = []
            for i in range(nb):
                low = start + (end - start) * i / nb
                high = start + (end - start) * (i + 1) / nb
                if i == nb - 1:
                    count = sketch.rank(high) - sketch.rank_exclusive(low)
                else:
                    count = sketch.rank_exclusive(high) - sketch.rank_exclusive(low)
                buckets.append(BucketValue(low, high, count))
            parameters = (sketch.shrinking_factor, float(sketch.sketch_size))
            data = tuple(tuple(float(x) for x in buf) for buf in sketch.compactors)
            return BucketDistribution(buckets, parameters, data)

        return KLLMetric(self.column, Try.of(build))

    def to_failure_metric(self, exception: Exception) -> KLLMetric:
        return KLLMetric(self.column, Failure(wrap_if_necessary(exception)))


def _sketch_size_for_error(relative_error: float) -> int:
    """A KLL k giving a rank error comparable to the requested relative
    error of the reference's GK digest (eps ~ O(1/k), constant ~2.3)."""
    return max(256, int(2.3 / max(relative_error, 1e-6)))


def _validate_quantile_type(q) -> None:
    """Construction-time validation: q must be a real number and not NaN.
    The range check is a precondition (``_validate_quantile_range``), so
    it fails the run with a typed metric instead."""
    if not isinstance(q, numbers.Real) or isinstance(q, bool):
        raise IllegalAnalyzerParameterException(
            f"Quantile parameter must be a number, got {q!r}"
        )
    if math.isnan(float(q)):
        raise IllegalAnalyzerParameterException(
            "Quantile parameter must not be NaN"
        )


def _validate_quantile_range(q) -> None:
    """Precondition: q strictly inside (0, 1)."""
    _validate_quantile_type(q)
    if not (0.0 < float(q) < 1.0):
        raise IllegalAnalyzerParameterException(
            "Quantile parameter must be in the open interval (0, 1), "
            f"got {q!r}"
        )


def _validate_quantiles(qs) -> Tuple[float, ...]:
    """ApproxQuantiles arguments at construction: every q type-checked,
    duplicates removed (first occurrence wins, order kept). Emptiness and
    range are precondition failures."""
    seen = []
    for q in tuple(qs):
        _validate_quantile_type(q)
        if q not in seen:
            seen.append(q)
    return tuple(seen)


def _relative_error_check(relative_error: float) -> None:
    if not (0.0 <= relative_error <= 1.0):
        raise IllegalAnalyzerParameterException(
            "Relative error parameter must be in the closed interval [0, 1]"
        )


@dataclass(frozen=True)
class ApproxQuantile(ScanShareableAnalyzer):
    """Single approximate quantile (reference analyzers/ApproxQuantile.scala),
    KLL-backed (module doc)."""

    column: str
    quantile: float
    relative_error: float = 0.01
    where: Optional[str] = None

    def __post_init__(self):
        _validate_quantile_type(self.quantile)

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self):
        def param_check(schema):
            _validate_quantile_range(self.quantile)
            _relative_error_check(self.relative_error)

        return [param_check, has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        return _kll_scan_op(
            self.column, _sketch_size_for_error(self.relative_error), self.where
        )

    def state_from_scan_result(self, result) -> Optional[KLLState]:
        return _kll_state_from_result(
            result, _sketch_size_for_error(self.relative_error), DEFAULT_SHRINKING_FACTOR
        )

    def compute_metric_from(self, state: Optional[KLLState]) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        value = state.sketch.quantile(self.quantile)
        return metric_from_value(value, "ApproxQuantile", self.column, Entity.COLUMN)

    def to_failure_metric(self, exception: Exception) -> DoubleMetric:
        return metric_from_failure(exception, "ApproxQuantile", self.column, Entity.COLUMN)


@dataclass(frozen=True)
class ApproxQuantiles(ScanShareableAnalyzer):
    """Many quantiles from one sketch -> KeyedDoubleMetric
    (reference analyzers/ApproxQuantiles.scala:39-101)."""

    column: str
    quantiles: Tuple[float, ...]
    relative_error: float = 0.01

    def __init__(self, column, quantiles, relative_error=0.01):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "quantiles", _validate_quantiles(quantiles))
        object.__setattr__(self, "relative_error", relative_error)

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self):
        def param_check(schema):
            if not self.quantiles:
                raise IllegalAnalyzerParameterException(
                    "Quantiles parameter must be a non-empty sequence"
                )
            for q in self.quantiles:
                _validate_quantile_range(q)
            _relative_error_check(self.relative_error)

        return [param_check, has_column(self.column), is_numeric(self.column)]

    def scan_op(self, table: ColumnarTable) -> ScanOp:
        return _kll_scan_op(self.column, _sketch_size_for_error(self.relative_error))

    def state_from_scan_result(self, result) -> Optional[KLLState]:
        return _kll_state_from_result(
            result, _sketch_size_for_error(self.relative_error), DEFAULT_SHRINKING_FACTOR
        )

    def compute_metric_from(self, state: Optional[KLLState]) -> KeyedDoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        values = {str(q): state.sketch.quantile(q) for q in self.quantiles}
        return KeyedDoubleMetric(
            Entity.COLUMN, "ApproxQuantiles", self.column, Success(values)
        )

    def to_failure_metric(self, exception: Exception) -> KeyedDoubleMetric:
        return KeyedDoubleMetric(
            Entity.COLUMN, "ApproxQuantiles", self.column,
            Failure(wrap_if_necessary(exception)),
        )
