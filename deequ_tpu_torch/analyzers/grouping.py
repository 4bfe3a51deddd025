"""Grouping (frequency-based) analyzers (reference analyzers/
GroupingAnalyzers.scala + Uniqueness/Distinctness/etc.; the counterpart of
``deequ_tpu/analyzers/grouping.py``).

All analyzers over one distinct set of grouping columns share ONE
computation per run (analyzers/runner.py). Where every analyzer of a set
is a function of the group-count distribution alone (Uniqueness,
UniqueValueRatio, Distinctness, CountDistinct, Entropy), that computation
is the device-computed :class:`~deequ_tpu_torch.ops.segment.CountStats`;
otherwise (MutualInformation) it is the columnar frequency table,
:class:`FrequenciesAndNumRows`, a mergeable monoid: merging two tables is
a null-safe outer join adding counts (GroupingAnalyzers.scala:127-147).
Histogram runs its own pass: its top-N is ranked on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    State,
    at_least_one,
    entity_from,
    exactly_n_columns,
    find_first_failing,
    has_column,
    metric_from_failure,
    metric_from_value,
)
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import (
    DeviceUnavailableException,
    EmptyStateException,
    IllegalAnalyzerParameterException,
    wrap_if_necessary,
)
from deequ_tpu_torch.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
)
from deequ_tpu_torch.ops.segment import (
    NULL_FIELD_REPLACEMENT,
    CountStats,
    column_key_codes,
    group_counts_state,
    group_top_k,
)
from deequ_tpu_torch.tryresult import Failure, Try


def _cell_to_python(value, is_null: bool):
    """Typed array cell -> the python object the dict API exposes."""
    if is_null:
        return None
    if isinstance(value, np.generic):
        value = value.item()
    return value


def _column_from_cells(cells: list):
    """Python group cells (one grouping column) -> (typed values, nulls).

    Chooses the narrowest homogeneous dtype. Numeric mixing (bool/int/
    float) follows python-dict key semantics (True == 1, 5 == 5.0 share a
    slot); strings mixed with non-strings have no faithful typed
    representation (stringifying would merge 5 with '5'), so that
    refuses."""
    nulls = np.array([c is None for c in cells], dtype=bool)
    present = [c for c in cells if c is not None]
    if present and all(isinstance(c, bool) for c in present):
        fill, dtype = False, np.bool_
    elif present and all(
        isinstance(c, int) and not isinstance(c, bool) for c in present
    ):
        fill, dtype = 0, np.int64
    elif present and all(isinstance(c, (int, float)) for c in present):
        fill, dtype = 0.0, np.float64
    elif present and not all(isinstance(c, str) for c in present):
        raise TypeError(
            "group keys mix strings with non-strings in one column; "
            "the columnar frequency state cannot represent that without "
            "silently collapsing keys like 5 and '5'"
        )
    else:
        fill, dtype = "", None  # np.str_, width from data
    vals = [fill if c is None else c for c in cells]
    if dtype is None:
        values = np.array([str(v) for v in vals], dtype=np.str_)
    else:
        values = np.array(vals, dtype=dtype)
    return values, nulls


# single NaN object shared by every canonicalized NaN key: dict lookup
# succeeds via the identity fast path even though nan != nan
_CANONICAL_NAN = float("nan")


class FrequenciesAndNumRows(State):
    """Group frequencies + total row count (rows with at least one grouping
    column non-null). Merge = add counts across the union of groups.

    Columnar: one typed numpy array + null mask per grouping column, plus
    an int64 counts vector, so the merge, MutualInformation and the
    count-distribution metrics are vectorized array ops. The dict-shaped
    API (``from_dict``/``as_dict``/``frequencies``) is the compatibility
    boundary for tests and small states."""

    def __init__(
        self,
        columns: Sequence[str],
        key_values: Tuple[np.ndarray, ...],
        key_nulls: Tuple[np.ndarray, ...],
        counts: np.ndarray,
        num_rows: int,
    ):
        self.columns = tuple(columns)
        self.key_values = tuple(np.asarray(v) for v in key_values)
        self.key_nulls = tuple(np.asarray(m, dtype=bool) for m in key_nulls)
        self.counts = np.asarray(counts, dtype=np.int64)
        self.num_rows = int(num_rows)

    # -- compatibility boundary (python dict of group tuples) ---------------

    @staticmethod
    def from_dict(
        columns: Sequence[str], frequencies: Dict[tuple, int], num_rows: int
    ) -> "FrequenciesAndNumRows":
        # distinct float('nan') objects are distinct dict keys; the
        # columnar path collapses NaN keys into one group, so canonicalize
        canon: Dict[tuple, int] = {}
        for g, c in frequencies.items():
            key = tuple(
                _CANONICAL_NAN if isinstance(x, float) and x != x else x
                for x in g
            )
            canon[key] = canon.get(key, 0) + c
        items = sorted(canon.items(), key=lambda kv: repr(kv[0]))
        key_values = []
        key_nulls = []
        for i in range(len(tuple(columns))):
            values, nulls = _column_from_cells([g[i] for g, _ in items])
            key_values.append(values)
            key_nulls.append(nulls)
        counts = np.array([c for _, c in items], dtype=np.int64)
        return FrequenciesAndNumRows(
            tuple(columns), tuple(key_values), tuple(key_nulls), counts,
            num_rows,
        )

    @property
    def frequencies(self) -> Tuple[Tuple[tuple, int], ...]:
        """Materialized ((cell, ...), count) items — O(#groups) python
        objects, off the hot paths. A NaN key is the one shared NaN object,
        so two states with a NaN group compare equal by ``as_dict``."""
        cols = [
            [_CANONICAL_NAN if x != x else x for x in v.tolist()]
            if v.dtype.kind == "f" else v.tolist()
            for v in self.key_values
        ]
        nulls = [m.tolist() for m in self.key_nulls]
        counts = self.counts.tolist()
        return tuple(
            (
                tuple(None if nulls[i][g] else cols[i][g] for i in range(len(cols))),
                counts[g],
            )
            for g in range(len(counts))
        )

    def as_dict(self) -> Dict[tuple, int]:
        return dict(self.frequencies)

    # -- vectorized core ----------------------------------------------------

    def _code_columns(self, arrays=None, nulls=None):
        """Factorize each key column -> dense int codes (0 = null); all NaN
        keys form one group."""
        arrays = self.key_values if arrays is None else arrays
        nulls = self.key_nulls if nulls is None else nulls
        codes = []
        for v, nl in zip(arrays, nulls):
            if v.dtype.kind == "f":
                _, inv = np.unique(v, return_inverse=True, equal_nan=True)
            else:
                _, inv = np.unique(v, return_inverse=True)
            codes.append(np.where(nl, 0, inv.reshape(v.shape) + 1))
        return codes

    def sum(self, other: "FrequenciesAndNumRows") -> "FrequenciesAndNumRows":
        if self.columns != other.columns:
            raise ValueError(
                f"cannot merge frequency states over different columns: "
                f"{self.columns} vs {other.columns}"
            )
        cat_vals = []
        cat_nulls = []
        numeric = set("iufb")
        for (a, an), (b, bn) in zip(
            zip(self.key_values, self.key_nulls),
            zip(other.key_values, other.key_nulls),
        ):
            ka, kb = a.dtype.kind, b.dtype.kind
            if ka != kb and not (ka in numeric and kb in numeric):
                # mismatched key kinds: legitimate only when one side's
                # column is entirely null — adopt the typed side; a genuine
                # string-vs-numeric merge would stringify keys, so refuse
                if bool(an.all()):
                    a = np.zeros(len(a), dtype=b.dtype)
                elif bool(bn.all()):
                    b = np.zeros(len(b), dtype=a.dtype)
                else:
                    raise ValueError(
                        f"cannot merge frequency states with mismatched "
                        f"group-key types ({a.dtype} vs {b.dtype}) for "
                        f"columns {self.columns}"
                    )
            # numeric promotion matches dict semantics (5 and 5.0 share a
            # key); integer -> float64 is faithful only within 2^53
            common = np.promote_types(a.dtype, b.dtype)
            for arr in (a, b):
                if arr.dtype.kind in "iu" and common.kind == "f" and len(arr) and (
                    int(arr.max()) > 2 ** 53 or int(arr.min()) < -(2 ** 53)
                ):
                    raise ValueError(
                        "cannot merge integer group keys above 2^53 into a "
                        "float64-promoted key space: promotion would "
                        "collapse distinct keys"
                    )
            cat_vals.append(np.concatenate([a.astype(common), b.astype(common)]))
            cat_nulls.append(np.concatenate([an, bn]))
        cat_counts = np.concatenate([self.counts, other.counts])
        if len(cat_counts) == 0:
            return FrequenciesAndNumRows(
                self.columns, tuple(cat_vals), tuple(cat_nulls), cat_counts,
                self.num_rows + other.num_rows,
            )
        code_cols = self._code_columns(cat_vals, cat_nulls)
        order = np.lexsort(tuple(reversed(code_cols)))
        mat = np.stack(code_cols)[:, order]
        boundary = np.any(mat[:, 1:] != mat[:, :-1], axis=0)
        starts = np.concatenate([[0], np.nonzero(boundary)[0] + 1])
        merged_counts = np.add.reduceat(cat_counts[order], starts)
        sel = order[starts]
        return FrequenciesAndNumRows(
            self.columns,
            tuple(v[sel] for v in cat_vals),
            tuple(nl[sel] for nl in cat_nulls),
            merged_counts.astype(np.int64),
            self.num_rows + other.num_rows,
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, FrequenciesAndNumRows):
            return NotImplemented
        return (
            self.columns == other.columns
            and self.num_rows == other.num_rows
            and self.as_dict() == other.as_dict()
        )

    __hash__ = None  # mutable ndarray payload; never used as a dict key

    def __repr__(self) -> str:
        return (
            f"FrequenciesAndNumRows(columns={self.columns}, "
            f"num_groups={self.num_groups}, num_rows={self.num_rows})"
        )

    @property
    def num_groups(self) -> int:
        return len(self.counts)


class FrequencyBasedAnalyzer(Analyzer):
    """Base class for analyzers operating on group frequencies."""

    @property
    def group_columns(self) -> List[str]:
        raise NotImplementedError

    @property
    def instance(self) -> str:
        return ",".join(self.group_columns)

    @property
    def entity(self) -> Entity:
        return entity_from(self.group_columns)

    def preconditions(self):
        cols = self.group_columns
        return [at_least_one(cols)] + [has_column(c) for c in cols]

    def compute_state_from(
        self, table: ColumnarTable, device
    ) -> Optional[FrequenciesAndNumRows]:
        return group_counts_state(table, self.group_columns, device)


class ScanShareableFrequencyBasedAnalyzer(FrequencyBasedAnalyzer):
    """Computes one double from the grouping's frequencies (reference
    GroupingAnalyzers.scala:83-120). Every subclass here is a function of
    the count distribution alone, so the runner computes it from
    device-side :class:`CountStats` when nobody needs the frequency table
    (``metric_from_count_stats``); from a frequency table it takes
    ``compute_from_frequencies``."""

    metric_name: str = ""

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        raise NotImplementedError

    def compute_from_count_stats(self, stats: CountStats) -> float:
        raise NotImplementedError

    def metric_from_count_stats(self, stats: CountStats) -> DoubleMetric:
        try:
            value = self.compute_from_count_stats(stats)
        except Exception as e:  # noqa: BLE001 — failure is data
            return self.to_failure_metric(e)
        return metric_from_value(value, self.metric_name, self.instance, self.entity)

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        try:
            value = self.compute_from_frequencies(state)
        except Exception as e:  # noqa: BLE001 — failure is data
            return self.to_failure_metric(e)
        return metric_from_value(value, self.metric_name, self.instance, self.entity)

    def to_failure_metric(self, exception: Exception) -> DoubleMetric:
        return metric_from_failure(
            exception, self.metric_name, self.instance, self.entity
        )


class _ColumnsAnalyzer(ScanShareableFrequencyBasedAnalyzer):
    """A count-stats analyzer over a tuple of grouping columns (a single
    column name is accepted and wrapped)."""

    columns: Tuple[str, ...]

    def __init__(self, columns):
        object.__setattr__(
            self, "columns",
            (columns,) if isinstance(columns, str) else tuple(columns),
        )

    @property
    def group_columns(self) -> List[str]:
        return list(self.columns)


@dataclass(frozen=True, init=False)
class Uniqueness(_ColumnsAnalyzer):
    """Fraction of groups occurring exactly once over all rows
    (reference analyzers/Uniqueness.scala:26-38)."""

    columns: Tuple[str, ...]

    metric_name = "Uniqueness"

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float((state.counts == 1).sum() / state.num_rows)

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_rows == 0:
            return float("nan")
        return stats.singletons / stats.num_rows


@dataclass(frozen=True, init=False)
class UniqueValueRatio(_ColumnsAnalyzer):
    """(#groups with count 1) / (#distinct groups)
    (reference analyzers/UniqueValueRatio.scala:25-44)."""

    columns: Tuple[str, ...]

    metric_name = "UniqueValueRatio"

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_groups == 0:
            return float("nan")
        return float((state.counts == 1).sum() / state.num_groups)

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_groups == 0:
            return float("nan")
        return stats.singletons / stats.num_groups


@dataclass(frozen=True, init=False)
class Distinctness(_ColumnsAnalyzer):
    """#distinct groups / #rows (reference analyzers/Distinctness.scala:29-41)."""

    columns: Tuple[str, ...]

    metric_name = "Distinctness"

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float(state.num_groups / state.num_rows)

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_rows == 0:
            return float("nan")
        return stats.num_groups / stats.num_rows


@dataclass(frozen=True, init=False)
class CountDistinct(_ColumnsAnalyzer):
    """Exact number of distinct groups (reference analyzers/CountDistinct.scala)."""

    columns: Tuple[str, ...]

    metric_name = "CountDistinct"

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        return float(state.num_groups)

    def compute_from_count_stats(self, stats: CountStats) -> float:
        return float(stats.num_groups)


@dataclass(frozen=True)
class Entropy(ScanShareableFrequencyBasedAnalyzer):
    """Shannon entropy over the group distribution
    (reference analyzers/Entropy.scala:28-42)."""

    column: str

    metric_name = "Entropy"

    @property
    def group_columns(self) -> List[str]:
        return [self.column]

    def compute_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        n = state.num_rows
        if n == 0:
            return float("nan")
        p = state.counts.astype(np.float64) / n
        nonzero = p > 0
        return float(-(p[nonzero] * np.log(p[nonzero])).sum())

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_rows == 0:
            return float("nan")
        return stats.entropy


@dataclass(frozen=True, init=False)
class MutualInformation(FrequencyBasedAnalyzer):
    """Mutual information of two columns from the joint frequency table
    (reference analyzers/MutualInformation.scala:35-103). Groups where
    either column is null drop out (the reference's equality joins skip
    null keys)."""

    columns: Tuple[str, ...]

    def __init__(self, column_a, column_b=None):
        cols = tuple(column_a) if column_b is None else (column_a, column_b)
        object.__setattr__(self, "columns", cols)

    @property
    def group_columns(self) -> List[str]:
        return list(self.columns)

    def preconditions(self):
        return [exactly_n_columns(self.columns, 2)] + super().preconditions()

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> DoubleMetric:
        if state is None or state.num_rows == 0:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        # marginals by bincount over the factorized key columns, then one
        # fused log expression over the valid joint groups
        total = state.num_rows
        code_a, code_b = state._code_columns()
        counts = state.counts.astype(np.float64)
        marginal_a = np.bincount(code_a, weights=counts)
        marginal_b = np.bincount(code_b, weights=counts)
        valid = (code_a > 0) & (code_b > 0)
        pxy = counts[valid] / total
        px = marginal_a[code_a[valid]] / total
        py = marginal_b[code_b[valid]] / total
        mi = float(np.sum(pxy * np.log(pxy / (px * py))))
        return metric_from_value(mi, "MutualInformation", self.instance, Entity.MULTICOLUMN)

    def to_failure_metric(self, exception: Exception) -> DoubleMetric:
        return metric_from_failure(
            exception, "MutualInformation", self.instance, Entity.MULTICOLUMN
        )


MAXIMUM_ALLOWED_DETAIL_BINS = 1000


def _stringify(value) -> str:
    """Render a group value the way the reference's string cast does."""
    if value is None:
        return NULL_FIELD_REPLACEMENT
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and value.is_integer():
        return f"{value:.1f}"
    return str(value)


def _stringify_arrays(values: np.ndarray, nulls: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_stringify` over one typed key column (nulls ->
    'NullValue'); agrees cell for cell with the scalar version."""
    if values.dtype.kind in ("U", "S", "O"):
        s = values.astype(np.str_)
    elif values.dtype == np.bool_:
        s = np.where(values, "true", "false")
    elif values.dtype.kind in "iu":
        s = values.astype(np.str_)
    else:
        with np.errstate(invalid="ignore"):
            is_int = np.isfinite(values) & (values == np.floor(values))
        s = np.where(
            is_int, np.char.mod("%.1f", np.where(is_int, values, 0.0)),
            values.astype(np.str_),
        )
    return np.where(nulls, NULL_FIELD_REPLACEMENT, s)


@dataclass(frozen=True)
class Histogram(FrequencyBasedAnalyzer):
    """Full value histogram with an optional binning function and top-N
    detail (reference analyzers/Histogram.scala:41-117). Unlike the other
    grouping analyzers it runs its own pass: nulls become 'NullValue' and
    num_rows counts ALL rows."""

    column: str
    binning_udf: Optional[Callable] = None
    max_detail_bins: int = MAXIMUM_ALLOWED_DETAIL_BINS

    @property
    def group_columns(self) -> List[str]:
        return [self.column]

    def preconditions(self):
        def param_check(schema):
            if self.max_detail_bins > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    f"Cannot return histogram values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )

        return [param_check, has_column(self.column)]

    def _binned_column(self, col: Column, device) -> Column:
        """The binning UDF run once per DISTINCT value some valid row
        references (not once per row as the reference's UDF is), its
        labels stringified at once (the metric stringifies groups anyway),
        and the row codes remapped onto the distinct labels."""
        codes, distinct = column_key_codes(col, device)  # 0 = null
        referenced = np.zeros(len(distinct), dtype=bool)
        referenced[codes[codes > 0] - 1] = True
        labels = np.array(
            [
                _stringify(self.binning_udf(_cell_to_python(v, False)))
                if referenced[i] else ""
                for i, v in enumerate(distinct)
            ],
            dtype=object,
        )
        if len(labels):
            uniq, inv = np.unique(labels.astype(str), return_inverse=True)
        else:
            uniq, inv = np.array([], dtype=object), np.array([], dtype=np.int64)
        new_codes = np.where(
            codes > 0, inv[np.maximum(codes - 1, 0)] if len(inv) else 0, -1
        ).astype(np.int32)
        return Column(col.name, DType.STRING, codes=new_codes, dictionary=uniq)

    def compute_state_from(
        self, table: ColumnarTable, device
    ) -> Optional[FrequenciesAndNumRows]:
        col = table[self.column]
        if self.binning_udf is not None:
            table = ColumnarTable([self._binned_column(col, device)])
        raw = group_counts_state(
            table, [self.column], device, require_any_non_null=False
        )
        # stringify group values, nulls -> NullValue (Histogram.scala:
        # 108-111), merging label collisions (1 vs "1")
        labels = _stringify_arrays(raw.key_values[0], raw.key_nulls[0])
        if len(labels):
            uniq, inv = np.unique(labels, return_inverse=True)
            counts = np.bincount(inv.reshape(-1), weights=raw.counts).astype(np.int64)
        else:
            uniq = np.empty(0, dtype=np.str_)
            counts = np.zeros(0, dtype=np.int64)
        return FrequenciesAndNumRows(
            (self.column,), (uniq,), (np.zeros(len(uniq), dtype=bool),),
            counts, table.num_rows,
        )

    def calculate(self, table: ColumnarTable, device=None) -> HistogramMetric:
        """Without a binning UDF, counts are ranked on the card and only
        max_detail_bins (slot, count) pairs come back and decode — the
        engine-side top() of the reference (Histogram.scala:97-103). Ties
        at the truncation boundary keep the lower slot (dictionary or
        value order). With a UDF the frequency-table path runs."""
        if self.binning_udf is not None:
            return super().calculate(table, device)
        from deequ_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        failing = find_first_failing(table.schema, self.preconditions())
        if failing is not None:
            return self.to_failure_metric(failing)
        try:
            stats = group_top_k(table, self.column, self.max_detail_bins, dev)
        except DeviceUnavailableException:
            raise
        except Exception as e:  # noqa: BLE001 — failure is data
            return self.to_failure_metric(wrap_if_necessary(e))

        def build() -> Distribution:
            # merge stringified collisions (1 vs "1") as the state path does
            merged: Dict[str, int] = {}
            for value, count in stats.top:
                key = _stringify(value)
                merged[key] = merged.get(key, 0) + count
            details = {
                key: DistributionValue(count, count / stats.num_rows)
                for key, count in merged.items()
            }
            return Distribution(details, number_of_bins=stats.num_groups)

        return HistogramMetric(self.column, Try.of(build))

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> HistogramMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )

        def build() -> Distribution:
            # top-N by count over the counts vector; only the selected
            # bins decode to python objects
            counts = state.counts
            k = min(self.max_detail_bins, len(counts))
            order = np.argsort(-counts, kind="stable")
            values = state.key_values[0]
            nulls = state.key_nulls[0]
            if k < len(order) and counts[order[k]] == counts[order[k - 1]]:
                # count ties straddle the truncation boundary: break them
                # by stringified key so the selected bin set is stable
                c_thr = counts[order[k - 1]]
                above = order[counts[order] > c_thr]
                ties = sorted(
                    order[counts[order] == c_thr].tolist(),
                    key=lambda g: str(_cell_to_python(values[g], bool(nulls[g]))),
                )
                order = np.concatenate(
                    [above, np.asarray(ties[: k - len(above)], dtype=order.dtype)]
                )
            else:
                order = order[:k]
            details = {}
            for g in order.tolist():
                cell = _cell_to_python(values[g], bool(nulls[g]))
                details[cell] = DistributionValue(
                    int(counts[g]), int(counts[g]) / state.num_rows
                )
            return Distribution(details, number_of_bins=state.num_groups)

        return HistogramMetric(self.column, Try.of(build))

    def to_failure_metric(self, exception: Exception) -> HistogramMetric:
        return HistogramMetric(self.column, Failure(wrap_if_necessary(exception)))
