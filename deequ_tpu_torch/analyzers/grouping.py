"""Grouping (frequency-based) analyzers in their count-stats form
(reference analyzers/GroupingAnalyzers.scala + Uniqueness/Distinctness/
etc.; the counterpart of ``deequ_tpu/analyzers/grouping.py``).

Every analyzer here is a function of the group-count distribution only, so
its state is the device-computed :class:`~deequ_tpu_torch.ops.segment.CountStats`
of its grouping columns; all analyzers of one grouping set share one
computation per run (analyzers/runner.py). The frequency-table state
(``FrequenciesAndNumRows``), Histogram and MutualInformation wait for a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    at_least_one,
    entity_from,
    has_column,
    metric_from_failure,
    metric_from_value,
)
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.exceptions import EmptyStateException
from deequ_tpu_torch.metrics import DoubleMetric, Entity
from deequ_tpu_torch.ops.segment import CountStats, group_count_stats


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

    def compute_state_from(self, table: ColumnarTable, device) -> Optional[CountStats]:
        return group_count_stats(table, self.group_columns, device)


class ScanShareableFrequencyBasedAnalyzer(FrequencyBasedAnalyzer):
    """Computes one double from the grouping's count distribution
    (reference GroupingAnalyzers.scala:83-120)."""

    metric_name: str = ""

    def compute_from_count_stats(self, stats: CountStats) -> float:
        raise NotImplementedError

    def compute_metric_from(self, state: Optional[CountStats]) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self!r}.")
            )
        try:
            value = self.compute_from_count_stats(state)
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

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_groups == 0:
            return float("nan")
        return stats.singletons / stats.num_groups


@dataclass(frozen=True, init=False)
class Distinctness(_ColumnsAnalyzer):
    """#distinct groups / #rows (reference analyzers/Distinctness.scala:29-41)."""

    columns: Tuple[str, ...]

    metric_name = "Distinctness"

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_rows == 0:
            return float("nan")
        return stats.num_groups / stats.num_rows


@dataclass(frozen=True, init=False)
class CountDistinct(_ColumnsAnalyzer):
    """Exact number of distinct groups (reference analyzers/CountDistinct.scala)."""

    columns: Tuple[str, ...]

    metric_name = "CountDistinct"

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

    def compute_from_count_stats(self, stats: CountStats) -> float:
        if stats.num_rows == 0:
            return float("nan")
        return stats.entropy
