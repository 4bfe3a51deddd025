"""Analyzer and State core (reference layer L3, analyzers/Analyzer.scala).

**State is a commutative monoid** (``sum`` merges two states,
analyzers/Analyzer.scala:30-48) and every analyzer is

    map -> partial state per chunk,  merge across chunks,  finalize to metric.

On the card that is one fused pass per scan with the chunk partials folded
on the device (ops/scan_engine.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Sequence

from deequ_tpu_torch.data.table import ColumnarTable, DType, Schema
from deequ_tpu_torch.exceptions import (
    DeviceUnavailableException,
    NoColumnsSpecifiedException,
    NoSuchColumnException,
    NumberOfSpecifiedColumnsException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
from deequ_tpu_torch.metrics import DoubleMetric, Entity, Metric
from deequ_tpu_torch.tryresult import Failure, Success


class State(ABC):
    """A sufficient statistic forming a commutative monoid under ``sum``."""

    @abstractmethod
    def sum(self, other: "State") -> "State":
        """Merge two states (commutative, associative)."""

    def __add__(self, other: "State") -> "State":
        return self.sum(other)


class DoubleValuedState(State):
    """A state that can finalize directly to a double metric value."""

    @abstractmethod
    def metric_value(self) -> float:
        ...


# -- Preconditions (reference analyzers/Analyzer.scala:285-359) -------------


def has_column(column: str) -> Callable[[Schema], None]:
    def check(schema: Schema) -> None:
        if not schema.has_column(column):
            raise NoSuchColumnException(column)

    return check


def is_numeric(column: str) -> Callable[[Schema], None]:
    def check(schema: Schema) -> None:
        if schema.has_column(column) and not schema[column].dtype.is_numeric:
            raise WrongColumnTypeException(
                f"Expected type of column {column} to be one of numeric types, "
                f"but found {schema[column].dtype.value} instead!"
            )

    return check


def is_string(column: str) -> Callable[[Schema], None]:
    def check(schema: Schema) -> None:
        if schema.has_column(column) and schema[column].dtype != DType.STRING:
            raise WrongColumnTypeException(
                f"Expected type of column {column} to be string, but found "
                f"{schema[column].dtype.value} instead!"
            )

    return check


def at_least_one(columns: Sequence[str]) -> Callable[[Schema], None]:
    def check(schema: Schema) -> None:
        if len(columns) == 0:
            raise NoColumnsSpecifiedException(
                "At least one column needs to be specified!"
            )

    return check


def exactly_n_columns(columns: Sequence[str], n: int) -> Callable[[Schema], None]:
    def check(schema: Schema) -> None:
        if len(columns) != n:
            raise NumberOfSpecifiedColumnsException(
                f"{n} columns have to be specified! Currently, columns contains "
                f"only {len(columns)} column(s): {','.join(columns)}!"
            )

    return check


def find_first_failing(
    schema: Schema, conditions: Sequence[Callable[[Schema], None]]
) -> Optional[Exception]:
    """Return the first failing precondition's exception, if any."""
    for condition in conditions:
        try:
            condition(schema)
        except Exception as e:  # noqa: BLE001 — precondition failure is data
            return e
    return None


# -- Analyzer ---------------------------------------------------------------


class Analyzer(ABC):
    """Computes a state S from data and a metric M from the state.

    Mirrors reference Analyzer[S <: State[S], +M <: Metric[_]]
    (analyzers/Analyzer.scala:56-165). Analyzers are immutable, hashable
    values used as dictionary keys in AnalyzerContext.
    """

    @abstractmethod
    def compute_state_from(self, table: ColumnarTable, device) -> Optional[State]:
        ...

    @abstractmethod
    def compute_metric_from(self, state: Optional[State]) -> Metric:
        ...

    @abstractmethod
    def to_failure_metric(self, exception: Exception) -> Metric:
        ...

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return []

    def calculate(
        self,
        table: ColumnarTable,
        device=None,
        aggregate_with=None,
        save_states_with=None,
    ) -> Metric:
        """One analyzer on its own pass, on ``device`` (resolved as the
        entry points resolve it: ``deequ_tpu_torch.device``). With
        ``aggregate_with`` (a StateLoader) the state loaded for this
        analyzer merges into the computed one; with ``save_states_with``
        (a StatePersister) the merged state is saved."""
        from deequ_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        failing = find_first_failing(table.schema, self.preconditions())
        if failing is not None:
            return self.to_failure_metric(failing)
        try:
            state = self.compute_state_from(table, dev)
        except DeviceUnavailableException:
            raise
        except Exception as e:  # noqa: BLE001 — failure is data
            return self.to_failure_metric(wrap_if_necessary(e))
        return self.calculate_metric(state, aggregate_with, save_states_with)

    def calculate_metric(
        self, state: Optional[State], aggregate_with=None, save_states_with=None
    ) -> Metric:
        try:
            if aggregate_with is not None:
                state = merge_states(state, aggregate_with.load(self))
            if save_states_with is not None and state is not None:
                save_states_with.persist(self, state)
            return self.compute_metric_from(state)
        except Exception as e:  # noqa: BLE001
            return self.to_failure_metric(wrap_if_necessary(e))

    def aggregate_state_to(self, source_a, source_b, target) -> None:
        """Merge the states of two loaders into a persister (reference
        Analyzer.scala:130-147)."""
        merged = merge_states(source_a.load(self), source_b.load(self))
        if merged is not None:
            target.persist(self, merged)

    def load_state_and_compute_metric(self, source) -> Metric:
        """The metric of a saved state, with no scan."""
        try:
            return self.compute_metric_from(source.load(self))
        except Exception as e:  # noqa: BLE001
            return self.to_failure_metric(wrap_if_necessary(e))

    def copy_state_to(self, source, target) -> None:
        state = source.load(self)
        if state is not None:
            target.persist(self, state)

    @property
    def name(self) -> str:
        return type(self).__name__


def merge_states(a: Optional[State], b: Optional[State]) -> Optional[State]:
    """Option-aware monoid merge (reference analyzers/Analyzer.scala:366-386)."""
    if a is not None and b is not None:
        return a.sum(b)
    return a if a is not None else b


class ScanShareableAnalyzer(Analyzer):
    """An analyzer whose state computation can fuse into one shared scan.

    Each analyzer contributes a ``ScanOp`` — an update function over one
    chunk's device tensors plus a tagged reduction spec — and the engine
    runs all ops of a run over each chunk once (ops/scan_engine.py).
    """

    @abstractmethod
    def scan_op(self, table: ColumnarTable):
        """Build this analyzer's ScanOp for the given table."""

    @abstractmethod
    def state_from_scan_result(self, result) -> Optional[State]:
        """Convert the op's reduced numpy leaves into a host State."""

    def compute_state_from(self, table: ColumnarTable, device) -> Optional[State]:
        from deequ_tpu_torch.ops.scan_engine import run_scan

        op = self.scan_op(table)
        (result,) = run_scan(table, [op], device)
        return self.state_from_scan_result(result)


def metric_from_value(
    value: float, name: str, instance: str, entity: Entity
) -> DoubleMetric:
    return DoubleMetric(entity, name, instance, Success(float(value)))


def metric_from_failure(
    exception: Exception, name: str, instance: str, entity: Entity
) -> DoubleMetric:
    return DoubleMetric(
        entity, name, instance, Failure(wrap_if_necessary(exception))
    )


def entity_from(columns: Sequence[str]) -> Entity:
    return Entity.COLUMN if len(columns) == 1 else Entity.MULTICOLUMN
