"""Analyzer and State core (reference layer L3, analyzers/Analyzer.scala).

**State is a commutative monoid** (``sum`` merges two states,
analyzers/Analyzer.scala:30-48) and every analyzer is

    map -> partial state per chunk,  merge across chunks,  finalize to metric.

On the card that is one fused pass per scan with the chunk partials folded
on the device (ops/scan_engine.py). Over a StreamingTable the fused scan
streams (``ops/scan_engine.py:_run_scan_stream``), and every other
analyzer folds its state a batch at a time, as a tree
(:class:`StreamStateFolder`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Sequence

from deequ_tpu_torch.data.table import ColumnarTable, DType, Schema
from deequ_tpu_torch.exceptions import (
    DeviceUnavailableException,
    NoColumnsSpecifiedException,
    NotYetPortedException,
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
        """One analyzer on its own pass, on ``device`` and its mesh
        (resolved as the entry points resolve them:
        ``parallel/mesh.py:resolve_placement``). With ``aggregate_with`` (a
        StateLoader) the state loaded for this analyzer merges into the
        computed one; with ``save_states_with`` (a StatePersister) the
        merged state is saved."""
        from deequ_tpu_torch.parallel.mesh import resolve_placement, use_mesh

        dev, mesh = resolve_placement(device)
        failing = find_first_failing(table.schema, self.preconditions())
        if failing is not None:
            return self.to_failure_metric(failing)
        try:
            with use_mesh(mesh):
                if getattr(table, "is_streaming", False):
                    state = self.compute_state_from_stream(table, dev)
                else:
                    state = self.compute_state_from(table, dev)
        except (DeviceUnavailableException, NotYetPortedException):
            raise
        except Exception as e:  # noqa: BLE001 — failure is data
            return self.to_failure_metric(wrap_if_necessary(e))
        return self.calculate_metric(state, aggregate_with, save_states_with)

    def compute_state_from_stream(self, stream, device) -> Optional[State]:
        """The state of a StreamingTable: this analyzer's state a batch,
        merged as a tree (:class:`StreamStateFolder`) — the merge used
        across partitions and incremental runs, applied across batches.
        Scan-shareable analyzers stream through the fused scan instead."""
        folder = StreamStateFolder()
        for batch in stream.batches(columns=self._stream_columns()):
            folder.add(self.compute_state_from(batch, device))
        return folder.result()

    def _stream_columns(self) -> Optional[List[str]]:
        """The columns a stream reads for this analyzer (None: all);
        analyzers that know their columns prune the read."""
        return None

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


class StreamStateFolder:
    """Mergesort-style TREE fold of monoid states across stream batches.

    A linear chain (``merged = merged.sum(batch_state)``) merges the whole
    growing state again a batch — O(B · G log G) for frequency states.
    The tree (a binary-counter stack of power-of-two partials) merges each
    state O(log B) times instead, the streaming analogue of the
    reference's treeReduce (KLLRunner.scala:104-112). States whose merge is
    set-like (frequency tables, sorted by key at every merge) are the same
    under any association; scalar float states differ at the ulp level
    only, as any distributed fold's do.

    With ``spill_store`` set (a ``spill.SpillingFrequencyStore``) states
    route into the store instead: it runs its own tree fold under a byte
    budget and spills sorted runs to disk past it, so the fold's host
    memory stays bounded when the merged state is not (high-cardinality
    frequency tables). ``assume_canonical`` says every added state is
    already in canonical key order, which the store verifies before it
    skips a flush's re-sort."""

    def __init__(self, spill_store=None, assume_canonical: bool = False):
        self._stack: list = []  # (level, state); levels strictly decrease toward the top
        self._spill_store = spill_store
        self._assume_canonical = assume_canonical

    def add(self, state: Optional[State]) -> None:
        if state is None:  # an all-null batch contributes no state
            return
        if self._spill_store is not None:
            self._spill_store.add(state, canonical=self._assume_canonical)
            return
        level = 0
        while self._stack and self._stack[-1][0] == level:
            _, prev = self._stack.pop()
            state = prev.sum(state)
            level += 1
        self._stack.append((level, state))

    def result(self) -> Optional[State]:
        if self._spill_store is not None:
            return self._spill_store.result()
        merged: Optional[State] = None
        for _, s in reversed(self._stack):
            merged = s if merged is None else s.sum(merged)
        return merged


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

    def compute_state_from_stream(self, stream, device) -> Optional[State]:
        # the fused scan streams the batches itself, in one pass
        return self.compute_state_from(stream, device)


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
