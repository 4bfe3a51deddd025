"""StreamingTable — a table handle over a BatchSource, never materialised
(the port's copy of ``deequ_tpu/data/streaming.py``).

Passing a StreamingTable anywhere a ColumnarTable is accepted
(``VerificationSuite.on_data``, ``AnalysisRunner``, ``ColumnProfiler``,
``Histogram``, ...) runs the same analysis out of core:

- the scan-shareable analyzers stream through the fused scan in one
  pipelined pass (``ops/scan_engine.py:run_scan`` sees the handle);
- every other analyzer folds its monoid state a batch at a time
  (``state.sum(compute_state_from(batch))``, as a tree:
  ``analyzers/base.py:StreamStateFolder``) — the merge used across
  partitions and incremental runs, applied across batches.

Host memory stays bounded by a few batches, whatever the dataset's size.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.data.source import BatchSource, TableBatchSource
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType, Field, Schema


class _SchemaColumn:
    """The schema-only view of a streamed column: its name and dtype (all
    the planner needs to build scan ops); data access raises instead of
    materialising the column."""

    __slots__ = ("name", "dtype")

    def __init__(self, name: str, dtype: DType):
        self.name = name
        self.dtype = dtype

    def __getattr__(self, item):
        raise AttributeError(
            f"column {self.name!r} belongs to a StreamingTable; its data is "
            f"never materialized — iterate table.batches() instead"
        )


class StreamingTable:
    """Out-of-core table: a schema and a batch iterator, no resident data."""

    is_streaming = True
    is_persisted = False
    _device_cache = None

    def __init__(
        self,
        source: BatchSource,
        transforms: Optional[
            List[Tuple[Callable[[ColumnarTable], ColumnarTable], frozenset]]
        ] = None,
        schema_override: Optional[Schema] = None,
        group_memory_budget: Optional[int] = None,
        retry_policy=None,
    ):
        # each transform is (fn, input columns): the inputs join a
        # column-pruned read, so a transform works without a full-width read
        self.source = source
        self._transforms = list(transforms or [])
        self._schema = schema_override or source.schema
        # the host bytes a grouping's frequency state may hold before it
        # spills sorted runs to disk (spill/store.py)
        self.group_memory_budget = group_memory_budget
        # the batch-read retry policy a with_retry handle reads under (the
        # resilient stream loop reads it too: resolve_retry_policy)
        self.retry_policy = retry_policy

    # -- the schema surface (everything the planner touches) ----------------

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def column_names(self) -> List[str]:
        return self._schema.column_names

    @property
    def preferred_batch_rows(self) -> Optional[int]:
        """The batch size the source states (the user's host-memory
        budget; None for a generator source): the streaming scan cuts its
        chunks to it."""
        return getattr(self.source, "_batch_rows", None)

    @property
    def num_rows(self) -> int:
        n = self.source.num_rows
        if n is None:
            raise TypeError(
                "this StreamingTable's source does not know its row count; "
                "use Size() to measure it in a scan"
            )
        return n

    def __contains__(self, name: str) -> bool:
        return self._schema.has_column(name)

    def __getitem__(self, name: str) -> _SchemaColumn:
        f = self._schema[name]
        return _SchemaColumn(f.name, f.dtype)

    def __len__(self) -> int:
        return self.num_rows

    def __repr__(self) -> str:
        return f"StreamingTable({self._schema})"

    # -- batches -------------------------------------------------------------

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        """ColumnarTable batches, pruned to ``columns`` when given."""
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def batches_from(
        self,
        start: int = 0,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        """Batches from batch index ``start`` (the seek a retried read
        reopens at); the transforms apply a batch, as in ``batches``."""
        def src_from(start_idx, read_cols, rows):
            if hasattr(self.source, "batches_from"):
                return self.source.batches_from(start_idx, columns=read_cols,
                                                batch_rows=rows)
            # a duck-typed source with batches() alone
            return BatchSource.batches_from(self.source, start_idx, columns=read_cols,
                                            batch_rows=rows)

        if not self._transforms:
            yield from src_from(start, columns, batch_rows)
            return
        # read the requested columns and every transform's inputs, apply
        # the transforms a batch, then prune to the request
        read: Optional[List[str]] = None
        if columns is not None:
            want = set(columns)
            for _, inputs in self._transforms:
                want |= inputs
            read = [n for n in self.source.schema.column_names if n in want]
        for batch in src_from(start, read, batch_rows):
            for fn, _ in self._transforms:
                batch = fn(batch)
            if columns is not None:
                keep = set(columns)
                batch = batch.select([n for n in batch.column_names if n in keep])
            yield batch

    # -- lazy casts a batch (the profiler's pass 2) ---------------------------

    def with_casts(self, casts: Dict[str, DType]) -> "StreamingTable":
        """A new StreamingTable whose string columns named in ``casts``
        are cast to numeric a batch (an unparsable value becomes null) —
        the out-of-core ColumnProfiler.castColumn."""
        from deequ_tpu_torch.data.cast import cast_string_column

        def transform(batch: ColumnarTable) -> ColumnarTable:
            out = batch
            for name, target in casts.items():
                if name in out and out[name].dtype == DType.STRING:
                    out = out.with_column(cast_string_column(out[name], target))
            return out

        fields = [Field(f.name, casts[f.name]) if f.name in casts else f
                  for f in self._schema]
        return StreamingTable(
            self.source,
            self._transforms + [(transform, frozenset(casts))],
            Schema(fields),
            group_memory_budget=self.group_memory_budget,
            retry_policy=self.retry_policy,
        )

    def with_group_memory_budget(self, budget_bytes: int) -> "StreamingTable":
        """A new handle whose grouping analyses spill frequency states to
        disk past ``budget_bytes`` of host memory (``spill/``): host memory
        stays bounded whatever the number of distinct groups."""
        return StreamingTable(
            self.source,
            self._transforms,
            self._schema,
            group_memory_budget=int(budget_bytes),
            retry_policy=self.retry_policy,
        )

    def with_retry(self, policy=None) -> "StreamingTable":
        """A new handle whose batch reads run under ``policy`` (a
        ``resilience.retry.RetryPolicy``; None: ``DEFAULT_IO_RETRY``): a
        transient source error costs a backoff and a reopen at the batch,
        not the run. Every consumer (the fused scan, the grouping folds,
        the profiler) reads through it."""
        from deequ_tpu_torch.resilience.retry import DEFAULT_IO_RETRY, RetryingBatchSource

        policy = policy if policy is not None else DEFAULT_IO_RETRY
        return StreamingTable(
            RetryingBatchSource(self.source, policy),
            self._transforms,
            self._schema,
            group_memory_budget=self.group_memory_budget,
            retry_policy=policy,
        )

    # -- materialisation guards ------------------------------------------------

    def persist(self, device=None) -> "StreamingTable":
        raise TypeError(
            "a StreamingTable cannot be persisted to the device — it is unbounded "
            "by design; read it into a ColumnarTable first if it fits"
        )

    def unpersist(self) -> "StreamingTable":
        return self

    def collect(self, batch_rows: Optional[int] = None) -> ColumnarTable:
        """The whole stream as one table (tests and small sources only)."""
        merged: Optional[ColumnarTable] = None
        for batch in self.batches(batch_rows=batch_rows):
            merged = batch if merged is None else merged.concat(batch)
        return merged if merged is not None else empty_table(self._schema)


def empty_columns(schema: Schema, names: Optional[Sequence[str]] = None) -> List[Column]:
    """Zero-row columns of ``schema`` (of ``names`` when given)."""
    cols = []
    for f in schema:
        if names is not None and f.name not in names:
            continue
        if f.dtype == DType.STRING:
            cols.append(Column(f.name, DType.STRING, codes=np.empty(0, dtype=np.int32),
                               dictionary=np.empty(0, dtype=object)))
        else:
            cols.append(Column(f.name, f.dtype, values=np.empty(0)))
    return cols


def empty_table(schema: Schema) -> ColumnarTable:
    return ColumnarTable(empty_columns(schema))


def is_streaming(table) -> bool:
    return bool(getattr(table, "is_streaming", False))


def stream_table(table: ColumnarTable, batch_rows: Optional[int] = None) -> StreamingTable:
    """An in-memory table as a stream of ``batch_rows``-row batches."""
    return StreamingTable(TableBatchSource(table, batch_rows))
