"""Pipelined incremental analysis — deequ's own workflow over arriving
batches (the port's counterpart of ``deequ_tpu/analyzers/incremental.py``;
reference VerificationSuite.scala:208-229 and the partitioned-update
example).

A serial loop scans batch N, merges its states, evaluates, then starts
batch N+1: one host-to-device copy a plane and one fetch a batch.
``IncrementalAnalysisStream`` micro-batches instead: up to ``window``
arriving batches pack into one host buffer, copy to the card once, scan
batch by batch on views of that copy and fetch once
(``ops/scan_engine.py:run_scan_group``) — each batch's results bit for
bit those of its own scan. Batches the group path cannot take (unequal
sizes, more than one chunk, packer layouts that differ, a persisted
batch, a single batch) take the per-batch scan; a batch that is itself a
StreamingTable runs its streaming scan at once, when its group is
dispatched (the reference's ``incremental.py:180-193``), and its results
wait, like every batch's, to drain in submission order.

State merges (``aggregate_with``/``save_states_with``) and metrics happen
at drain time, in submission order, on the host, so the state chain is
exactly the serial loop's
(tests/test_torch_incremental.py::test_pipelined_stream_equals_serial).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    ScanShareableAnalyzer,
    find_first_failing,
)
from deequ_tpu_torch.analyzers.runner import (
    AnalysisRunner,
    AnalyzerContext,
    _is_grouping_shared,
)
from deequ_tpu_torch.parallel.mesh import resolve_placement, use_mesh
from deequ_tpu_torch.exceptions import wrap_if_necessary


class _Submission:
    __slots__ = ("tag", "data", "ctx", "scanning", "non_scan")

    def __init__(self, tag, data, ctx, scanning, non_scan):
        self.tag = tag
        self.data = data
        self.ctx = ctx  # precondition and op-build failure metrics
        self.scanning = scanning
        self.non_scan = non_scan


class IncrementalAnalysisStream:
    """Sliding-window micro-batch pipeline over arriving batches::

        stream = IncrementalAnalysisStream(
            analyzers, aggregate_with=states, save_states_with=states,
            window=8,
        )
        for key, batch in batches:
            for done_key, ctx in stream.submit(batch, tag=key):
                ...
        for done_key, ctx in stream.close():
            ...

    ``window`` is the group size; at most two groups are held (one
    filling, one scanned and not yet drained). ``device`` and the mesh are
    resolved once, as every entry point resolves them
    (``parallel/mesh.py:resolve_placement``); over a mesh the batches do
    not group (``group_scannable`` declines) and each takes its own
    sharded scan."""

    def __init__(
        self,
        analyzers: Sequence[Analyzer],
        aggregate_with=None,
        save_states_with=None,
        window: int = 8,
        device=None,
    ):
        self.analyzers = list(analyzers)
        self.aggregate_with = aggregate_with
        self.save_states_with = save_states_with
        self.window = max(1, int(window))
        self.device, self.mesh = resolve_placement(device)
        self._buffer: List[_Submission] = []
        # dispatched groups: (entries, scannable, plan, scan, kind), kind
        # "group" (a DeferredGroupScan) or "per-batch" (a list of
        # (scannable, plan, results) an entry)
        self._groups: List[Tuple] = []

    def submit(self, data, tag: Any = None) -> List[Tuple[Any, AnalyzerContext]]:
        """Buffer one batch; dispatch a group when the window fills.
        Returns the (tag, context) pairs of any batches drained now."""
        passed: List[Analyzer] = []
        failure_ctx = AnalyzerContext.empty()
        for analyzer in self.analyzers:
            exc = find_first_failing(data.schema, analyzer.preconditions())
            if exc is None:
                passed.append(analyzer)
            else:
                failure_ctx.metric_map[analyzer] = analyzer.to_failure_metric(exc)
        scanning = [
            a for a in passed
            if isinstance(a, ScanShareableAnalyzer) and not _is_grouping_shared(a)
        ]
        non_scan = [a for a in passed if a not in scanning]
        self._buffer.append(_Submission(tag, data, failure_ctx, scanning, non_scan))
        out: List[Tuple[Any, AnalyzerContext]] = []
        if len(self._buffer) >= self.window:
            self._dispatch_buffered()
            while len(self._groups) > 1:
                out.extend(self._drain_oldest_group())
        return out

    def close(self) -> List[Tuple[Any, AnalyzerContext]]:
        """Dispatch the buffered batches and drain everything (FIFO)."""
        if self._buffer:
            self._dispatch_buffered()
        out: List[Tuple[Any, AnalyzerContext]] = []
        while self._groups:
            out.extend(self._drain_oldest_group())
        return out

    # -- internals ----------------------------------------------------------

    def _dispatch_buffered(self) -> None:
        with use_mesh(self.mesh):
            self._dispatch_buffered_in_scope()

    def _dispatch_buffered_in_scope(self) -> None:
        from deequ_tpu_torch.ops.scan_engine import group_scannable, run_scan_group

        entries, self._buffer = self._buffer, []
        first = entries[0]
        # the group path builds the ops once, from the first batch, so every
        # batch must share its scanning-analyzer set
        if (len(entries) > 1 and first.scanning
                and all(e.scanning == first.scanning for e in entries)):
            ops, scannable, op_fail = AnalysisRunner._build_scan_ops(
                first.data, first.scanning
            )
            tables = [e.data for e in entries]
            layout = group_scannable(tables, ops, self.mesh) if scannable else False
            if layout:
                for entry in entries:
                    for a, err in op_fail.items():
                        entry.ctx.metric_map[a] = a.to_failure_metric(err)
                exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
                try:
                    scan = run_scan_group(tables, exec_ops, self.device, layout)
                except Exception as e:  # noqa: BLE001 — the failure maps
                    # onto every scanning analyzer of every batch
                    wrapped = wrap_if_necessary(e)
                    for entry in entries:
                        for a in scannable:
                            entry.ctx.metric_map[a] = a.to_failure_metric(wrapped)
                    scan = None
                self._groups.append((entries, scannable, plan, scan, "group"))
                return
        per_batch = []
        for entry in entries:
            ctx, scannable, plan, results = AnalysisRunner._dispatch_scanning_analyzers(
                entry.data, entry.scanning, self.device
            )
            entry.ctx += ctx
            per_batch.append((scannable, plan, results))
        self._groups.append((entries, None, None, per_batch, "per-batch"))

    def _drain_oldest_group(self) -> List[Tuple[Any, AnalyzerContext]]:
        entries, scannable, plan, scan, kind = self._groups.pop(0)
        if kind == "group":
            per_table = None
            if scan is not None:
                try:
                    per_table = scan.results()
                except Exception as e:  # noqa: BLE001
                    wrapped = wrap_if_necessary(e)
                    for entry in entries:
                        for a in scannable:
                            entry.ctx.metric_map[a] = a.to_failure_metric(wrapped)
            per_batch = [
                (scannable, plan, None if per_table is None else per_table[k])
                for k in range(len(entries))
            ]
        else:
            per_batch = scan
        out = []
        for entry, (e_scannable, e_plan, results) in zip(entries, per_batch):
            ctx = entry.ctx
            if results is not None:
                ctx = AnalysisRunner._finalize_scanning_analyzers(
                    ctx, e_scannable, e_plan, results,
                    self.aggregate_with, self.save_states_with,
                )
            if entry.non_scan:
                # grouping and own-pass analyzers run their own passes at
                # drain time, still in submission order
                ctx += AnalysisRunner.do_analysis_run(
                    entry.data, entry.non_scan, self.device,
                    aggregate_with=self.aggregate_with,
                    save_states_with=self.save_states_with, mesh=self.mesh,
                )
            out.append((entry.tag, ctx))
        return out
