"""Repository queries run as scans on the card (the port's copy of
``deequ_tpu/repository/query.py``).

A :class:`RepositoryQuery` — a trend window over one metric series, a
tag-filtered slice, or a cross-tenant aggregate ("completeness of column
X across all tenants this hour") — runs over the columnar repository's
own history table through the same fused scan every verification run
uses: ``run_scan`` over analyzers of the ``value`` column, on the run's
device, with one device-to-host fetch, its passes counted by
``ScanStats``.

Filter predicates (date bounds, series identity, tag equality) evaluate
on the host over the integer code planes, with no decode, and the rows
that pass stay dictionary-encoded through ``filter_rows`` into the scan,
so the card receives 2-byte codes for ``dataset_date`` and ``value``
where their cardinality allows (``encoded_ingest=False`` scans the same
rows decoded, the A/B).

``loader_side_aggregates`` is the baseline: the same query answered
through the loader (every save decoded into AnalysisResults, filtered in
Python, rebuilt into a decoded table, scanned). Both paths end in the
same scan arithmetic, so their results agree bit for bit.

The reference's ``plan_lint`` argument waits for the port's plan lint.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.repository.columnar import REPO_STATS

#: aggregate name -> analyzer factory over the history value plane
_AGGREGATES = {
    "count": lambda: _analyzers_mod().Size(),
    "completeness": lambda: _analyzers_mod().Completeness("value"),
    "mean": lambda: _analyzers_mod().Mean("value"),
    "min": lambda: _analyzers_mod().Minimum("value"),
    "max": lambda: _analyzers_mod().Maximum("value"),
    "sum": lambda: _analyzers_mod().Sum("value"),
    "stddev": lambda: _analyzers_mod().StandardDeviation("value"),
}

DEFAULT_AGGREGATES = ("count", "mean", "min", "max")


def _analyzers_mod():
    import deequ_tpu_torch.analyzers as analyzers

    return analyzers


class RepositoryQuery:
    """One declarative repository query (normalized, hashable-ish).

    - ``analyzers``: restrict to these exact analyzer series (the trend
      window / anomaly-history shape);
    - ``metric_name`` / ``instance``: restrict by flattened identity
      (the cross-tenant shape: ``metric_name="Completeness",
      instance="x"`` is "completeness of column x across all tenants");
    - ``tag_values``: every (key, value) must match the saving
      ``ResultKey``'s tags;
    - ``after`` / ``before``: inclusive dataset-date bounds, identical
      semantics to the loader DSL;
    - ``aggregates``: which reductions run over the matching value rows.
    """

    def __init__(
        self,
        analyzers: Optional[Sequence] = None,
        metric_name: Optional[str] = None,
        instance: Optional[str] = None,
        tag_values: Optional[Dict[str, str]] = None,
        after: Optional[int] = None,
        before: Optional[int] = None,
        aggregates: Sequence[str] = DEFAULT_AGGREGATES,
    ):
        self.analyzers = tuple(analyzers) if analyzers is not None else None
        self.metric_name = metric_name
        self.instance = instance
        self.tag_values = (
            tuple(sorted(tag_values.items())) if tag_values else None
        )
        self.after = after
        self.before = before
        aggregates = tuple(aggregates)
        for agg in aggregates:
            if agg not in _AGGREGATES:
                raise ValueError(
                    f"unknown aggregate {agg!r}; choose from "
                    f"{sorted(_AGGREGATES)}"
                )
        if not aggregates:
            raise ValueError("aggregates must not be empty")
        self.aggregates = aggregates

    def __repr__(self) -> str:
        parts = []
        for name in ("analyzers", "metric_name", "instance", "tag_values",
                     "after", "before"):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v!r}")
        parts.append(f"aggregates={self.aggregates!r}")
        return f"RepositoryQuery({', '.join(parts)})"


@dataclass
class RepositoryQueryResult:
    """What one compiled query returns: the matched-row count, the
    scalar aggregate values, and the full metric objects (failure
    metrics included — an empty window fails its mean typed, never
    silently)."""

    rows: int
    aggregates: Dict[str, float] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)


def _series_code_set(view, query: RepositoryQuery) -> Optional[set]:
    """Global series codes matching the query's identity filters, or
    None when the query does not filter by identity."""
    if (
        query.analyzers is None
        and query.metric_name is None
        and query.instance is None
    ):
        return None
    import json

    from deequ_tpu_torch.repository import serde

    targets = None
    if query.analyzers is not None:
        targets = {
            json.dumps(
                serde.analyzer_to_json(a), sort_keys=True,
                separators=(",", ":"),
            )
            for a in query.analyzers
        }
    out = set()
    for code, (ajson, _entity, name, instance) in enumerate(view.series_meta):
        if targets is not None and ajson not in targets:
            continue
        if query.metric_name is not None and name != query.metric_name:
            continue
        if query.instance is not None and instance != query.instance:
            continue
        out.add(code)
    return out


def _row_mask(view, query: RepositoryQuery) -> np.ndarray:
    mask = np.ones(view.num_rows, dtype=np.bool_)
    if query.after is not None:
        mask &= view.dates >= int(query.after)
    if query.before is not None:
        mask &= view.dates <= int(query.before)
    codes = _series_code_set(view, query)
    if codes is not None:
        if codes:
            wanted = np.fromiter(
                sorted(codes), dtype=np.int32, count=len(codes)
            )
            mask &= np.isin(view.series_codes, wanted)
        else:
            mask &= False
    if query.tag_values:
        for k, v in query.tag_values:
            col = view.tag_codes.get(k)
            if col is None:
                mask &= False
                continue
            idx = -1
            labels = view.tag_labels.get(k, [])
            try:
                idx = labels.index(v)
            except ValueError:
                mask &= False
                continue
            mask &= col == idx
    return mask


def run_repository_query(
    repository,
    query: RepositoryQuery,
    encoded_ingest: Optional[bool] = None,
    device=None,
) -> RepositoryQueryResult:
    """Run ``query`` over the repository's history table as one fused
    scan on ``device`` (default: ``cuda``, or the ambient ``use_device``
    scope; module doc). ``encoded_ingest`` passes straight through to
    ``run_scan``: a query is counted like any verification scan."""
    from deequ_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    view = repository._history_view()
    mask = _row_mask(view, query)
    sub = view.table.filter_rows(mask)

    analyzers = [_AGGREGATES[a]() for a in query.aggregates]
    ctx, scanned = _scan_aggregates(sub, analyzers, dev, encoded_ingest=encoded_ingest)
    if scanned:
        REPO_STATS.query_scan_passes += 1
    REPO_STATS.queries += 1
    REPO_STATS.query_rows_scanned += sub.num_rows

    return _result_from_ctx(query, sub.num_rows, analyzers, ctx)


def _scan_aggregates(table, analyzers, device, encoded_ingest=None):
    """The one scan block both query paths (columnar and loader-side)
    share: they must agree bit for bit, so failure metrics and the scan's
    finalization cannot fork."""
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
    from deequ_tpu_torch.ops.scan_engine import run_scan

    ops, scannable, op_failures = AnalysisRunner._build_scan_ops(
        table, analyzers
    )
    ctx = AnalyzerContext.empty()
    for analyzer, err in op_failures.items():
        ctx.metric_map[analyzer] = analyzer.to_failure_metric(err)
    if not scannable:
        return ctx, False
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
    results = run_scan(table, exec_ops, device, encoded_ingest=encoded_ingest)
    ctx = AnalysisRunner._finalize_scanning_analyzers(
        ctx, scannable, plan, results
    )
    return ctx, True


def _result_from_ctx(query, rows, analyzers, ctx) -> RepositoryQueryResult:
    out = RepositoryQueryResult(rows=rows)
    for agg, analyzer in zip(query.aggregates, analyzers):
        metric = ctx.metric_map.get(analyzer)
        out.metrics[agg] = metric
        if metric is not None and metric.value.is_success:
            out.aggregates[agg] = metric.value.get()
    return out


def loader_side_aggregates(
    repository, query: RepositoryQuery, device=None
) -> RepositoryQueryResult:
    """The baseline: answer the same query through the loader — decode
    every save into AnalysisResults, filter and collect the matching
    values in Python, rebuild a decoded table, and scan it with the same
    aggregate analyzers on ``device`` (encoded ingest off: full-width f64
    planes). Its results equal :func:`run_repository_query`'s bit for
    bit."""
    from deequ_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
    from deequ_tpu_torch.metrics import DoubleMetric
    from deequ_tpu_torch.repository.columnar import series_identity

    loader = repository.load()
    if query.tag_values:
        loader = loader.with_tag_values(dict(query.tag_values))
    if query.after is not None:
        loader = loader.after(query.after)
    if query.before is not None:
        loader = loader.before(query.before)
    if query.analyzers is not None:
        loader = loader.for_analyzers(list(query.analyzers))

    values: List[float] = []
    for result in loader.get():
        for analyzer, metric in result.analyzer_context.metric_map.items():
            if not isinstance(metric, DoubleMetric):
                continue
            if not metric.value.is_success:
                continue
            if not isinstance(metric.value.get(), float):
                continue
            if series_identity(analyzer, metric) is None:
                continue
            if (
                query.metric_name is not None
                and metric.name != query.metric_name
            ):
                continue
            if query.instance is not None and metric.instance != query.instance:
                continue
            values.append(metric.value.get())

    n = len(values)
    table = ColumnarTable([
        Column(
            "value", DType.FRACTIONAL,
            values=np.fromiter(values, dtype=np.float64, count=n),
            mask=np.ones(n, dtype=np.bool_),
        ),
    ])
    analyzers = [_AGGREGATES[a]() for a in query.aggregates]
    ctx, _ = _scan_aggregates(table, analyzers, dev, encoded_ingest=False)
    return _result_from_ctx(query, n, analyzers, ctx)
