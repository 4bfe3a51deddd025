"""Column profiler (reference profiles/ColumnProfiler.scala; the port of
``deequ_tpu/profiles/profiler.py``).

Three passes over the data (ColumnProfiler.scala:57-68):

1. generic statistics: Size, and each column's Completeness and
   ApproxCountDistinct (the HLL kernel), with a DataType histogram for a
   string column, whose type is then inferred;
2. numeric statistics: Minimum, Maximum, Mean, StandardDeviation and Sum
   (and, with ``kll_profiling``, a KLLSketch) of every numeric column,
   a string column inferred numeric cast first;
3. exact histograms of the low-cardinality columns (at most
   ``low_cardinality_histogram_threshold`` approximate distinct values,
   120 by default).

Each pass goes through one seam, a "runs" object with the
:class:`OfflineProfileRuns` interface: by default an
``AnalysisRunner.do_analysis_run`` on the run's device, with the
repository options passed through, so saved profiles carry every pass's
metrics and a reusing profile reuses them.

The passes run on ``cuda`` unless the caller asks for the CPU. On a card
the profiler keeps the table resident across its passes (``persist()``),
and the cast table of pass 2 beside it, and frees both when it returns.
Past the resident budget (``MemoryError``) or out of card memory, the
passes stream on the same device; any other failure raises. The CPU has
no resident budget (a host table needs no copy), so there they stream.
A StreamingTable is never persisted: its passes read the source again,
and pass 2 casts its numeric strings a batch at a time
(``StreamingTable.with_casts``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    Completeness,
    DataType,
    Histogram,
    KLLParameters,
    KLLSketch,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.analyzers.scan import DataTypeInstances, determine_type
from deequ_tpu_torch.data.cast import cast_string_column
from deequ_tpu_torch.data.table import ColumnarTable, DType
from deequ_tpu_torch.device import resolve_device
from deequ_tpu_torch.metrics import BucketDistribution, Distribution
from deequ_tpu_torch.ops import scan_engine

DEFAULT_CARDINALITY_THRESHOLD = 120


@dataclass
class ColumnProfile:
    column: str
    completeness: float
    approximate_num_distinct_values: int
    data_type: DataTypeInstances
    is_data_type_inferred: bool
    type_counts: Dict[str, int] = field(default_factory=dict)
    histogram: Optional[Distribution] = None


@dataclass
class StandardColumnProfile(ColumnProfile):
    pass


@dataclass
class NumericColumnProfile(ColumnProfile):
    kll: Optional[BucketDistribution] = None
    mean: Optional[float] = None
    maximum: Optional[float] = None
    minimum: Optional[float] = None
    sum: Optional[float] = None
    std_dev: Optional[float] = None
    approx_percentiles: Optional[List[float]] = None


@dataclass
class ColumnProfiles:
    profiles: Dict[str, ColumnProfile]
    num_records: int

    def to_json(self) -> str:
        """The reference's JSON of the profiles, field for field."""
        columns = []
        for profile in self.profiles.values():
            entry = {
                "column": profile.column,
                "dataType": profile.data_type.value,
                "isDataTypeInferred": str(profile.is_data_type_inferred).lower(),
                "completeness": profile.completeness,
                "approximateNumDistinctValues": profile.approximate_num_distinct_values,
            }
            if profile.type_counts:
                entry["typeCounts"] = dict(profile.type_counts)
            if profile.histogram is not None:
                entry["histogram"] = [
                    {"value": k, "count": v.absolute, "ratio": v.ratio}
                    for k, v in profile.histogram.values.items()
                ]
            if isinstance(profile, NumericColumnProfile):
                for key, value in (
                    ("mean", profile.mean),
                    ("maximum", profile.maximum),
                    ("minimum", profile.minimum),
                    ("sum", profile.sum),
                    ("stdDev", profile.std_dev),
                ):
                    if value is not None:
                        entry[key] = value
                if profile.approx_percentiles:
                    entry["approxPercentiles"] = profile.approx_percentiles
            columns.append(entry)
        return json.dumps({"columns": columns})


_NATIVE_TYPES = {
    DType.FRACTIONAL: DataTypeInstances.FRACTIONAL,
    DType.INTEGRAL: DataTypeInstances.INTEGRAL,
    DType.BOOLEAN: DataTypeInstances.BOOLEAN,
}

_NUMERIC = (DataTypeInstances.INTEGRAL, DataTypeInstances.FRACTIONAL)


class OfflineProfileRuns:
    """The profiler's default pass executor: each analyzer set runs as one
    ``do_analysis_run`` with ``run_kwargs`` (the device and the
    repository options) passed through."""

    def __init__(self, run_kwargs: Dict):
        self.run_kwargs = run_kwargs

    def run(self, table, analyzers):
        """One profiling pass -> AnalyzerContext."""
        return AnalysisRunner.do_analysis_run(table, analyzers, **self.run_kwargs)


def _persist_for_passes(table: ColumnarTable, device: torch.device, persisted: list) -> None:
    """Keep ``table`` resident on ``device`` for the passes (and note it in
    ``persisted``, for the caller to free) where the device has a resident
    budget and the table is not resident already. Past the budget or out
    of card memory the passes stream on the same device; anything else
    raises."""
    if (table.is_persisted or getattr(table, "is_streaming", False)
            or not scan_engine.has_resident_budget(device)):
        return  # a stream is never persisted: it is unbounded by design
    try:
        table.persist(device)
    except (MemoryError, torch.cuda.OutOfMemoryError):
        table.unpersist()
        return
    persisted.append(table)


class ColumnProfiler:
    @staticmethod
    def profile(
        data: ColumnarTable,
        restrict_to_columns: Optional[Sequence[str]] = None,
        print_status_updates: bool = False,
        low_cardinality_histogram_threshold: int = DEFAULT_CARDINALITY_THRESHOLD,
        metrics_repository=None,
        reuse_existing_results_using_key=None,
        fail_if_results_for_reusing_missing: bool = False,
        save_in_metrics_repository_using_key=None,
        kll_profiling: bool = False,
        kll_parameters: Optional[KLLParameters] = None,
        predefined_types: Optional[Dict[str, DataTypeInstances]] = None,
        runs=None,
        device=None,
    ) -> ColumnProfiles:
        predefined_types = predefined_types or {}
        if restrict_to_columns is not None:
            for name in restrict_to_columns:
                if name not in data:
                    raise ValueError(f"Unable to find column {name}")
            relevant = [c for c in data.column_names if c in set(restrict_to_columns)]
        else:
            relevant = data.column_names

        dev = resolve_device(device)
        if runs is None:
            runs = OfflineProfileRuns(dict(
                device=dev,
                metrics_repository=metrics_repository,
                reuse_existing_results_for_key=reuse_existing_results_using_key,
                fail_if_results_missing=fail_if_results_for_reusing_missing,
                save_or_append_results_with_key=save_in_metrics_repository_using_key,
            ))

        persisted: list = []
        try:
            _persist_for_passes(data, dev, persisted)
            return ColumnProfiler._profile_passes(
                data, relevant, predefined_types, print_status_updates,
                low_cardinality_histogram_threshold, kll_profiling,
                kll_parameters, runs, dev, persisted,
            )
        finally:
            for t in persisted:
                t.unpersist()

    @staticmethod
    def _profile_passes(
        data, relevant, predefined_types, print_status_updates,
        low_cardinality_histogram_threshold, kll_profiling,
        kll_parameters, runs, device, persisted,
    ) -> ColumnProfiles:
        # -- pass 1: generic statistics (ColumnProfiler.scala:122-139) ------
        if print_status_updates:
            print("### PROFILING: Computing generic column statistics in pass (1/3)...")
        analyzers = [Size()]
        for name in relevant:
            analyzers.append(Completeness(name))
            analyzers.append(ApproxCountDistinct(name))
            if data[name].dtype == DType.STRING and name not in predefined_types:
                analyzers.append(DataType(name))
        ctx1 = runs.run(data, analyzers)

        num_records = int(ctx1.metric_map[Size()].value.get_or_else(0.0))

        completeness: Dict[str, float] = {}
        approx_distinct: Dict[str, int] = {}
        inferred_type: Dict[str, DataTypeInstances] = {}
        is_inferred: Dict[str, bool] = {}
        type_counts: Dict[str, Dict[str, int]] = {}
        for name in relevant:
            completeness[name] = ctx1.metric_map[Completeness(name)].value.get_or_else(
                float("nan")
            )
            approx_distinct[name] = int(round(
                ctx1.metric_map[ApproxCountDistinct(name)].value.get_or_else(0.0)
            ))
            col_dtype = data[name].dtype
            type_counts[name] = {}
            if name in predefined_types:
                inferred_type[name] = predefined_types[name]
                is_inferred[name] = False
            elif col_dtype == DType.STRING:
                metric = ctx1.metric_map[DataType(name)]
                if metric.value.is_success:
                    dist = metric.value.get()
                    inferred_type[name] = determine_type(dist)
                    type_counts[name] = {k: v.absolute for k, v in dist.values.items()}
                else:
                    inferred_type[name] = DataTypeInstances.UNKNOWN
                is_inferred[name] = True
            else:
                inferred_type[name] = _NATIVE_TYPES[col_dtype]
                is_inferred[name] = False

        # cast the string columns inferred numeric (ColumnProfiler.scala:153-154);
        # a stream casts them lazily, a batch at a time
        casts = {
            name: (DType.INTEGRAL if inferred_type[name] == DataTypeInstances.INTEGRAL
                   else DType.FRACTIONAL)
            for name in relevant
            if data[name].dtype == DType.STRING and inferred_type[name] in _NUMERIC
        }
        casted = data
        if getattr(data, "is_streaming", False):
            if casts:
                casted = data.with_casts(casts)
        else:
            for name, target in casts.items():
                casted = casted.with_column(cast_string_column(data[name], target))

        numeric_columns = [name for name in relevant if inferred_type[name] in _NUMERIC]

        # -- pass 2: numeric statistics (ColumnProfiler.scala:157-173) ------
        if print_status_updates:
            print("### PROFILING: Computing numeric column statistics in pass (2/3)...")
        numeric_analyzers = []
        for name in numeric_columns:
            numeric_analyzers += [
                Minimum(name), Maximum(name), Mean(name),
                StandardDeviation(name), Sum(name),
            ]
            if kll_profiling:
                numeric_analyzers.append(KLLSketch(name, kll_parameters))
        if casted is not data and numeric_analyzers:
            _persist_for_passes(casted, device, persisted)
        ctx2 = runs.run(casted, numeric_analyzers) if numeric_analyzers else None

        # -- pass 3: exact histograms of the low-cardinality columns --------
        if print_status_updates:
            print("### PROFILING: Computing histograms of low-cardinality columns in pass (3/3)...")
        histograms: Dict[str, Distribution] = {}
        histogram_targets = [
            name
            for name in relevant
            if approx_distinct[name] <= low_cardinality_histogram_threshold
            and inferred_type[name] in (
                DataTypeInstances.STRING,
                DataTypeInstances.BOOLEAN,
                DataTypeInstances.INTEGRAL,
            )
        ]
        if histogram_targets:
            # through the same seam as passes 1-2, so saved profiles carry
            # their histograms and a reusing profile reuses them
            ctx3 = runs.run(data, [Histogram(name) for name in histogram_targets])
            for name in histogram_targets:
                metric = ctx3.metric_map.get(Histogram(name))
                if metric is not None and metric.value.is_success:
                    histograms[name] = metric.value.get()

        # -- assemble -------------------------------------------------------
        def metric_value(analyzer):
            m = ctx2.metric_map.get(analyzer)
            if m is not None and m.value.is_success:
                return float(m.value.get())
            return None

        profiles: Dict[str, ColumnProfile] = {}
        for name in relevant:
            base = dict(
                column=name,
                completeness=completeness[name],
                approximate_num_distinct_values=approx_distinct[name],
                data_type=inferred_type[name],
                is_data_type_inferred=is_inferred[name],
                type_counts=type_counts[name],
                histogram=histograms.get(name),
            )
            if name in numeric_columns and ctx2 is not None:
                kll_dist = None
                approx_percentiles = None
                if kll_profiling:
                    kll_metric = ctx2.metric_map.get(KLLSketch(name, kll_parameters))
                    if kll_metric is not None and kll_metric.value.is_success:
                        kll_dist = kll_metric.value.get()
                        approx_percentiles = kll_dist.compute_percentiles()
                profiles[name] = NumericColumnProfile(
                    **base,
                    kll=kll_dist,
                    mean=metric_value(Mean(name)),
                    maximum=metric_value(Maximum(name)),
                    minimum=metric_value(Minimum(name)),
                    sum=metric_value(Sum(name)),
                    std_dev=metric_value(StandardDeviation(name)),
                    approx_percentiles=approx_percentiles,
                )
            else:
                profiles[name] = StandardColumnProfile(**base)

        return ColumnProfiles(profiles, num_records)


class ColumnProfilerRunner:
    """Fluent entry (reference profiles/ColumnProfilerRunner.scala:37-113,
    ColumnProfilerRunBuilder.scala:25-245); ``device`` as
    ``VerificationSuite.on_data``'s."""

    @staticmethod
    def on_data(data: ColumnarTable, device=None) -> "ColumnProfilerRunBuilder":
        return ColumnProfilerRunBuilder(data, device)


class ColumnProfilerRunBuilder:
    def __init__(self, data: ColumnarTable, device=None):
        self._data = data
        self._device = device
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._print_status_updates = False
        self._threshold = DEFAULT_CARDINALITY_THRESHOLD
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_missing = False
        self._save_key = None
        self._kll_profiling = False
        self._kll_parameters: Optional[KLLParameters] = None
        self._predefined_types: Dict[str, DataTypeInstances] = {}
        self._runs = None

    def restrict_to_columns(self, columns: Sequence[str]):
        self._restrict_to_columns = columns
        return self

    def print_status_updates(self, value: bool):
        self._print_status_updates = value
        return self

    def with_low_cardinality_histogram_threshold(self, threshold: int):
        self._threshold = threshold
        return self

    def with_kll_profiling(self):
        self._kll_profiling = True
        return self

    def set_kll_parameters(self, parameters: KLLParameters):
        self._kll_parameters = parameters
        return self

    def set_predefined_types(self, types: Dict[str, DataTypeInstances]):
        self._predefined_types = dict(types)
        return self

    def use_repository(self, repository):
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(self, key, fail_if_missing: bool = False):
        self._reuse_key = key
        self._fail_if_missing = fail_if_missing
        return self

    def save_or_append_result(self, key):
        self._save_key = key
        return self

    def with_runs(self, runs):
        """Run every pass through ``runs`` (an object with the
        :class:`OfflineProfileRuns` interface) instead of the offline
        ``do_analysis_run``s."""
        self._runs = runs
        return self

    def run(self) -> ColumnProfiles:
        return ColumnProfiler.profile(
            self._data,
            restrict_to_columns=self._restrict_to_columns,
            print_status_updates=self._print_status_updates,
            low_cardinality_histogram_threshold=self._threshold,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_using_key=self._reuse_key,
            fail_if_results_for_reusing_missing=self._fail_if_missing,
            save_in_metrics_repository_using_key=self._save_key,
            kll_profiling=self._kll_profiling,
            kll_parameters=self._kll_parameters,
            predefined_types=self._predefined_types,
            runs=self._runs,
            device=self._device,
        )
