"""AnalysisRunBuilder — fluent raw-metric runs (reference analyzers/
runners/AnalysisRunBuilder.scala:25-186; the port's copy of
``deequ_tpu/analyzers/builder.py``)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
from deequ_tpu_torch.data.table import ColumnarTable


class AnalysisRunBuilder:
    def __init__(self, data: ColumnarTable, device=None):
        self._data = data
        self._device = device
        self._analyzers: List[Analyzer] = []
        self._aggregate_with = None
        self._save_states_with = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._success_metrics_path: Optional[str] = None
        self._overwrite_output_files = False
        self._group_memory_budget: Optional[int] = None

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def aggregate_with(self, state_loader) -> "AnalysisRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "AnalysisRunBuilder":
        self._save_states_with = state_persister
        return self

    def with_group_memory_budget(self, budget_bytes: int) -> "AnalysisRunBuilder":
        """Past ``budget_bytes`` of host memory the grouping states spill
        to disk as sorted runs and stream back at finalize (``spill/``)."""
        self._group_memory_budget = int(budget_bytes)
        return self

    def use_repository(self, repository) -> "AnalysisRunBuilderWithRepository":
        return AnalysisRunBuilderWithRepository(self, repository)

    def save_success_metrics_json_to_path(self, path: str) -> "AnalysisRunBuilder":
        self._success_metrics_path = path
        return self

    def overwrite_previous_files(self, overwrite: bool) -> "AnalysisRunBuilder":
        self._overwrite_output_files = overwrite
        return self

    def run(self) -> AnalyzerContext:
        ctx = AnalysisRunner.do_analysis_run(
            self._data, self._analyzers, self._device,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            group_memory_budget=self._group_memory_budget,
        )
        if self._success_metrics_path is not None and (
            self._overwrite_output_files
            or not os.path.exists(self._success_metrics_path)
        ):
            with open(self._success_metrics_path, "w") as f:
                f.write(AnalyzerContext.success_metrics_as_json(ctx))
        return ctx


class AnalysisRunBuilderWithRepository(AnalysisRunBuilder):
    def __init__(self, base: AnalysisRunBuilder, repository):
        super().__init__(base._data, base._device)
        self.__dict__.update(base.__dict__)
        self._metrics_repository = repository

    def reuse_existing_results_for_key(
        self, result_key, fail_if_results_missing: bool = False
    ) -> "AnalysisRunBuilderWithRepository":
        self._reuse_key = result_key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, result_key) -> "AnalysisRunBuilderWithRepository":
        self._save_key = result_key
        return self
