"""Repository core types (reference repository/MetricsRepository.scala,
repository/AnalysisResult.scala, MetricsRepositoryMultipleResultsLoader.scala)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalyzerContext


@dataclass(frozen=True)
class ResultKey:
    """(reference repository/MetricsRepository.scala:51)"""

    data_set_date: int
    tags: Tuple[Tuple[str, str], ...] = ()

    def __init__(self, data_set_date: int, tags=None):
        object.__setattr__(self, "data_set_date", int(data_set_date))
        if tags is None:
            normalized: Tuple[Tuple[str, str], ...] = ()
        elif isinstance(tags, dict):
            normalized = tuple(sorted(tags.items()))
        else:
            normalized = tuple(sorted(tuple(t) for t in tags))
        object.__setattr__(self, "tags", normalized)

    @property
    def tags_dict(self) -> Dict[str, str]:
        return dict(self.tags)

    @staticmethod
    def current_milli_time() -> int:
        return int(time.time() * 1000)


@dataclass
class AnalysisResult:
    """(reference repository/AnalysisResult.scala:25)"""

    result_key: ResultKey
    analyzer_context: AnalyzerContext


class MetricsRepository:
    """(reference repository/MetricsRepository.scala:25-43)"""

    def save(self, result: AnalysisResult) -> None:
        raise NotImplementedError

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalysisResult]:
        raise NotImplementedError

    def load(self) -> "MetricsRepositoryMultipleResultsLoader":
        raise NotImplementedError


class MetricsRepositoryMultipleResultsLoader:
    """Query DSL over the stored time series
    (reference repository/MetricsRepositoryMultipleResultsLoader.scala:33-137)."""

    def __init__(self, results_provider):
        self._results_provider = results_provider  # () -> List[AnalysisResult]
        self._tag_values: Optional[Dict[str, str]] = None
        self._analyzers: Optional[List[Analyzer]] = None
        self._after: Optional[int] = None
        self._before: Optional[int] = None

    def with_tag_values(self, tag_values: Dict[str, str]):
        self._tag_values = dict(tag_values)
        return self

    def for_analyzers(self, analyzers: Sequence[Analyzer]):
        self._analyzers = list(analyzers)
        return self

    def after(self, data_set_date: int):
        self._after = data_set_date
        return self

    def before(self, data_set_date: int):
        self._before = data_set_date
        return self

    def get(self) -> List[AnalysisResult]:
        results = self._results_provider()
        out = []
        for result in results:
            key = result.result_key
            if self._after is not None and key.data_set_date < self._after:
                continue
            if self._before is not None and key.data_set_date > self._before:
                continue
            if self._tag_values is not None:
                key_tags = key.tags_dict
                if not all(
                    key_tags.get(k) == v for k, v in self._tag_values.items()
                ):
                    continue
            ctx = result.analyzer_context
            if self._analyzers is not None:
                ctx = AnalyzerContext(
                    {
                        a: m
                        for a, m in ctx.metric_map.items()
                        if a in self._analyzers
                    }
                )
            out.append(AnalysisResult(key, ctx))
        return out

    def get_success_metrics_as_rows(
        self, with_tags: Optional[Sequence[str]] = None
    ) -> List[dict]:
        """Flattened metric rows with dataset_date + tag columns
        (DataFrame exporter analogue)."""
        rows = []
        for result in self.get():
            base_rows = AnalyzerContext.success_metrics_as_rows(
                result.analyzer_context
            )
            tags = result.result_key.tags_dict
            for row in base_rows:
                row = dict(row)
                row["dataset_date"] = result.result_key.data_set_date
                for tag_name, tag_value in tags.items():
                    if with_tags is None or tag_name in with_tags:
                        row[tag_name] = tag_value
                rows.append(row)
        return rows

    def get_success_metrics_as_json(
        self, with_tags: Optional[Sequence[str]] = None
    ) -> str:
        return json.dumps(self.get_success_metrics_as_rows(with_tags))
