"""In-memory metrics repository
(reference repository/memory/InMemoryMetricsRepository.scala:28-136)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from deequ_tpu_torch.analyzers.runner import AnalyzerContext
from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)


class InMemoryMetricsRepository(MetricsRepository):
    def __init__(self):
        self._results: Dict[ResultKey, AnalysisResult] = {}
        self._lock = threading.Lock()

    def save(self, result: AnalysisResult) -> None:
        # keep only successful metrics, like the reference (L44-49)
        successful = AnalyzerContext(
            {
                a: m
                for a, m in result.analyzer_context.metric_map.items()
                if m.value.is_success
            }
        )
        with self._lock:
            self._results[result.result_key] = AnalysisResult(
                result.result_key, successful
            )

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalysisResult]:
        with self._lock:
            return self._results.get(result_key)

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        def provider() -> List[AnalysisResult]:
            with self._lock:
                return list(self._results.values())

        return MetricsRepositoryMultipleResultsLoader(provider)
