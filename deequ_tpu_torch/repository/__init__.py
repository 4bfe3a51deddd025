"""Metrics repository — a time-series store of analysis results (reference
layer L9, repository/; the port's copy of ``deequ_tpu/repository``).

Results are keyed by ``ResultKey(data_set_date, tags)`` and read through a
small DSL (``load().with_tag_values(...).after(...).for_analyzers(...)``),
the history anomaly detection reads. The filesystem and columnar backends
and the monitor's checkpoint write the reference's bytes, so either
package reads what the other wrote.
"""

from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository
from deequ_tpu_torch.repository.columnar import ColumnarMetricsRepository
from deequ_tpu_torch.repository.monitor import QualityAlert, QualityMonitor
from deequ_tpu_torch.repository.query import (
    RepositoryQuery,
    RepositoryQueryResult,
    run_repository_query,
)

__all__ = [
    "AnalysisResult",
    "MetricsRepository",
    "MetricsRepositoryMultipleResultsLoader",
    "ResultKey",
    "InMemoryMetricsRepository",
    "FileSystemMetricsRepository",
    "ColumnarMetricsRepository",
    "QualityAlert",
    "QualityMonitor",
    "RepositoryQuery",
    "RepositoryQueryResult",
    "run_repository_query",
]
