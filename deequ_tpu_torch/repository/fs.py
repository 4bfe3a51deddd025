"""Filesystem metrics repository — one JSON file of all results, read,
modified and written whole (reference repository/fs/
FileSystemMetricsRepository.scala:32-226; the port's copy of
``deequ_tpu/repository/fs.py``, which reads and writes the same bytes).
Local paths play the role of HDFS/S3.

Crash safety: ``_write_all`` commits by temp file + fsync + rename
(``resilience/atomic.py``), so a crash mid-write leaves the previous
complete history; the file carries the checksum envelope, so damage that
reaches the disk raises ``CorruptStateException`` on read instead of a
raw ``JSONDecodeError``. Storage calls run under the retry policy
(``RetryingFileSystem``). Plain-JSON files without the envelope load too.

Each save rewrites every prior result (the reference's own shape), so N
saves cost O(N^2) bytes; a history that grows by many saves a run belongs
in :class:`~deequ_tpu_torch.repository.columnar.ColumnarMetricsRepository`.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.repository import serde
from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.analyzers.runner import AnalyzerContext


class FileSystemMetricsRepository(MetricsRepository):
    def __init__(self, path: str):
        from deequ_tpu_torch.data.fs import filesystem_for, strip_scheme
        from deequ_tpu_torch.resilience.retry import RetryingFileSystem

        self.path = strip_scheme(path)
        self._fs = RetryingFileSystem(filesystem_for(path))
        self._lock = threading.Lock()

    def _read_all(self) -> List[AnalysisResult]:
        if not self._fs.exists(self.path):
            return []
        from deequ_tpu_torch.resilience.atomic import read_checksummed

        # enveloped files validate + strip; legacy plain-JSON files (no
        # envelope magic) pass through as raw bytes
        data = read_checksummed(
            self._fs, self.path, f"metrics repository {self.path}"
        )
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise CorruptStateException(
                f"metrics repository {self.path}", f"undecodable bytes: {e}"
            ) from e
        if not text.strip():
            return []
        try:
            return serde.deserialize(text)
        except (ValueError, KeyError, TypeError) as e:
            raise CorruptStateException(
                f"metrics repository {self.path}",
                f"undecodable results payload: {e}",
            ) from e

    def _write_all(self, results: List[AnalysisResult]) -> None:
        parent = os.path.dirname(self.path)
        if parent:
            self._fs.makedirs(parent)
        from deequ_tpu_torch.resilience.atomic import atomic_write_bytes, wrap_checksum

        payload = serde.serialize(results).encode("utf-8")
        atomic_write_bytes(self._fs, self.path, wrap_checksum(payload))

    def save(self, result: AnalysisResult) -> None:
        successful = AnalyzerContext(
            {
                a: m
                for a, m in result.analyzer_context.metric_map.items()
                if m.value.is_success
            }
        )
        to_save = AnalysisResult(result.result_key, successful)
        with self._lock:
            existing = self._read_all()
            existing = [
                r for r in existing if r.result_key != result.result_key
            ]
            existing.append(to_save)
            self._write_all(existing)

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalysisResult]:
        with self._lock:
            for r in self._read_all():
                if r.result_key == result_key:
                    return r
        return None

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        def provider() -> List[AnalysisResult]:
            with self._lock:
                return self._read_all()

        return MetricsRepositoryMultipleResultsLoader(provider)
