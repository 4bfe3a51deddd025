"""State persistence — the incremental-compute backbone (the port's copy of
``deequ_tpu/states/__init__.py``, reference analyzers/StateProvider.scala).

States are kept per analyzer, so tomorrow's scan of the new data merges
with today's saved states instead of rescanning (``aggregate_with`` /
``save_states_with``, ``run_on_aggregated_states``). Two providers:
in memory (a locked map keyed by the analyzer value) and on a filesystem
(one checksummed binary file an analyzer under a directory). A file's
name is ``sha1(repr(analyzer))[:16] + ".state"``, and the analyzers'
reprs equal the reference's, so either package reads a directory the
other wrote.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional

from deequ_tpu_torch.analyzers.base import Analyzer, State


class StateLoader:
    def load(self, analyzer: Analyzer) -> Optional[State]:
        raise NotImplementedError


class StatePersister:
    def persist(self, analyzer: Analyzer, state: State) -> None:
        raise NotImplementedError


class InMemoryStateProvider(StateLoader, StatePersister):
    """Keyed by the analyzer value itself
    (reference analyzers/StateProvider.scala:47-70)."""

    def __init__(self):
        self._states: Dict[Analyzer, State] = {}
        self._lock = threading.Lock()

    def load(self, analyzer: Analyzer) -> Optional[State]:
        with self._lock:
            return self._states.get(analyzer)

    def persist(self, analyzer: Analyzer, state: State) -> None:
        with self._lock:
            self._states[analyzer] = state

    def __repr__(self) -> str:
        with self._lock:
            keys = ", ".join(str(k) for k in self._states)
        return f"InMemoryStateProvider({keys})"


def state_file_name(analyzer: Analyzer) -> str:
    """The file an analyzer's state lives in, in both packages."""
    return hashlib.sha1(repr(analyzer).encode()).hexdigest()[:16] + ".state"


class FileSystemStateProvider(StateLoader, StatePersister):
    """Binary state files (``states/serde.py``) under ``location``, one an
    analyzer (the analogue of the reference's HdfsStateProvider,
    analyzers/StateProvider.scala:73-312). A write is checksummed and
    atomic (``resilience/atomic.py``): a crash mid-write leaves the
    previous complete file, and a damaged file loads as
    CorruptStateException. Storage calls run under
    ``resilience.retry.DEFAULT_IO_RETRY``."""

    def __init__(self, location: str):
        from deequ_tpu_torch.data.fs import filesystem_for, strip_scheme
        from deequ_tpu_torch.resilience.retry import RetryingFileSystem

        self.location = strip_scheme(location)
        self._fs = RetryingFileSystem(filesystem_for(location))
        self._fs.makedirs(self.location)

    def _path(self, analyzer: Analyzer) -> str:
        return self._fs.join(self.location, state_file_name(analyzer))

    def load(self, analyzer: Analyzer) -> Optional[State]:
        from deequ_tpu_torch.resilience.atomic import read_checksummed
        from deequ_tpu_torch.states.serde import deserialize_state

        path = self._path(analyzer)
        if not self._fs.exists(path):
            return None
        return deserialize_state(read_checksummed(self._fs, path, f"state file {path}"))

    def persist(self, analyzer: Analyzer, state: State) -> None:
        from deequ_tpu_torch.resilience.atomic import atomic_write_bytes, wrap_checksum
        from deequ_tpu_torch.states.serde import serialize_state

        atomic_write_bytes(
            self._fs, self._path(analyzer), wrap_checksum(serialize_state(state))
        )


# the reference's name for the same provider
HdfsStateProvider = FileSystemStateProvider

__all__ = [
    "FileSystemStateProvider",
    "HdfsStateProvider",
    "InMemoryStateProvider",
    "StateLoader",
    "StatePersister",
    "state_file_name",
]
