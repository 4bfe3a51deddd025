"""Crash-safe persistence and I/O retries for the state providers (the
port's subset of ``deequ_tpu/resilience``)."""

from deequ_tpu_torch.resilience.atomic import (
    atomic_write_bytes,
    has_checksum,
    read_checksummed,
    unwrap_checksum,
    wrap_checksum,
)
from deequ_tpu_torch.resilience.retry import (
    RetryingFileSystem,
    RetryPolicy,
    retry_call,
)

__all__ = [
    "RetryPolicy",
    "RetryingFileSystem",
    "atomic_write_bytes",
    "has_checksum",
    "read_checksummed",
    "retry_call",
    "unwrap_checksum",
    "wrap_checksum",
]
