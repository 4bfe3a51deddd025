"""Crash-safe persistence and I/O retries for the state providers and a
stream's batch reads (the port's subset of ``deequ_tpu/resilience``)."""

from deequ_tpu_torch.resilience.atomic import (
    atomic_write_bytes,
    has_checksum,
    read_checksummed,
    unwrap_checksum,
    wrap_checksum,
)
from deequ_tpu_torch.resilience.retry import (
    DEFAULT_IO_RETRY,
    RetryingBatchSource,
    RetryingFileSystem,
    RetryPolicy,
    resilient_batches,
    retry_call,
)

__all__ = [
    "DEFAULT_IO_RETRY",
    "RetryPolicy",
    "RetryingBatchSource",
    "RetryingFileSystem",
    "atomic_write_bytes",
    "has_checksum",
    "read_checksummed",
    "resilient_batches",
    "retry_call",
    "unwrap_checksum",
    "wrap_checksum",
]
