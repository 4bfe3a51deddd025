"""Crash-safe persistence, I/O retries, checkpoint and resume, and fault
injection for the state providers and a stream's batch reads (the port's
subset of ``deequ_tpu/resilience``; the device fault ladder — governance,
``RetryTelemetry``, the device half of the fault injector — is slice 8c).
"""

from deequ_tpu_torch.resilience.atomic import (
    atomic_write_bytes,
    has_checksum,
    read_checksummed,
    unwrap_checksum,
    wrap_checksum,
)
from deequ_tpu_torch.resilience.checkpoint import (
    StreamCheckpoint,
    StreamCheckpointer,
    run_fingerprint,
)
from deequ_tpu_torch.resilience.faults import (
    FaultInjectingFileSystem,
    FaultSchedule,
    FlakyBatchSource,
    InjectedIOError,
)
from deequ_tpu_torch.resilience.retry import (
    DEFAULT_IO_RETRY,
    RetryingBatchSource,
    RetryingFileSystem,
    RetryPolicy,
    default_retry_policy,
    resilient_batches,
    resolve_retry_policy,
    retry_call,
    set_default_retry_policy,
)

__all__ = [
    "DEFAULT_IO_RETRY",
    "FaultInjectingFileSystem",
    "FaultSchedule",
    "FlakyBatchSource",
    "InjectedIOError",
    "RetryPolicy",
    "RetryingBatchSource",
    "RetryingFileSystem",
    "StreamCheckpoint",
    "StreamCheckpointer",
    "atomic_write_bytes",
    "default_retry_policy",
    "has_checksum",
    "read_checksummed",
    "resilient_batches",
    "resolve_retry_policy",
    "retry_call",
    "run_fingerprint",
    "set_default_retry_policy",
    "unwrap_checksum",
    "wrap_checksum",
]
