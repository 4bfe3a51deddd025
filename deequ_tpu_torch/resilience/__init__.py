"""Crash-safe persistence, I/O retries, checkpoint and resume, fault
injection for storage and for the card, and run-level governance (the
port of ``deequ_tpu/resilience``; its chaos engine comes with the port's
tooling). The device side of fault tolerance — the taxonomy, the
watchdog, the ladder — lives in ``exceptions.py``,
``ops/device_policy.py`` and ``ops/scan_executors.py``.
"""

from deequ_tpu_torch.exceptions import (  # noqa: F401 — their home is exceptions.py
    DeviceCompileException,
    DeviceException,
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceLostException,
    DeviceOOMException,
    RunBudgetExhaustedException,
    classify_device_error,
)

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
    FaultInjectingScanHook,
    FaultSchedule,
    FlakyBatchSource,
    InjectedDeviceError,
    InjectedIOError,
)
from deequ_tpu_torch.resilience.governance import (
    RunBudget,
    RunPolicy,
    charge_run_budget,
    current_run_budget,
    default_max_total_attempts,
    default_run_deadline,
    fault_state_scope,
    resolve_run_policy,
    run_budget_remaining,
    run_budget_scope,
    try_charge,
)
from deequ_tpu_torch.resilience.retry import (
    DEFAULT_IO_RETRY,
    RETRY_TELEMETRY,
    RetryingBatchSource,
    RetryingFileSystem,
    RetryPolicy,
    RetryTelemetry,
    default_retry_policy,
    resilient_batches,
    resolve_retry_policy,
    retry_call,
    set_default_retry_policy,
)

__all__ = [
    "DEFAULT_IO_RETRY",
    "DeviceCompileException",
    "DeviceException",
    "DeviceFallbackRefusedException",
    "DeviceHangException",
    "DeviceLostException",
    "DeviceOOMException",
    "FaultInjectingFileSystem",
    "FaultInjectingScanHook",
    "FaultSchedule",
    "FlakyBatchSource",
    "InjectedDeviceError",
    "InjectedIOError",
    "RETRY_TELEMETRY",
    "RetryPolicy",
    "RetryTelemetry",
    "RetryingBatchSource",
    "RetryingFileSystem",
    "RunBudget",
    "RunBudgetExhaustedException",
    "RunPolicy",
    "StreamCheckpoint",
    "StreamCheckpointer",
    "atomic_write_bytes",
    "charge_run_budget",
    "classify_device_error",
    "current_run_budget",
    "default_max_total_attempts",
    "default_retry_policy",
    "default_run_deadline",
    "fault_state_scope",
    "has_checksum",
    "read_checksummed",
    "resilient_batches",
    "resolve_retry_policy",
    "resolve_run_policy",
    "retry_call",
    "run_budget_remaining",
    "run_budget_scope",
    "run_fingerprint",
    "set_default_retry_policy",
    "try_charge",
    "unwrap_checksum",
    "wrap_checksum",
]
