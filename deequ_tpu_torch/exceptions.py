"""Exception hierarchy for metric calculation failures.

Mirrors the reference semantics (analyzers/runners/MetricCalculationException.scala:19-78):
failures during metric computation are *data* — they are captured inside
``Metric.value`` rather than aborting a run.

Device faults are part of the same taxonomy, rooted on CUDA: the scan
engine and the grouping path classify the raw ``torch`` errors that
surface at their device boundaries (``torch.cuda.OutOfMemoryError``, CUDA
runtime errors) into the typed ``Device*Exception`` family below.
"""

from __future__ import annotations

import contextlib
from typing import Optional


class EnvConfigError(ValueError):
    """A malformed ``DEEQU_TORCH_*`` environment variable (envcfg.py, the
    one registry every switch of the port parses through). A ``ValueError``
    carrying the variable's name, the offending raw value and what would
    have been accepted."""

    def __init__(self, name: str, raw: str, expected: str):
        super().__init__(f"{name} must be {expected}, got {raw!r}")
        self.name = name
        self.raw = raw
        self.expected = expected


class MetricCalculationException(Exception):
    """Base class for anything that goes wrong while computing a metric."""


class MetricCalculationRuntimeException(MetricCalculationException):
    """Runtime failure during state/metric computation."""


class MetricCalculationPreconditionException(MetricCalculationException):
    """A precondition on the input schema was violated."""


class NoSuchColumnException(MetricCalculationPreconditionException):
    def __init__(self, column: str):
        super().__init__(f"Input data does not include column {column}!")
        self.column = column


class WrongColumnTypeException(MetricCalculationPreconditionException):
    pass


class NoColumnsSpecifiedException(MetricCalculationPreconditionException):
    pass


class NumberOfSpecifiedColumnsException(MetricCalculationPreconditionException):
    pass


class IllegalAnalyzerParameterException(MetricCalculationPreconditionException):
    def __init__(self, message: str):
        super().__init__(f"Can't execute the analysis: {message}")


class EmptyStateException(MetricCalculationRuntimeException):
    pass


class CorruptStateException(MetricCalculationRuntimeException):
    """Persisted bytes failed integrity validation (checksum mismatch,
    torn write, undecodable payload) — raised instead of the raw struct
    error, so a caller can tell a damaged file (recompute the state) from
    a bug."""

    def __init__(self, what: str, detail: str = ""):
        msg = f"corrupt persisted state: {what}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.what = what


class RetryExhaustedException(MetricCalculationRuntimeException):
    """A retried I/O operation kept failing past the RetryPolicy's attempt
    budget or deadline. ``__cause__`` carries the last underlying error."""

    def __init__(self, what: str, attempts: int, cause: BaseException):
        super().__init__(
            f"{what} still failing after {attempts} attempts: {cause}"
        )
        self.attempts = attempts
        self.__cause__ = cause


class ReusingNotPossibleResultsMissingException(
    MetricCalculationRuntimeException, RuntimeError
):
    """``fail_if_results_missing`` is set and the metrics repository lacks
    some requested analyzer results (reference AnalysisRunner.scala:552)."""


class GroupBudgetIgnoredWarning(UserWarning):
    """``group_memory_budget`` was configured together with checkpointing:
    a spill store's runs are not checkpointed, so spill is disabled and
    frequency folds stay in host RAM. Emitted once a run, never a batch;
    the category lets a deployment silence or escalate it through the
    warnings filters."""


class NotYetPortedException(MetricCalculationException, NotImplementedError):
    """A constraint or analyzer of the reference package that this port
    does not carry yet. Raised when a check is BUILT with it, so a suite
    can never yield a metric the port does not compute."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} is not ported to deequ_tpu_torch yet (see ROADMAP.md, "
            f"queue 1)"
        )
        self.what = what


class DeviceException(MetricCalculationRuntimeException):
    """A classified device-layer (CUDA) failure. ``boundary`` names where
    it surfaced: ``"transfer"`` (host->device copy), ``"execute"`` (a
    kernel launch or a torch op on the card) or ``"fetch"`` (the
    device->host result copy, where asynchronous faults surface)."""

    def __init__(self, message: str, boundary: str = "execute"):
        super().__init__(message)
        self.boundary = boundary


class DeviceOOMException(DeviceException):
    """Device memory exhausted (``torch.cuda.OutOfMemoryError``)."""


class DeviceLostException(DeviceException):
    """A CUDA runtime error the run cannot recover from on this device:
    an illegal address, a launch failure, a device that fell off the bus."""


class DeviceUnavailableException(DeviceException):
    """The run was asked to execute on a CUDA device that this process
    cannot see. Entry points run on ``cuda`` unless the caller asks for
    the CPU (``deequ_tpu_torch.use_device("cpu")`` or ``device="cpu"``);
    they never fall back to the host quietly."""

    def __init__(self, message: str):
        super().__init__(message, boundary="transfer")


def classify_device_error(
    exception: BaseException, boundary: str = "execute"
) -> Optional[DeviceException]:
    """Map a raw torch/CUDA error to its typed DeviceException, or None
    when the error is not device-shaped (logic errors propagate
    untouched). Already-classified exceptions pass through unchanged."""
    if isinstance(exception, DeviceException):
        return exception
    import torch

    if isinstance(exception, torch.cuda.OutOfMemoryError):
        klass = DeviceOOMException
    elif isinstance(exception, RuntimeError) and "CUDA error" in str(exception):
        klass = DeviceLostException
    else:
        return None
    typed = klass(f"[{boundary}] {type(exception).__name__}: {exception}",
                  boundary=boundary)
    typed.__cause__ = exception
    return typed


@contextlib.contextmanager
def device_boundary(boundary: str):
    """Raise the CUDA errors of the block as their typed DeviceException
    (``boundary``: "transfer", "execute" or "fetch"); any other error
    passes through untouched."""
    try:
        yield
    except RuntimeError as e:
        typed = classify_device_error(e, boundary)
        if typed is None:
            raise
        raise typed from e


def wrap_if_necessary(exception: BaseException) -> MetricCalculationException:
    """Ensure an arbitrary error is a MetricCalculationException (reference L69)."""
    if isinstance(exception, MetricCalculationException):
        return exception
    wrapped = MetricCalculationRuntimeException(str(exception))
    wrapped.__cause__ = exception
    return wrapped
