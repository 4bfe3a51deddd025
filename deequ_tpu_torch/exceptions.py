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
import re
from typing import Optional, Tuple


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


class ServeException(MetricCalculationRuntimeException):
    """Base of the serving layer's (``serve/``) failures: conditions of the
    service, not of one suite's data (those stay failure metrics and typed
    device errors)."""


class ServiceClosedException(ServeException):
    """A submit, resume or flush against a stopped VerificationService."""


class ServiceOverloadedException(ServeException):
    """Typed backpressure: the service refused to buffer this request (its
    queue is at ``max_pending``, or — the subclasses below — the request's
    SLO class ran out of queue budget or its deadline expired in the
    queue). ``queue_depth`` is the pending count at refusal,
    ``retry_after_s`` the service's estimate of when a retry could be
    admitted, ``slo_class`` the request's class; all optional."""

    def __init__(self, message: str, queue_depth: Optional[int] = None,
                 retry_after_s: Optional[float] = None,
                 slo_class: Optional[str] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        self.slo_class = slo_class


class AdmissionRejectedException(ServiceOverloadedException):
    """The admission controller (``serve/admission.py``) refused this request
    at ``submit()``. ``reason``: ``"class_budget"``,
    ``"brownout_best_effort"``, ``"brownout_critical_only"`` or
    ``"tenant_inflight_cap"``; ``retry_after_s`` is always set."""

    def __init__(self, message: str, reason: str = "class_budget",
                 queue_depth: Optional[int] = None,
                 retry_after_s: Optional[float] = None,
                 slo_class: Optional[str] = None):
        super().__init__(message, queue_depth=queue_depth,
                         retry_after_s=retry_after_s, slo_class=slo_class)
        self.reason = reason


class DeadlineExceededException(ServiceOverloadedException):
    """An accepted request's absolute SLO deadline expired before its
    dispatch: it is shed before any device work, resolved once and typed on
    its own future. ``waited_s`` is how long it sat accepted,
    ``deadline_ms`` the deadline it missed."""

    def __init__(self, message: str, tenant=None,
                 slo_class: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 waited_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message, queue_depth=queue_depth,
                         retry_after_s=retry_after_s, slo_class=slo_class)
        self.tenant = tenant
        self.deadline_ms = deadline_ms
        self.waited_s = waited_s


class RunBudgetExhaustedException(MetricCalculationRuntimeException):
    """The run-level fault budget (``resilience/governance.py``) ran out
    mid-ladder: the composed retry ladder — I/O retries, OOM bisections,
    encoded demotions, refused CPU rungs — charged more attempts than
    ``max_total_attempts`` allows, or the wall clock passed
    ``run_deadline``. Raised by ``RunBudget.charge`` at the first charge
    past the budget, so no rung keeps spending once the run is over it.

    ``reason`` is ``"max_total_attempts"`` or ``"run_deadline"``;
    ``ledger`` the budget's charge snapshot; ``degraded`` is True under
    ``on_budget_exhausted="degrade"``, where the verification layers turn
    it into a partial result (failure metrics for the analyzers the scan
    could not finish, exact ``unverified_row_ranges`` for the rows never
    verified); under ``"raise"`` it reaches the caller typed."""

    def __init__(self, reason: str, ledger: Optional[dict] = None,
                 degraded: bool = True, detail: str = ""):
        msg = f"run budget exhausted ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason
        self.ledger = dict(ledger or {})
        self.degraded = bool(degraded)


class DeviceException(MetricCalculationRuntimeException):
    """A classified device-layer (CUDA) failure. ``boundary`` names where
    it surfaced: ``"transfer"`` (a host->device copy, or packing for one),
    ``"trace"`` (a kernel's build or load), ``"execute"`` (a kernel launch
    or a torch op on the card) or ``"fetch"`` (the device->host result
    copy, where asynchronous faults surface).

    ``device_ids`` names the mesh members the raw error implicated (a
    message naming ``cuda:3``, "CUDA device 3" or "GPU 3": on a mesh of
    cards the member id is the ordinal); empty when the fault is
    unattributable. Attribution is what lets the mesh ladder shed one
    member instead of failing the whole mesh."""

    def __init__(self, message: str, boundary: str = "execute",
                 device_ids: Tuple[int, ...] = ()):
        super().__init__(message)
        self.boundary = boundary
        self.device_ids = tuple(device_ids)


class DeviceOOMException(DeviceException):
    """Device memory exhausted (``torch.cuda.OutOfMemoryError``, a CUDA
    allocation failure, or a host ``MemoryError`` while packing a chunk).
    Recoverable by scanning in smaller chunks (the scan's chunk
    bisection)."""


class DeviceCompileException(DeviceException):
    """A kernel could not be built or loaded for the card: ``nvcc`` or
    ``ptxas`` failed, its library did not load, or the card has no image
    for it. Retrying the same kernel on the same card cannot help."""


class DeviceLostException(DeviceException):
    """A CUDA error the run cannot recover from on this device: an illegal
    address, a launch failure, a device-side assert, an uncorrectable ECC
    error, a device that fell off the bus. Such an error is sticky — it
    leaves the process's CUDA context unusable — so no rung retries it on
    the card."""


class DeviceHangException(DeviceException):
    """A device call exceeded the watchdog's wall-clock ``deadline``: a
    hung call converted into a typed, catchable failure (the thread
    blocked in it is abandoned; it cannot be cancelled)."""

    def __init__(self, message: str, boundary: str = "execute",
                 deadline: Optional[float] = None):
        super().__init__(message, boundary)
        self.deadline = deadline


class DeviceFallbackRefusedException(DeviceException):
    """A scan under ``on_device_error="fallback"`` reached the rung where
    the reference re-runs it on the host's CPU — the fault ladder ran out
    on the card, or the device's circuit breaker is open
    (``ops/device_policy.py:DeviceHealth``) — and the port refused: it
    never moves a CUDA run onto the CPU quietly. ``__cause__`` is the
    fault that ended the ladder (for an open breaker, the last fault that
    opened it); ``reason`` names the rung ("oom_at_bisection_floor", the
    fault's type name, or "unhealthy_backend")."""

    def __init__(self, message: str, boundary: str = "execute", reason: str = ""):
        super().__init__(message, boundary)
        self.reason = reason


class MeshDegradedException(DeviceException):
    """A lost-class device failure on a mesh that names specific members
    (``device_ids``): one member's shard faulted while the rest of the
    mesh is presumed healthy. The mesh ladder
    (``ops/scan_executors.py``) evicts residency pinned to the old mesh,
    rebuilds the mesh over the survivors and runs the same scan again;
    with no member left, the scan fails typed (or its CPU rung is
    refused)."""


class PeerLostException(DeviceException):
    """A multi-process run lost contact with peer processes (a heartbeat
    or barrier timeout over the process group's store).
    ``lost_processes`` names the ranks that stopped responding (empty when
    the stall could not be attributed). Under ``on_peer_loss="degrade"``
    the survivors finish and the lost ranks' row ranges are reported
    unverified instead."""

    def __init__(self, message: str, lost_processes: Tuple[int, ...] = (),
                 boundary: str = "execute"):
        super().__init__(message, boundary)
        self.lost_processes = tuple(lost_processes)


class WorkerLostException(DeviceException):
    """A serving-fleet worker (``serve/fleet.py``) died or stopped
    heartbeating past the membership's stall timeout. ``worker_ids`` names
    the lost fleet members, as ``PeerLostException`` names lost ranks;
    ``device_ids`` stays empty, so neither the fault ladder nor the
    service's bisection takes it for a fault of a card. The fleet answers
    it with failover, not abort: the lost worker's accepted requests
    re-dispatch onto survivors on their original futures, each charging
    the tenant's run budget ``worker_failover``; a caller sees it only
    when no survivor remains or a request ran out of failover retries."""

    def __init__(self, message: str, worker_ids: Tuple[int, ...] = (),
                 boundary: str = "execute"):
        super().__init__(message, boundary)
        self.worker_ids = tuple(worker_ids)


class DeviceUnavailableException(DeviceException):
    """The run was asked to execute on a CUDA device that this process
    cannot see. Entry points run on ``cuda`` unless the caller asks for
    the CPU (``deequ_tpu_torch.use_device("cpu")`` or ``device="cpu"``);
    they never fall back to the host quietly."""

    def __init__(self, message: str):
        super().__init__(message, boundary="transfer")


# message patterns per class, checked in order: OOM first (an allocation
# failing inside a launch is still memory pressure that smaller chunks
# relieve), then a kernel's build or load, then the sticky CUDA errors
_OOM_RE = re.compile(
    r"CUDA out of memory|cudaErrorMemoryAllocation|CUDA error: out of memory|"
    r"[Oo]ut of memory|[Ff]ailed to allocate|[Aa]llocation.*(failed|exceeds)|"
    r"RESOURCE_EXHAUSTED",
    re.DOTALL,
)
_COMPILE_RE = re.compile(
    r"nvcc|ptxas|NVRTC|no kernel image is available|cudaErrorNoKernelImageForDevice|"
    r"cudaErrorInvalidPtx|invalid PTX|cudaErrorInvalidKernelImage|"
    r"cannot open shared object|undefined symbol|[Cc]ompilation (failure|error)|"
    r"[Ff]ailed to compile",
    re.DOTALL,
)
_LOST_RE = re.compile(
    r"illegal memory access|illegal address|illegal instruction|"
    r"unspecified launch failure|launch failure|device-side assert|"
    r"misaligned address|ECC error|fallen off the bus|"
    r"cudaErrorLaunchFailure|cudaErrorIllegalAddress|cudaErrorAssert|"
    r"cudaErrorECCUncorrectable|[Dd]evice.*(lost|halt|reset)|"
    r"CUDA driver initialization failed|no CUDA-capable device|CUDA error",
    re.DOTALL,
)

# attribution: the singular shapes a message names one card or member by
# ("cuda:3", "CUDA device 3", "device 3", "GPU 3", "chip #5", "mesh
# position 4", "core 1"). The word prefix keeps byte counts and error
# codes from parsing as ids, and it is singular on purpose: an
# enumeration ("visible devices: 0,1") names a set, not a culprit, and
# must not pin a whole-backend loss on its first entry
_DEVICE_ID_RE = re.compile(
    r"(?:device|cuda|GPU|TPU|chip|core|member|mesh position)[ _:#]+(\d+)",
    re.IGNORECASE,
)


def implicated_devices(exception: BaseException) -> Tuple[int, ...]:
    """The device ids a raw error message names, in order, without
    repeats; empty when the failure is unattributable (a whole-backend
    loss, an allocator OOM that does not say where)."""
    if isinstance(exception, DeviceException) and exception.device_ids:
        return exception.device_ids
    seen = []
    for m in _DEVICE_ID_RE.finditer(f"{type(exception).__name__}: {exception}"):
        did = int(m.group(1))
        if did not in seen:
            seen.append(did)
    return tuple(seen)


#: torch's own CUDA error types: device-shaped by type, not only by text
_STRONG_TYPES = ("OutOfMemoryError", "AcceleratorError", "CudaError", "DeferredCudaCallError")


def _device_error_strength(exception: BaseException) -> Optional[str]:
    """``"strong"`` when the exception's TYPE is one of torch's CUDA error
    types (checked by class name, so a test double of the same name
    classifies alike); ``"weak"`` for a plain RuntimeError or MemoryError,
    which classifies only on an unambiguous message; None otherwise."""
    for klass in type(exception).__mro__:
        if klass.__name__ in _STRONG_TYPES:
            return "strong"
    if isinstance(exception, (RuntimeError, MemoryError)):
        return "weak"
    return None


def classify_device_error(
    exception: BaseException, boundary: str = "execute"
) -> Optional[DeviceException]:
    """Map a raw torch/CUDA error to its typed DeviceException, or None
    when the error is not device-shaped (logic errors propagate
    untouched). Already-classified exceptions pass through unchanged.

    ``torch.cuda.OutOfMemoryError`` and a ``MemoryError`` are OOM by type;
    otherwise the message decides: CUDA out-of-memory text, then a
    kernel's build or load (compile), then the sticky CUDA errors and any
    other ``CUDA error`` (lost; :class:`MeshDegradedException` when the
    message names members). ``device_ids`` is :func:`implicated_devices`. A plain RuntimeError with no such text
    stays unclassified at every boundary — an application bug inside an
    op's update surfaces as itself — while one of torch's CUDA error
    types with no recognisable text is a compile failure at the
    ``"trace"`` boundary (the kernel never ran)."""
    if isinstance(exception, DeviceException):
        return exception
    strength = _device_error_strength(exception)
    if strength is None:
        return None
    text = f"{type(exception).__name__}: {exception}"
    device_ids = implicated_devices(exception)
    klass = None
    if (isinstance(exception, MemoryError)
            or type(exception).__name__ == "OutOfMemoryError"
            or _OOM_RE.search(text)):
        klass = DeviceOOMException
    elif _COMPILE_RE.search(text):
        klass = DeviceCompileException
    elif _LOST_RE.search(text):
        # a loss the message pins on members is a mesh fault: the rest of
        # the mesh is presumed healthy and the ladder sheds the named ones
        klass = MeshDegradedException if device_ids else DeviceLostException
    elif boundary == "trace" and strength == "strong":
        klass = DeviceCompileException
    if klass is None:
        return None
    typed = klass(f"[{boundary}] {text}", boundary=boundary)
    typed.device_ids = device_ids
    typed.__cause__ = exception
    return typed


#: the CUDA runtime's names of the error codes a kernel's C entry returns
_CUDA_ERROR_NAMES = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    214: "cudaErrorECCUncorrectable",
    218: "cudaErrorInvalidPtx",
    700: "cudaErrorIllegalAddress",
    701: "cudaErrorLaunchOutOfResources",
    710: "cudaErrorAssert",
    719: "cudaErrorLaunchFailure",
}


def launch_error(what: str, rc: int) -> DeviceException:
    """The typed exception of a hand-written kernel whose C entry returned
    CUDA error ``rc``: named as the runtime names it, so an allocation the
    launch could not make classifies as OOM and a sticky error as lost."""
    name = _CUDA_ERROR_NAMES.get(rc, "unknown")
    message = f"{what}: CUDA error {rc} ({name})"
    return classify_device_error(RuntimeError(message)) or DeviceException(message)


@contextlib.contextmanager
def device_boundary(boundary: str):
    """Raise the CUDA errors of the block (and a host ``MemoryError``, an
    OOM) as their typed DeviceException (``boundary``: "transfer",
    "trace", "execute" or "fetch"); any other error passes through
    untouched."""
    try:
        yield
    except (RuntimeError, MemoryError) as e:
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
