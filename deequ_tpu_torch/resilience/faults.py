"""Deterministic fault injection — the test doubles for unreliable storage
and an unreliable card (the port of ``deequ_tpu/resilience/faults.py``).

The resilience layer's claims (retry exhaustion, checksum detection,
quarantine, checkpoint and resume) are testable only if faults can be
produced on schedule. ``FaultSchedule`` decides an operation at a time —
explicitly (``fail={key: n_failures}``) or pseudo-randomly from a seed by
a pure hash, so two schedules with the same seed and the same sequence of
operations inject the same faults. ``FaultInjectingFileSystem`` wraps any
FileSystem (register it for a scheme with
``data.fs.register_filesystem``); ``FlakyBatchSource`` wraps any
BatchSource with faults a batch index; ``FaultInjectingScanHook`` injects
device faults (OOM, a kernel that will not build, a lost device, a hang)
at the scan engine's execute seam (``ops/device_policy.py``).
"""

from __future__ import annotations

import hashlib
import math
import time
from typing import Dict, List, Optional, Tuple, Union

from deequ_tpu_torch.data.fs import FileSystem
from deequ_tpu_torch.data.source import BatchSource

FaultKey = Tuple  # e.g. ("batch", 3) or ("open", "fault://dir/metrics.json")


class InjectedIOError(IOError):
    """Marker subclass so tests can tell injected faults from real ones."""


class InjectedDeviceError(RuntimeError):
    """Stand-in for the RuntimeError torch raises on a CUDA fault, raised
    by FaultInjectingScanHook with the messages torch and the CUDA runtime
    print, so ``exceptions.classify_device_error`` classifies it exactly as
    it would the real error: the engine sees what a real device fault
    looks like, not a pre-typed exception."""


class FaultSchedule:
    """Seeded, reproducible decisions about which operations fail.

    - ``fail``: explicit map FaultKey -> how many first attempts raise
      (``math.inf`` = permanent fault).
    - ``torn``: explicit map FaultKey -> fraction of the payload a write
      actually persists (0.5 tears the file in half).
    - ``error_rate`` / ``torn_rate``: pseudo-random injection; the
      decision is a pure function of (seed, key, attempt) so replays are
      bit-identical.
    - ``delay_seconds`` (+ optional ``delay_rate``): slow reads.

    Every injection is appended to ``injected`` (kind, key, attempt) —
    the reproducibility assertions compare these logs.
    """

    def __init__(
        self,
        seed: int = 0,
        fail: Optional[Dict[FaultKey, float]] = None,
        torn: Optional[Dict[FaultKey, float]] = None,
        error_rate: float = 0.0,
        torn_rate: float = 0.0,
        delay_seconds: float = 0.0,
        delay_rate: float = 1.0,
    ):
        self.seed = seed
        self.fail = dict(fail or {})
        self.torn = dict(torn or {})
        self.error_rate = float(error_rate)
        self.torn_rate = float(torn_rate)
        self.delay_seconds = float(delay_seconds)
        self.delay_rate = float(delay_rate)
        self.injected: List[Tuple[str, FaultKey, int]] = []
        self._attempts: Dict[FaultKey, int] = {}

    def _prf(self, salt: str, key: FaultKey, attempt: int) -> float:
        raw = repr((self.seed, salt, key, attempt)).encode()
        h = hashlib.sha1(raw).digest()
        return int.from_bytes(h[:8], "little") / 2.0 ** 64

    def check(self, key: FaultKey) -> None:
        """One operation attempt on ``key``: maybe sleep, maybe raise."""
        attempt = self._attempts.get(key, 0)
        self._attempts[key] = attempt + 1
        if self.delay_seconds and self._prf("delay", key, attempt) < self.delay_rate:
            self.injected.append(("delay", key, attempt))
            time.sleep(self.delay_seconds)
        explicit = self.fail.get(key)
        if explicit is not None and attempt < explicit:
            self.injected.append(("ioerror", key, attempt))
            raise InjectedIOError(f"injected fault: {key} attempt {attempt}")
        if self.error_rate and self._prf("fail", key, attempt) < self.error_rate:
            self.injected.append(("ioerror", key, attempt))
            raise InjectedIOError(f"injected fault: {key} attempt {attempt}")

    def torn_fraction(self, key: FaultKey) -> Optional[float]:
        """Non-None when this write should tear; counts its own attempt."""
        attempt = self._attempts.get(key, 0)
        self._attempts[key] = attempt + 1
        explicit = self.torn.get(key)
        if explicit is not None:
            del self.torn[key]  # explicit tears fire once
            self.injected.append(("torn", key, attempt))
            return float(explicit)
        if self.torn_rate and self._prf("torn", key, attempt) < self.torn_rate:
            self.injected.append(("torn", key, attempt))
            return 0.5
        return None

    PERMANENT = math.inf


class _TornWriter:
    """File-handle proxy that persists only a prefix of what was written —
    the observable effect of a crash mid-write without atomic rename."""

    def __init__(self, inner, fraction: float, binary: bool):
        self._inner = inner
        self._fraction = fraction
        self._buf: list = []
        self._binary = binary

    def write(self, data) -> int:
        self._buf.append(data)
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        joined = (b"" if self._binary else "").join(self._buf)
        keep = int(len(joined) * self._fraction)
        self._inner.write(joined[:keep])
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class FaultInjectingFileSystem(FileSystem):
    """Wraps an inner FileSystem, injecting the schedule's faults on each
    operation. Register for a scheme to aim it at any persistence layer::

        fs = FaultInjectingFileSystem(InMemoryFileSystem(), schedule)
        register_filesystem("fault", lambda path: fs)
        repo = FileSystemMetricsRepository("fault://metrics.json")

    Fault keys: ("open", path), ("write", path) for tears, ("exists"|
    "listdir"|"delete"|"rename"|"makedirs", path).
    """

    def __init__(self, inner: FileSystem, schedule: FaultSchedule):
        self.inner = inner
        self.schedule = schedule

    def open(self, path: str, mode: str = "rb"):
        self.schedule.check(("open", path))
        handle = self.inner.open(path, mode)
        if "w" in mode or "a" in mode:
            fraction = self.schedule.torn_fraction(("write", path))
            if fraction is not None:
                return _TornWriter(handle, fraction, binary="b" in mode)
        return handle

    def exists(self, path: str) -> bool:
        self.schedule.check(("exists", path))
        return self.inner.exists(path)

    def makedirs(self, path: str) -> None:
        self.schedule.check(("makedirs", path))
        self.inner.makedirs(path)

    def listdir(self, path: str) -> List[str]:
        self.schedule.check(("listdir", path))
        return self.inner.listdir(path)

    def delete(self, path: str) -> None:
        self.schedule.check(("delete", path))
        self.inner.delete(path)

    def rename(self, src: str, dst: str) -> None:
        self.schedule.check(("rename", dst))
        self.inner.rename(src, dst)

    def join(self, *parts: str) -> str:
        return self.inner.join(*parts)


class FlakyBatchSource(BatchSource):
    """BatchSource wrapper injecting faults per absolute batch index.

    The fault fires BEFORE the underlying batch is consumed, so a retry
    (reopen at the same index) re-reads the real data — exactly the shape
    of a transient storage error. Fault keys are ``("batch", index)``;
    pair with ``FaultSchedule(fail={("batch", 3): 2})`` for 'batch 3
    fails twice then reads fine' or ``FaultSchedule.PERMANENT`` for a
    poisoned batch only quarantine can get past.
    """

    def __init__(self, inner: BatchSource, schedule: FaultSchedule):
        self.inner = inner
        self.schedule = schedule

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return self.inner.num_rows

    @property
    def _batch_rows(self):
        return getattr(self.inner, "_batch_rows", None)

    def batches(self, columns=None, batch_rows=None):
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def batches_from(self, start: int = 0, columns=None, batch_rows=None):
        idx = start
        inner_it = None
        while True:
            self.schedule.check(("batch", idx))
            if inner_it is None:
                inner_it = self.inner.batches_from(
                    idx, columns=columns, batch_rows=batch_rows
                )
            try:
                batch = next(inner_it)
            except StopIteration:
                return
            yield batch
            idx += 1


# -- device-fault injection --------------------------------------------------

# the messages torch and the CUDA runtime print for each kind, so the
# classifier runs on the strings a real fault carries
_DEVICE_FAULT_MESSAGES = {
    "oom": (
        "CUDA out of memory. Tried to allocate {nbytes} bytes. "
        "[injected scan_id={scan_id} attempt={attempt}]"
    ),
    "compile": (
        "CUDA error: no kernel image is available for execution on the "
        "device [injected scan_id={scan_id} attempt={attempt}]"
    ),
    "lost": (
        "CUDA error: an illegal memory access was encountered "
        "[injected scan_id={scan_id} attempt={attempt}]"
    ),
}


# the same, naming the mesh member the fault is pinned to, as a CUDA
# failure names its card, so the classifier attributes it
_TARGETED_FAULT_MESSAGES = {
    "oom": (
        "CUDA out of memory. Tried to allocate {nbytes} bytes. GPU {device} has "
        "a total capacity of 79.19 GiB [injected scan_id={scan_id} attempt={attempt}]"
    ),
    "compile": (
        "CUDA error: no kernel image is available for execution on the device "
        "(CUDA device {device}) [injected scan_id={scan_id} attempt={attempt}]"
    ),
    "lost": (
        "CUDA error: an illegal memory access was encountered on cuda:{device} "
        "[injected scan_id={scan_id} attempt={attempt}]"
    ),
}


class FaultInjectingScanHook:
    """Seeded, scripted device faults at the scan engine's execute seam.

    Install with ``ops.scan_engine.install_scan_fault_hook(hook)``. The
    engine calls the hook just before each chunk's step with ``(boundary,
    ctx)``, ctx = {scan_id, attempt, chunk_index}:

    - ``scan_id`` numbers logical ``run_scan`` calls process-wide and stays
      the same across the retries of one scan — in a resilient stream each
      batch is one scan, so scripting by scan id is scripting by batch;
    - ``attempt`` counts the engine's retries of that scan, so
      ``faults={k: ("oom", 1)}`` means scan k OOMs once and succeeds on the
      first bisected retry, and ``("lost", FaultSchedule.PERMANENT)`` is a
      dead card.

    Kinds: ``"oom"`` / ``"compile"`` / ``"lost"`` raise an
    ``InjectedDeviceError`` carrying the message torch prints for such a
    fault (classified as the real one); ``"hang"`` sleeps ``hang_seconds``
    inside the watchdog-wrapped call — a stall on the host at the execute
    seam, so an armed ``device_deadline`` converts it into a
    ``DeviceHangException`` (a kernel spinning on the card could not be
    cancelled and would leave the CUDA context unusable) — and returns.

    Mesh targeting: a 3-tuple spec ``(kind, times, member)`` pins the
    fault to one mesh member. It fires only while that member id is in
    the scan's mesh (``ctx["device_ids"]``), and its message names the
    member as a CUDA failure names its card, so the classifier attributes
    it (``exceptions.implicated_devices``) and the mesh ladder sheds the
    member: ``("lost", FaultSchedule.PERMANENT, 2)`` stops faulting once a
    reshard drops member 2, as a dead card no one launches on any more. A
    targeted ``"hang"`` stalls the step while the member is in the mesh.

    Tenant targeting (the serving layer's poison tenant): ``tenant_faults``
    maps a tenant's label to a kind. It fires at every coalesced dispatch
    whose members include the tenant (the executor's ``ctx["tenants"]``),
    and, once a dispatch of that tenant alone faulted, at every attempt of
    the next scan that names no tenants — the serial rung the service runs
    the tenant on — so the fault follows the tenant through the service's
    bisection to its serial ladder.

    ``faults`` keys are scan ids; with ``relative=True`` they count from
    the first scan this hook observes. Every injection appends ``(kind,
    scan_id, attempt)`` — ``(kind, scan_id, attempt, member)`` for a
    targeted fault — to ``injected`` and every observation ``(boundary,
    scan_id, attempt, chunk_index)`` to ``calls``, so replays compare. The
    reference's spared CPU-fallback attempts (the port has none) and its
    lost-device release of a hang are not carried."""

    def __init__(
        self,
        faults: Optional[Dict[int, Union[str, Tuple]]] = None,
        hang_seconds: float = 30.0,
        relative: bool = True,
        tenant_faults: Optional[Dict[str, str]] = None,
    ):
        self.faults: Dict[int, Tuple[str, float, Optional[int]]] = {}
        self.tenant_faults = dict(tenant_faults or {})
        for kind in self.tenant_faults.values():
            if kind not in ("oom", "compile", "lost"):
                raise ValueError(f"unknown tenant fault kind {kind!r}")
        # the kind of a tenant fault whose lone dispatch faulted, until the
        # serial scan after it is seen; then that scan's id and kind
        self._serial_next: Optional[str] = None
        self._serial_scan: Optional[Tuple[int, str]] = None
        for scan, spec in (faults or {}).items():
            if isinstance(spec, str):
                spec = (spec, 1)
            if len(spec) not in (2, 3):
                raise ValueError(
                    f"a device fault is (kind, times) or (kind, times, member), got {spec!r}"
                )
            kind, times = spec[:2]
            member = spec[2] if len(spec) == 3 else None
            if kind not in ("oom", "compile", "lost", "hang"):
                raise ValueError(f"unknown device fault kind {kind!r}")
            self.faults[int(scan)] = (kind, float(times),
                                      None if member is None else int(member))
        self.hang_seconds = float(hang_seconds)
        self.relative = bool(relative)
        self._base_scan_id: Optional[int] = None
        self.injected: List[Tuple] = []
        self.calls: List[Tuple[str, int, int, int]] = []

    def __call__(self, boundary: str, ctx: Dict) -> None:
        scan_id = int(ctx.get("scan_id", -1))
        if self.relative:
            if self._base_scan_id is None:
                self._base_scan_id = scan_id
            scan_id -= self._base_scan_id
        attempt = int(ctx.get("attempt", 0))
        self.calls.append((boundary, scan_id, attempt, int(ctx.get("chunk_index", -1))))
        if self.tenant_faults:
            self._tenant_fault(scan_id, attempt, ctx)
        spec = self.faults.get(scan_id)
        if spec is None:
            return
        kind, times, member = spec
        if attempt >= times:
            return
        if member is not None:
            # a targeted fault fires only while its member is in the mesh
            if member not in (ctx.get("device_ids") or ()):
                return
            self.injected.append((kind, scan_id, attempt, member))
        else:
            self.injected.append((kind, scan_id, attempt))
        if kind == "hang":
            time.sleep(self.hang_seconds)
            return
        messages = _DEVICE_FAULT_MESSAGES if member is None else _TARGETED_FAULT_MESSAGES
        raise InjectedDeviceError(messages[kind].format(
            nbytes=8 << 30, scan_id=scan_id, attempt=attempt, device=member))

    def _tenant_fault(self, scan_id: int, attempt: int, ctx: Dict) -> None:
        """Raise a tenant-targeted fault where one applies (class doc)."""
        tenants = ctx.get("tenants")
        kind = None
        if tenants is not None:
            hit = [t for t in tenants if t in self.tenant_faults]
            if hit:
                kind = self.tenant_faults[hit[0]]
                self._serial_next = kind if len(tenants) == 1 else None
                self.injected.append((kind, scan_id, attempt, tuple(hit)))
        elif self._serial_scan is not None and self._serial_scan[0] == scan_id:
            kind = self._serial_scan[1]
            self.injected.append((kind, scan_id, attempt, "serial"))
        elif self._serial_next is not None:
            kind, self._serial_next = self._serial_next, None
            self._serial_scan = (scan_id, kind)
            self.injected.append((kind, scan_id, attempt, "serial"))
        if kind is not None:
            raise InjectedDeviceError(_DEVICE_FAULT_MESSAGES[kind].format(
                nbytes=8 << 30, scan_id=scan_id, attempt=attempt))
