"""The run flight recorder — typed span and event records on the host's
monotonic clock (the counterpart of ``deequ_tpu/obs/recorder.py``).

The engine's counters (``ScanStats``, ``RETRY_TELEMETRY``, the run
budget's ledger) say how much happened; the recorder says when. Every
seam the engine owns — each device boundary (``device_call``: transfer,
execute, fetch), each attempt of the fault ladder, each rung taken, each
budget charge and I/O retry, a coalesced batch's assembly, and each
served request from submit to resolve — emits a :class:`SpanRecord` into
a ring-bounded recorder when one is armed, and nothing when none is.

Design constraints, in order:

1. **Disarmed is free.** Tracing is off by default. The disarmed path of
   :func:`current_recorder` reads one module-global counter and returns
   None: no allocation, no lock, no thread-local lookup, and no
   instrument write.
2. **Bounded.** Records land in a ring of ``capacity`` records; a full
   recorder drops the oldest and counts the drops (``dropped``), so a
   long-lived traced service keeps a rolling window.
3. **Host-side only.** Spans are emitted on the host around device work;
   a span's wall covers the host's call, and where that call synchronises
   (a fetch) the device time before it.
4. **Thread-aware.** Each record carries its thread (``track``) and its
   parent span on that thread. The seams that run work on other threads
   (the run budget's watchdog worker, the stream's reader, the serving
   worker) re-enter :func:`recording_scope` with the caller's span as the
   seeded parent, so their records stay parented in the exported trace.

Arming, three ways:

- ``VerificationSuite.do_verification_run(trace=...)`` /
  ``VerificationRunBuilder.with_tracing(...)`` — one verification run,
  summary on ``VerificationResult.run_trace``;
- ``VerificationService(trace=...)`` — a serving worker;
- ``DEEQU_TORCH_TRACE=1`` (``envcfg.py``) — a process-global recorder of
  ``DEEQU_TORCH_TRACE_CAPACITY`` records that the entry points pick up.

``obs/export.py`` renders a recording as Chrome-trace / Perfetto JSON;
:meth:`FlightRecorder.summary` is the compact per-phase breakdown.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

#: the default ring capacity: minutes of traced serving at a few hundred
#: records a suite, a few MB of host memory
DEFAULT_CAPACITY = 1 << 16

_SPAN_IDS = itertools.count(1)


@dataclass
class SpanRecord:
    """One record. ``kind`` is ``"span"`` (it has a duration) or
    ``"instant"`` (a point event: a rung taken, a budget charge). Times
    are ``time.monotonic()`` seconds; ``track`` is the emitting thread's
    name, or a synthetic per-tenant track for a served request."""

    name: str
    kind: str
    t_start: float
    track: str
    span_id: int
    parent_id: Optional[int] = None
    t_end: Optional[float] = None
    args: Dict[str, Any] = field(default_factory=dict)
    #: the recording stopped while the span was open (a killed service, a
    #: crashed run): the export closes it at the recording's end and marks
    #: it, so the truncation shows
    truncated: bool = False

    @property
    def duration(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start


class _OpenSpan:
    """The context manager of one open span (:meth:`FlightRecorder.span`)."""

    __slots__ = ("rec", "record")

    def __init__(self, rec: "FlightRecorder", record: SpanRecord):
        self.rec = rec
        self.record = record

    def __enter__(self) -> SpanRecord:
        return self.record

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.record.args["error"] = type(exc).__name__
        self.rec._close(self.record)


class FlightRecorder:
    """The ring-bounded recorder (module doc). Records may come from any
    thread; each thread keeps its own span stack. :meth:`records` returns
    the closed records in completion order; open spans are read by
    :meth:`open_spans` and exported as truncated."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._open: Dict[int, SpanRecord] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0
        self.started = time.monotonic()

    # -- emission ------------------------------------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def current_span_id(self) -> Optional[int]:
        """This thread's innermost open span: the parent a scope on a
        worker thread is seeded with."""
        stack = self._stack()
        return stack[-1] if stack else None

    def span(self, name: str, **args) -> _OpenSpan:
        """Open one span on this thread (``with rec.span("fetch"): ...``);
        it parents to the innermost open span of the thread."""
        stack = self._stack()
        record = SpanRecord(
            name=name, kind="span", t_start=time.monotonic(),
            track=threading.current_thread().name, span_id=next(_SPAN_IDS),
            parent_id=stack[-1] if stack else None, args=args,
        )
        stack.append(record.span_id)
        with self._lock:
            self._open[record.span_id] = record
        return _OpenSpan(self, record)

    def _close(self, record: SpanRecord) -> None:
        record.t_end = time.monotonic()
        stack = self._stack()
        if stack and stack[-1] == record.span_id:
            stack.pop()
        elif record.span_id in stack:  # closed out of order
            stack.remove(record.span_id)
        with self._lock:
            self._open.pop(record.span_id, None)
            self._append(record)

    def event(self, name: str, **args) -> SpanRecord:
        """One instant event, parented to this thread's innermost open
        span."""
        stack = self._stack()
        record = SpanRecord(
            name=name, kind="instant", t_start=time.monotonic(),
            track=threading.current_thread().name, span_id=next(_SPAN_IDS),
            parent_id=stack[-1] if stack else None, args=args,
        )
        with self._lock:
            self._append(record)
        return record

    def record_span(self, name: str, t_start: float, t_end: float,
                    track: Optional[str] = None, **args) -> SpanRecord:
        """Record a span whole, after the fact, with its own bounds: a
        served request's submit (on the caller's thread) to its resolve (on
        the worker), on a synthetic per-tenant track."""
        record = SpanRecord(
            name=name, kind="span", t_start=float(t_start), t_end=float(t_end),
            track=track if track is not None else threading.current_thread().name,
            span_id=next(_SPAN_IDS), args=args,
        )
        with self._lock:
            self._append(record)
        return record

    def _append(self, record: SpanRecord) -> None:
        # the caller holds self._lock
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(record)

    # -- reading -------------------------------------------------------------

    def records(self) -> List[SpanRecord]:
        """The closed records, in completion order (a copy of the ring)."""
        with self._lock:
            return list(self._ring)

    def open_spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._open.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self.dropped = 0
            self.started = time.monotonic()

    def summary(self, since: Optional[float] = None, dropped_baseline: int = 0) -> dict:
        """The per-phase breakdown (``VerificationResult.run_trace``): spans
        by name (count and wall seconds), instant events by name (count).
        ``since`` (a ``time.monotonic()`` stamp) keeps the records that
        started at or after it, and ``dropped_baseline`` (``dropped`` at the
        run's start) makes the drop count a delta: a shared or global
        recorder outlives any one run."""
        phases: Dict[str, dict] = {}
        events: Dict[str, int] = {}
        for r in self.records():
            if since is not None and r.t_start < since:
                continue
            if r.kind == "span":
                row = phases.setdefault(r.name, {"count": 0, "wall_seconds": 0.0})
                row["count"] += 1
                if r.duration is not None:
                    row["wall_seconds"] += r.duration
            else:
                events[r.name] = events.get(r.name, 0) + 1
        open_spans = [s for s in self.open_spans() if since is None or s.t_start >= since]
        return {
            "spans": sum(p["count"] for p in phases.values()),
            "events": sum(events.values()),
            "dropped": max(self.dropped - dropped_baseline, 0),
            "open": len(open_spans),
            "phases": phases,
            "event_counts": events,
        }


# -- ambient arming ------------------------------------------------------------

# thread-local, like the run budget's ambient slot: concurrent traced runs
# keep their own parent stacks, and the engine's worker-thread seams
# re-enter the scope explicitly. ``_armed`` counts the armed scopes and the
# global recorder: while it is 0, current_recorder() answers None from one
# integer read.
_AMBIENT = threading.local()
_GLOBAL: Optional[FlightRecorder] = None
_armed = 0
# ``_armed += 1`` is a load, an add and a store: a lost update would disarm
# live tracing, so the writes (scope entries, the global install) take a
# lock; the read in current_recorder() does not
_ARM_LOCK = threading.Lock()


def current_recorder() -> Optional[FlightRecorder]:
    """The recorder a seam emits into: this thread's scope, else the
    process-global recorder, else None (one integer read when nothing is
    armed anywhere)."""
    if not _armed:
        return None
    rec = getattr(_AMBIENT, "recorder", None)
    if rec is not None:
        return rec
    if getattr(_AMBIENT, "suppressed", False):
        return None
    return _GLOBAL


@contextmanager
def recording_scope(recorder: Optional[FlightRecorder],
                    parent: Optional[int] = None) -> Iterator[Optional[FlightRecorder]]:
    """Make ``recorder`` this thread's recorder for the block. ``parent``
    seeds the thread's span stack (a worker thread passes the caller's
    ``current_span_id()``). ``recorder=None`` suppresses tracing inside the
    block, the process-global recorder included."""
    global _armed
    prev = getattr(_AMBIENT, "recorder", None)
    prev_sup = getattr(_AMBIENT, "suppressed", False)
    _AMBIENT.recorder = recorder
    _AMBIENT.suppressed = recorder is None
    seeded = False
    if recorder is not None and parent is not None:
        recorder._stack().append(parent)
        seeded = True
    with _ARM_LOCK:
        _armed += 1
    try:
        yield recorder
    finally:
        with _ARM_LOCK:
            _armed -= 1
        if seeded:
            stack = recorder._stack()
            if parent in stack:
                stack.remove(parent)
        _AMBIENT.recorder = prev
        _AMBIENT.suppressed = prev_sup


def install_global_recorder(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install (or, with None, remove) the process-global recorder — what
    ``DEEQU_TORCH_TRACE=1`` arms. Returns the previous one."""
    global _GLOBAL, _armed
    with _ARM_LOCK:
        previous = _GLOBAL
        if previous is not None:
            _armed -= 1
        _GLOBAL = recorder
        if recorder is not None:
            _armed += 1
    return previous


def global_recorder() -> Optional[FlightRecorder]:
    return _GLOBAL


def maybe_arm_from_env() -> Optional[FlightRecorder]:
    """Arm the process-global recorder when ``DEEQU_TORCH_TRACE=1``
    (``DEEQU_TORCH_TRACE_CAPACITY`` sizes its ring; a malformed value
    raises ``EnvConfigError``). The entry points call it; it is idempotent
    and costs one environment read when the switch is off."""
    global _GLOBAL, _armed
    if _GLOBAL is not None:
        return _GLOBAL
    from deequ_tpu_torch.envcfg import env_value

    if not env_value("DEEQU_TORCH_TRACE"):
        return None
    capacity = env_value("DEEQU_TORCH_TRACE_CAPACITY") or DEFAULT_CAPACITY
    # two entry points racing on the first use must not each install one:
    # the loser's records would vanish from the global trace
    with _ARM_LOCK:
        if _GLOBAL is None:
            _GLOBAL = FlightRecorder(capacity=capacity)
            _armed += 1
    return _GLOBAL


def resolve_recorder(trace=None) -> Optional[FlightRecorder]:
    """A ``trace=`` argument as a recorder: a FlightRecorder is itself;
    ``True`` is the env-armed global recorder, else a fresh one scoped to
    the call (never installed process-wide: one traced call must not leave
    later runs armed); ``None`` and ``False`` give None (the callers scope
    ``False`` as a suppression)."""
    if trace is None or trace is False:
        return None
    if isinstance(trace, FlightRecorder):
        return trace
    if trace is True:
        rec = maybe_arm_from_env()
        return rec if rec is not None else FlightRecorder()
    raise ValueError(f"trace must be a FlightRecorder, True, False or None, got {trace!r}")
