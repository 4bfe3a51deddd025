"""Device-fault policy for the scan engine — boundary classification, the
compute watchdog, the fault-injection seam and the health of the card and
of each mesh member (the port of ``deequ_tpu/ops/device_policy.py``).

- :func:`device_call` wraps one device-boundary call of a scan
  (``transfer`` / ``execute`` / ``fetch``): a raw torch or CUDA error
  re-raises as its typed ``Device*Exception`` (``exceptions.py``), and with
  a wall-clock ``deadline`` the call runs on a watchdog worker thread, so a
  hung call becomes a typed ``DeviceHangException`` instead of a frozen
  run. CUDA runs asynchronously: a fault or a stall of the card surfaces
  at the next synchronising call, the scan's fetch, so the watchdog and
  the classification are armed there as well as around each chunk's step;
- :func:`install_scan_fault_hook` is the deterministic injection seam the
  fault tests drive (``resilience/faults.py:FaultInjectingScanHook``); it
  fires inside the watchdog, so an injected stall is converted like a real
  one;
- :class:`DeviceHealth` counts classified faults, so a device that faults
  again and again opens a circuit breaker: scans under
  ``on_device_error="fallback"`` are then refused up front
  (``DeviceFallbackRefusedException``), with a half-open probe on the card
  every ``probe_interval``-th scan;
- :class:`MeshHealth` keeps the same count per mesh member: a member a
  fault names is quarantined, and the next scan builds its mesh without
  it up front; :func:`default_shard_deadline` is the straggler deadline
  armed on the chunk steps of a scan over two or more members.

A worker abandoned by the watchdog may wake up long after its caller
moved on. :func:`current_watchdog_call_abandoned` tells code running on
such a worker (or on a worker that worker started) that its call was
given up: it must launch nothing more on the card and count nothing
(``ScanStats.record_fetch`` drops its fetch). The degradation policies
themselves (bisection, eviction, demotion, refusal) live in
``ops/scan_executors.py``; this module only decides *what* failed and
*whether* the device is still trusted.

It also holds the histogram kernel-variant policy
(:func:`resolve_hist_variant`, the reference's ``device_policy.py:81-158``):
which variant of ``ops/histogram_device.py`` a dispatch or a plan runs, by
the force switch, the row count and the platform's width cap
(:func:`hist_cpu_cap`, :func:`hist_accel_cap`, which the plan cost model,
``ops/plan_cost.py``, also prices against).
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Any, Callable, Dict, Optional

from deequ_tpu_torch.exceptions import (
    DeviceException,
    DeviceHangException,
    DeviceLostException,
    MeshDegradedException,
    device_boundary,
)
from deequ_tpu_torch.obs.recorder import current_recorder

# -- the histogram kernel-variant policy -----------------------------------------

#: widest keyspace the one-hot variant takes by default on a CPU device: the
#: reference's round-14 crossover, where its f32 sgemm form stops beating
#: the scatter (the port's CPU plain versions keep the reference's choice)
HIST_ONEHOT_CPU_MAX_SEGMENTS = 32

#: widest keyspace the one-hot variant (K6, ``csrc/onehot.cu``) takes by
#: default on a card: chip_smoke.py's ``cap_from_sweep`` over its sweep
#: (10^7 int64 Zipf ids at 9 to 2^22 bins on an H100, K6 and K5 timed in
#: turns), the widest swept width up to which K6 was no slower than K5 at
#: every swept width (PERF.md). K6 was slower at the narrowest, 9 bins,
#: and at every other, so the cap is 0 and no width routes to it by
#: default: only the force switch reaches it, as the reference's "pallas"
#: is reached. (The reference's cap, 2^17, bounds its MXU planes.)
HIST_ONEHOT_MXU_MAX_SEGMENTS = 0

#: below this many rows a dispatch keeps the scatter variant (the
#: reference's: the dispatch outweighs any kernel's difference)
HIST_MIN_ROWS = 1 << 14


def hist_cpu_cap() -> int:
    """The one-hot cap on a CPU device: ``DEEQU_TORCH_HIST_CPU_CAP`` when
    set, else :data:`HIST_ONEHOT_CPU_MAX_SEGMENTS` (read at each call, so a
    monkeypatched constant steers it)."""
    from deequ_tpu_torch.envcfg import env_value

    value = env_value("DEEQU_TORCH_HIST_CPU_CAP")
    return HIST_ONEHOT_CPU_MAX_SEGMENTS if value is None else value


def hist_accel_cap() -> int:
    """The one-hot cap on a card: ``DEEQU_TORCH_HIST_ACCEL_CAP`` when set,
    else :data:`HIST_ONEHOT_MXU_MAX_SEGMENTS`."""
    from deequ_tpu_torch.envcfg import env_value

    value = env_value("DEEQU_TORCH_HIST_ACCEL_CAP")
    return HIST_ONEHOT_MXU_MAX_SEGMENTS if value is None else value


def default_platform() -> str:
    """The port's default device type: "cuda" where it resolves to a card,
    "cpu" otherwise (a ``use_device("cpu")`` scope, or no card)."""
    from deequ_tpu_torch.device import resolve_device
    from deequ_tpu_torch.exceptions import DeviceUnavailableException

    try:
        return resolve_device(None).type
    except DeviceUnavailableException:
        return "cpu"


def resolve_hist_variant(
    widths,
    rows: Optional[int] = None,
    platform: Optional[str] = None,
    force: Optional[str] = None,
) -> str:
    """The histogram variant of one dispatch or plan, in the reference's
    order: the ``force`` argument, then ``DEEQU_TORCH_HIST_VARIANT``; no
    ``widths`` -> "scatter"; fewer than :data:`HIST_MIN_ROWS` ``rows`` (None
    means many: a resident chunk) -> "scatter"; else "onehot" when the
    widest width is within the platform's cap (:func:`hist_cpu_cap` on
    "cpu", :func:`hist_accel_cap` otherwise), "scatter" past it. The
    platform defaults to :func:`default_platform`. "pallas" is never
    resolved by default (on a card it is K5, as "scatter" is)."""
    from deequ_tpu_torch.envcfg import env_value
    from deequ_tpu_torch.ops.histogram_device import HIST_VARIANTS

    if force is None:
        force = env_value("DEEQU_TORCH_HIST_VARIANT")
    if force is not None:
        if force not in HIST_VARIANTS:
            raise ValueError(f"hist variant must be one of {HIST_VARIANTS}, got {force!r}")
        return force
    widths = tuple(int(w) for w in widths)
    if not widths:
        return "scatter"
    if rows is not None and rows < HIST_MIN_ROWS:
        return "scatter"
    if platform is None:
        platform = default_platform()
    cap = hist_cpu_cap() if platform == "cpu" else hist_accel_cap()
    return "onehot" if max(widths) <= cap else "scatter"


# -- fault-injection seam ----------------------------------------------------

# The installed hook is called as hook(boundary, ctx) just before the
# wrapped device call runs (inside the watchdog). ctx carries {"scan_id",
# "attempt", "chunk_index"} — see FaultInjectingScanHook.
_SCAN_FAULT_HOOK: Optional[Callable[[str, Dict[str, Any]], None]] = None


def install_scan_fault_hook(hook) -> Optional[Callable]:
    """Install (or, with None, remove) the scan engine's fault hook;
    returns the hook installed before, so a caller can restore it."""
    global _SCAN_FAULT_HOOK
    previous = _SCAN_FAULT_HOOK
    _SCAN_FAULT_HOOK = hook
    return previous


def current_scan_fault_hook():
    return _SCAN_FAULT_HOOK


# -- compute watchdog ----------------------------------------------------------


def default_device_deadline() -> Optional[float]:
    """The process-wide watchdog deadline (seconds) from
    ``DEEQU_TORCH_DEVICE_DEADLINE``; unset, empty or 0 disarms it, a
    malformed value raises ``EnvConfigError``."""
    from deequ_tpu_torch.envcfg import env_value

    return env_value("DEEQU_TORCH_DEVICE_DEADLINE")


def default_shard_deadline() -> Optional[float]:
    """The process-wide straggler deadline (seconds) from
    ``DEEQU_TORCH_SHARD_DEADLINE``, armed only on scans over a mesh of two
    or more members: a member that stalls a chunk step past it raises
    ``DeviceHangException`` (a ``mesh_straggler`` event) instead of
    freezing the mesh. Unset, empty or 0 disarms it; a malformed value
    raises ``EnvConfigError``."""
    from deequ_tpu_torch.envcfg import env_value

    return env_value("DEEQU_TORCH_SHARD_DEADLINE")


#: the watchdog call a worker thread is running: {"abandoned", "parent"},
#: where "parent" is the call state of the thread that started it
_WATCHDOG_TLS = threading.local()


class WatchdogAbandoned(Exception):
    """Raised on a watchdog worker whose call was abandoned, where it would
    otherwise launch on the card; its caller has raised
    ``DeviceHangException`` already and reads nothing of it."""


def current_watchdog_call_abandoned() -> bool:
    """True when the calling thread runs a watchdog call that timed out and
    was abandoned — or runs inside one (a call started by such a call): its
    launches and its telemetry must not land on a later run."""
    state = getattr(_WATCHDOG_TLS, "state", None)
    while state is not None:
        if state["abandoned"]:
            return True
        state = state["parent"]
    return False


def check_not_abandoned() -> None:
    """Raise :class:`WatchdogAbandoned` on an abandoned watchdog call (see
    :func:`current_watchdog_call_abandoned`); a no-op elsewhere."""
    if current_watchdog_call_abandoned():
        raise WatchdogAbandoned("the watchdog abandoned this call")


class _WatchdogPool:
    """Reusable daemon workers for deadline-bounded calls.

    A worker parks on an inbox of its own between calls, so a call costs a
    queue handoff, not a thread start. A worker whose call timed out is
    abandoned (a hung device call cannot be cancelled from Python, only
    detected): it never returns to the idle stack and exits when its call
    ends, if ever. The pool holds as many workers as calls were ever armed
    at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: list = []

    def _spawn(self):
        inbox: "queue.SimpleQueue" = queue.SimpleQueue()

        def loop():
            while True:
                fn, box, done, state = inbox.get()
                # the call's state is visible from inside the call, so its
                # telemetry (record_fetch) can tell whether it was abandoned
                _WATCHDOG_TLS.state = state
                try:
                    box["value"] = fn()
                except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
                    box["error"] = e
                finally:
                    _WATCHDOG_TLS.state = None
                done.set()
                # drop the job before parking: an idle worker must not pin
                # the last call's closure (chunk planes, a fold) or result
                fn = box = done = None
                with self._lock:
                    abandoned, state = state["abandoned"], None
                    if abandoned:
                        return
                    self._idle.append(inbox)

        threading.Thread(target=loop, daemon=True, name="deequ-torch-watchdog").start()
        return inbox

    def call(self, fn: Callable, deadline: float, what: str, boundary: str):
        with self._lock:
            inbox = self._idle.pop() if self._idle else None
        if inbox is None:
            inbox = self._spawn()
        box: Dict[str, Any] = {}
        done = threading.Event()
        state = {"abandoned": False, "parent": getattr(_WATCHDOG_TLS, "state", None)}
        inbox.put((fn, box, done, state))
        if not done.wait(deadline):
            with self._lock:
                # the call may have ended at the wire: abandon (and raise)
                # only if it is still in flight — the lock orders this
                # against the worker's decision to park again
                if not done.is_set():
                    state["abandoned"] = True
            if state["abandoned"]:
                raise DeviceHangException(
                    f"[{boundary}] {what} exceeded the {deadline:g}s watchdog "
                    "deadline — treating the device as hung",
                    boundary=boundary,
                    deadline=deadline,
                )
        if "error" in box:
            raise box["error"]
        return box.get("value")


_WATCHDOG_POOL = _WatchdogPool()


def on_callers_stream(fn: Callable, device) -> Callable:
    """``fn`` wrapped to run, on another thread, on the calling thread's
    CUDA device and current stream (torch keeps both per thread): a chunk's
    launches then queue behind the work the caller queued, and the copy
    events it waits on are those the caller recorded. ``fn`` itself on the
    CPU."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return fn
    device = torch.device(device)
    stream = torch.cuda.current_stream(device)

    def on_stream():
        torch.cuda.set_device(device)
        with torch.cuda.stream(stream):
            return fn()

    return on_stream


def call_with_deadline(fn: Callable, deadline: float, what: str, boundary: str,
                       device=None):
    """Run ``fn`` on a pooled watchdog worker (on the caller's device and
    stream, in a copy of its context: the ``use_device`` and ``use_mesh``
    scopes hold there too); past ``deadline`` seconds raise
    DeviceHangException and abandon the worker."""
    context = contextvars.copy_context()
    fn = on_callers_stream(fn, device)
    return _WATCHDOG_POOL.call(lambda: context.run(fn), deadline, what, boundary)


def device_call(
    fn: Callable,
    boundary: str,
    what: str = "device call",
    deadline: Optional[float] = None,
    hook_ctx: Optional[Dict[str, Any]] = None,
    device=None,
):
    """Run one device-boundary call under classification, with an optional
    watchdog and an optional injected fault.

    A raw torch or CUDA failure re-raises as its typed DeviceException
    (``__cause__`` kept); any other error propagates untouched. The fault
    hook fires only where ``hook_ctx`` is passed (a chunk's step). With
    ``deadline`` the call runs on a watchdog worker, on ``device``'s
    current stream of the calling thread. A call made on a watchdog worker
    whose call was abandoned — before it starts, or while in the hook —
    raises ``WatchdogAbandoned`` instead of running ``fn``: it launches
    nothing on the card."""
    hook = _SCAN_FAULT_HOOK if hook_ctx is not None else None

    def body():
        check_not_abandoned()
        if hook is not None:
            hook(boundary, hook_ctx)
            check_not_abandoned()
        return fn()

    def classified():
        with device_boundary(boundary):
            if deadline is not None:
                return call_with_deadline(body, deadline, what, boundary, device)
            return body()

    # the flight recorder's boundary seam: with a recorder armed each
    # device boundary is a span on the caller's thread, the watchdog's
    # wait included, so a hang shows as a long span ending in a typed error
    rec = current_recorder()
    if rec is not None:
        with rec.span(boundary, what=what):
            return classified()
    return classified()


# -- the device's health ---------------------------------------------------------


class DeviceHealth:
    """Consecutive-fault counter of the card: a circuit breaker.

    After ``threshold`` consecutive classified faults with no successful
    scan between them, ``should_force_fallback()`` turns true and scans
    under ``on_device_error="fallback"`` are refused up front (the
    reference sends them to its CPU backend; the port never falls back).
    Every ``probe_interval``-th such decision is a half-open probe instead:
    the scan runs on the card, and one success resets the counter.
    ``last_fault`` is the newest fault recorded, the ``__cause__`` of an
    up-front refusal."""

    def __init__(self, threshold: int = 3, probe_interval: int = 8):
        self.threshold = int(threshold)
        self.probe_interval = int(probe_interval)
        self.reset()

    def reset(self) -> None:
        self.consecutive_faults = 0
        self.total_faults = 0
        self.last_fault: Optional[DeviceException] = None
        self._forced = 0

    def record_fault(self, exc: DeviceException) -> None:
        self.consecutive_faults += 1
        self.total_faults += 1
        self.last_fault = exc

    def record_success(self) -> None:
        self.consecutive_faults = 0
        self._forced = 0

    def should_force_fallback(self) -> bool:
        if self.consecutive_faults < self.threshold:
            return False
        self._forced += 1
        if self.probe_interval and self._forced % self.probe_interval == 0:
            return False  # half-open probe: try the card this once
        return True


#: the process-wide health of the card, read by run_scan's refusal policy
DEVICE_HEALTH = DeviceHealth()


# -- the mesh members' health ------------------------------------------------------


class MeshHealth:
    """Per-member fault registry of a mesh — :class:`DeviceHealth` at the
    granularity of a member (the reference's ``MeshHealth``).

    A classified fault that names its members (``device_ids``) counts
    against them, not the whole device: one flaky member of eight costs
    one member. A member whose consecutive faults reach ``threshold`` is
    quarantined, and later scans build their mesh without it up front;
    every ``probe_interval``-th such decision readmits the quarantined
    members for one probe, and a scan that completes over a member clears
    its record. A ``DeviceLostException`` or ``MeshDegradedException``
    quarantines at once; other attributed faults (an OOM that names its
    card) count one step."""

    def __init__(self, threshold: int = 2, probe_interval: int = 8):
        self.threshold = int(threshold)
        self.probe_interval = int(probe_interval)
        self.reset()

    def reset(self) -> None:
        self.consecutive_faults: Dict[int, int] = {}
        self.total_faults: Dict[int, int] = {}
        self._filtered = 0

    def record_fault(self, exc: DeviceException) -> None:
        """Count one fault against every member it names (an
        unattributed fault is :class:`DeviceHealth`'s)."""
        fatal = isinstance(exc, (DeviceLostException, MeshDegradedException))
        for did in getattr(exc, "device_ids", ()) or ():
            count = self.consecutive_faults.get(did, 0) + 1
            if fatal:
                count = max(count, self.threshold)
            self.consecutive_faults[did] = count
            self.total_faults[did] = self.total_faults.get(did, 0) + 1

    def record_success(self, device_ids) -> None:
        """A scan completed over these members: their records clear (only
        theirs — a success on a shrunken mesh says nothing of the member
        left out)."""
        for did in device_ids:
            self.consecutive_faults.pop(int(did), None)

    def quarantined(self) -> frozenset:
        return frozenset(
            did for did, count in self.consecutive_faults.items() if count >= self.threshold
        )

    def healthy_subset(self, device_ids):
        """(healthy, excluded) of ``device_ids`` for a scan about to build
        its mesh; the half-open probe counter advances only when something
        would be excluded."""
        bad = self.quarantined()
        ids = [int(d) for d in device_ids]
        excluded = [d for d in ids if d in bad]
        if not excluded:
            return ids, []
        self._filtered += 1
        if self.probe_interval and self._filtered % self.probe_interval == 0:
            return ids, []  # half-open probe: the whole mesh this once
        return [d for d in ids if d not in bad], excluded


#: the process-wide health of each mesh member, read by run_scan's
#: up-front quarantine and the mesh ladder
MESH_HEALTH = MeshHealth()
