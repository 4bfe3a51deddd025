"""VerificationService — asynchronous multi-tenant verification serving
(the counterpart of ``deequ_tpu/serve/service.py``).

``submit(table, checks, tenant=...)`` returns a :class:`VerificationFuture`
at once; one worker thread drains the pending queue, groups the suites of
one :class:`~deequ_tpu_torch.serve.plan_cache.PlanKey` (schema, analyzers,
layout, row count) and runs each group as one coalesced dispatch on the
card (``serve/executor.py``: one copy, one K1 batch, one fold merge, one
fetch). Suites the coalesced route cannot take — grouping or own-pass
analyzers, streaming, persisted or multi-chunk tables, a service placed
over a mesh, a quarantined tenant — run one by one through
``VerificationSuite``, with the same results.

Placement: the worker runs in a copy of the constructing thread's context,
so its ``use_device`` and ``use_mesh`` scopes reach the worker (a thread
does not inherit contextvars), and under the constructing thread's
recorder; ``device=`` places the worker on a device of its own. Without a
card and without a CPU scope the worker's runs raise
``DeviceUnavailableException``, typed, on each future, as the port's scans
do.

Isolation, a coalesced dispatch at a time:

1. a fault the port's fault ladder would retry — an OOM, or a fault that
   names mesh members — BISECTS the batch: each half retries as a fresh
   dispatch, every member's run budget charged ``coalesce_retry``, so a
   poison tenant is found in O(log K) while every healthy member
   completes; a sticky fault — a lost device, whose CUDA context is
   unusable, a kernel that does not build, a hang — splits nothing and
   rejects every member of the batch, typed;
2. a member that still faults alone falls to the serial rung:
   ``VerificationSuite``'s full ladder under its own budget, where the
   reference's CPU fallback is the port's typed refusal
   (``DeviceFallbackRefusedException``);
3. a member whose budget runs out degrades only its own result (typed
   failure metrics under ``on_budget_exhausted="degrade"``, a typed
   rejection under ``"raise"``);
4. a tenant that keeps failing is quarantined (a ``tenant_quarantine``
   event): it is served serially until a success readmits it.

Kill-and-resume: ``stop(drain=False)`` halts the worker after its batch
and returns the pending requests (a :class:`PendingWork`, with the
quarantine ledger); a fresh service's ``resume(pending)`` resolves them on
their original futures.

Every resolution is observed once: the ``serve_latency_seconds`` histogram
of ``obs/registry.py`` (submit to resolve, which ends after the batch's
synchronising fetch) and, when tracing is armed, a ``serve_request`` span
on a per-tenant track.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from concurrent.futures import CancelledError
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.exceptions import (
    DeadlineExceededException,
    DeviceException,
    DeviceOOMException,
    RunBudgetExhaustedException,
    ServiceClosedException,
    wrap_if_necessary,
)
from deequ_tpu_torch.serve.admission import (
    SLO_CLASSES,
    AdmissionController,
    BrownoutController,
    TenantFairQueue,
    resolve_slo,
)


@dataclass
class ServeConfig:
    """The service's knobs. ``max_batch`` / ``coalesce_window`` default to
    ``DEEQU_TORCH_SERVE_MAX_BATCH`` / ``DEEQU_TORCH_SERVE_COALESCE_WINDOW``
    and ``brownout`` to ``DEEQU_TORCH_BROWNOUT`` (``envcfg.py``).
    ``run_policy`` is each tenant's default fault budget
    (``resilience/governance.RunPolicy``; None: ungoverned unless a submit
    gives one); ``quarantine_after`` the consecutive failures that park a
    tenant on the serial route."""

    max_batch: Optional[int] = None
    coalesce_window: Optional[float] = None
    max_pending: int = 4096
    run_policy: Any = None
    on_device_error: str = "fail"
    quarantine_after: int = 2
    plan_cache_size: int = 256
    #: the SLO of a submission that carries none (None: the envcfg default
    #: at each submit, ``admission.Slo.default``)
    default_slo: Any = None
    #: the brownout ladder on or off (None: ``DEEQU_TORCH_BROWNOUT``)
    brownout: Optional[bool] = None
    #: recent submit->resolve p95 (s) above which the ladder holds level 1
    #: or more with a shallow queue (None: the depth signal alone)
    brownout_latency_high: Optional[float] = None
    #: each tenant's queued cap at brownout level 2 or more (None:
    #: max_pending // 16, at least 1)
    inflight_cap: Optional[int] = None
    #: per-class queue shares merged over ``admission.CLASS_QUEUE_SHARE``
    class_share: Optional[Dict[str, float]] = None

    def __post_init__(self):
        from deequ_tpu_torch.envcfg import env_value

        if self.max_batch is None:
            self.max_batch = env_value("DEEQU_TORCH_SERVE_MAX_BATCH")
        if self.coalesce_window is None:
            self.coalesce_window = env_value("DEEQU_TORCH_SERVE_COALESCE_WINDOW")
        if self.brownout is None:
            self.brownout = env_value("DEEQU_TORCH_BROWNOUT")
        self.max_batch = int(self.max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.coalesce_window = float(self.coalesce_window)
        if self.coalesce_window < 0:
            raise ValueError("coalesce_window must be >= 0 seconds")
        if self.on_device_error not in ("fail", "fallback"):
            raise ValueError(
                f"on_device_error must be 'fail' or 'fallback', got {self.on_device_error!r}")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")


class VerificationFuture:
    """The handle of one submitted suite: ``result(timeout)`` blocks for
    its VerificationResult (or raises its typed failure); ``cancel()``
    succeeds only while the request is queued. The first resolution wins:
    ``resolve_count`` is 0 or 1, and later attempts are counted in
    ``late_resolutions`` and dropped."""

    def __init__(self, tenant):
        self.tenant = tenant
        self.submitted_at = time.monotonic()
        self.resolved_at: Optional[float] = None
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._started = False
        self._lock = threading.Lock()
        self.resolve_count = 0
        self.late_resolutions = 0
        # the service's observation seam, called once after a resolve or
        # reject (never for a cancel: work that never ran has no latency)
        self._on_done = None

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Cancel while still queued; False once the request started or
        finished."""
        with self._lock:
            if self._started or self._done.is_set():
                return False
            self._cancelled = True
            self._done.set()
        return True

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                "verification result not ready within "
                f"{timeout if timeout is not None else 'inf'}s")
        if self._cancelled:
            raise CancelledError()
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_seconds(self) -> Optional[float]:
        if self.resolved_at is None:
            return None
        return self.resolved_at - self.submitted_at

    def _claim(self) -> bool:
        """Mark started; False when cancelled or already resolved."""
        with self._lock:
            if self._cancelled or self._done.is_set():
                return False
            self._started = True
            return True

    def _apply(self, result, error) -> bool:
        """The first resolution wins: outcome, time and the done flag
        commit together under the lock."""
        with self._lock:
            if self._done.is_set():
                self.late_resolutions += 1
                return False
            self._result = result
            self._error = error
            self.resolved_at = time.monotonic()
            self.resolve_count += 1
            self._done.set()
            return True

    def _resolve(self, result) -> None:
        if self._apply(result, None) and self._on_done is not None:
            self._on_done(self, True)

    def _reject(self, error: BaseException) -> None:
        if self._apply(None, error) and self._on_done is not None:
            self._on_done(self, False)


class PendingWork(list):
    """What ``stop(drain=False)`` returns: the accepted requests not yet
    served, and the quarantine ledger's snapshot (``tenant_health``), so a
    poison tenant is not given a fresh start by a recycled worker."""

    def __init__(self, requests=(), tenant_health: Optional[dict] = None):
        super().__init__(requests)
        self.tenant_health = tenant_health


@dataclass
class ServeRequest:
    """One queued suite."""

    data: Any
    checks: Tuple
    required_analyzers: Tuple
    tenant: Any
    run_policy: Any
    future: VerificationFuture
    #: the submission's SLO and its absolute monotonic deadline (None: no
    #: deadline), stamped once at acceptance: a resume carries it, so the
    #: queue wait accrues across a recycled worker
    slo: Any = None
    deadline_at: Optional[float] = None
    #: set at admission: the de-duplicated analyzers and the plan key
    analyzers: Tuple = ()
    key: Any = None
    coalescable: bool = False
    #: the packer built at admission, reused by the executor
    packer: Any = None
    #: the predicted plan cost (``ops/plan_cost.py``), stamped at submit
    predicted_cost: float = 0.0


class _TenantHealth:
    """The consecutive-failure ledger behind quarantine (half-open: one
    success readmits the tenant), under a lock: the worker records, and a
    caller's ``stop`` snapshots."""

    def __init__(self, threshold: int):
        self.threshold = threshold
        self.failures: Dict[Any, int] = {}
        self.quarantined: set = set()
        self._lock = threading.Lock()

    def record_failure(self, tenant) -> bool:
        """Count one failure; True when it crossed the threshold."""
        if tenant is None:
            return False
        with self._lock:
            n = self.failures.get(tenant, 0) + 1
            self.failures[tenant] = n
            if n >= self.threshold and tenant not in self.quarantined:
                self.quarantined.add(tenant)
                return True
            return False

    def record_success(self, tenant) -> None:
        if tenant is None:
            return
        with self._lock:
            self.failures.pop(tenant, None)
            self.quarantined.discard(tenant)

    def is_quarantined(self, tenant) -> bool:
        if tenant is None:
            return False
        with self._lock:
            return tenant in self.quarantined

    def snapshot(self) -> dict:
        with self._lock:
            return {"threshold": self.threshold, "failures": dict(self.failures),
                    "quarantined": set(self.quarantined)}

    def restore(self, snap: dict) -> None:
        """Merge a donor's snapshot (a tenant quarantined on either side
        stays so; failure counts keep the larger)."""
        with self._lock:
            for tenant, n in (snap.get("failures") or {}).items():
                self.failures[tenant] = max(self.failures.get(tenant, 0), n)
            self.quarantined.update(snap.get("quarantined") or ())


def _bisectable(fault: DeviceException) -> bool:
    """Whether the port's fault ladder would retry ``fault`` on the card:
    an OOM, or a fault that names mesh members. A lost device (its CUDA
    context unusable), a kernel that does not build and a hang are
    sticky: a split would only fail again."""
    return isinstance(fault, DeviceOOMException) or bool(getattr(fault, "device_ids", ()))


class VerificationService:
    """The long-lived serving entry point (module doc)."""

    def __init__(self, config: Optional[ServeConfig] = None, start: bool = True, trace=None,
                 device=None, tenant_health=None, monitor=None, **knobs):
        from deequ_tpu_torch.obs.recorder import (
            current_recorder,
            maybe_arm_from_env,
            resolve_recorder,
        )
        from deequ_tpu_torch.ops.scan_plan import encoded_ingest_enabled
        from deequ_tpu_torch.serve.plan_cache import PlanCache, _BoundedLRU

        self.config = config if config is not None else ServeConfig(**knobs)
        # the recorder, the device and the mesh are the constructing
        # thread's: the trace argument, else its recorder scope, else the
        # DEEQU_TORCH_TRACE one; its use_device / use_mesh scopes ride the
        # context copy the worker runs in
        maybe_arm_from_env()
        self._recorder = resolve_recorder(trace) if trace is not None else current_recorder()
        self._context = contextvars.copy_context()
        self._device = device
        self.plan_cache = PlanCache(self.config.plan_cache_size)
        # injectable, so that a fleet's workers share one quarantine ledger
        self.tenant_health = (tenant_health if tenant_health is not None
                              else _TenantHealth(self.config.quarantine_after))
        #: a QualityMonitor fed every resolved suite's metrics at the
        #: resolve seam (``repository/monitor.py``)
        self.monitor = monitor
        #: bumped every worker loop; a stalled worker stops bumping it
        self.heartbeat = time.monotonic()
        self._stall_seconds = 0.0
        #: analyzer set -> (needed columns, scan-only?), learned from the
        #: first healthy build, bounded like the plan cache beside it
        self._families = _BoundedLRU(4 * self.config.plan_cache_size)
        self._encode = encoded_ingest_enabled(None)
        self._cv = threading.Condition()
        self._queue = TenantFairQueue()
        self._brownout = BrownoutController(
            capacity=self.config.max_pending,
            latency_high=self.config.brownout_latency_high,
            enabled=bool(self.config.brownout),
        )
        self._admission = AdmissionController(
            max_pending=self.config.max_pending, brownout=self._brownout,
            class_share=self.config.class_share, inflight_cap=self.config.inflight_cap,
        )
        self._running = False
        self._closed = False
        self._idle = True
        self._thread: Optional[threading.Thread] = None
        self.batches_served = 0
        self.suites_served = 0
        # serve plans this service built (a first sight or a plan-cache
        # miss): a joiner warmed from the fleet builds none for the plans
        # it was handed
        self.plans_built = 0
        # the queued predicted cost, changed only under self._cv with the
        # queue: the feed of the cost-priced retry_after_s and the
        # brownout ladder's cost pressure
        self._queued_cost = 0.0
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._closed:
                raise ServiceClosedException("service is stopped")
            if self._running:
                return
            self._running = True
        context = self._context.copy()
        self._thread = threading.Thread(target=lambda: context.run(self._worker), daemon=True,
                                        name="deequ-torch-serve")
        self._thread.start()

    def stop(self, drain: bool = True, join: bool = True) -> PendingWork:
        """Stop the worker. ``drain=True`` serves everything queued first;
        ``drain=False`` stops after the batch in flight and returns the
        pending requests, their futures unresolved, for :meth:`resume` on
        another service."""
        if drain:
            self.flush()
        with self._cv:
            self._closed = True
            self._running = False
            pending = self._queue.drain()
            self._queued_cost = 0.0
            self._cv.notify_all()
        if join and self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=30.0)
        return PendingWork(pending, tenant_health=self.tenant_health.snapshot())

    def resume(self, pending: Sequence[ServeRequest]) -> None:
        """Adopt a stopped service's pending requests: they resolve their
        original futures here, and a PendingWork's quarantine ledger is
        merged in."""
        snap = getattr(pending, "tenant_health", None)
        if snap:
            self.tenant_health.restore(snap)
        with self._cv:
            if self._closed:
                raise ServiceClosedException("service is stopped")
            for req in pending:
                # an adopted future observes into this service
                req.future._on_done = self._observe_done
                self._queue.push(req)
                self._queued_cost += float(getattr(req, "predicted_cost", 0.0) or 0.0)
            self._cv.notify_all()

    def inject_stall(self, seconds: float) -> None:
        """The worker sleeps ``seconds`` before its next batch: a scripted
        stall (its heartbeat stops for the time). ``stop`` ends the sleep:
        a stopped worker has nothing left to take."""
        with self._cv:
            self._stall_seconds = float(seconds)
            self._cv.notify_all()

    def _sleep_stall(self, seconds: float) -> None:
        end = time.monotonic() + seconds
        with self._cv:
            while self._running:
                left = end - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(left)

    # -- fleet warm-up -------------------------------------------------------

    def warm_state(self, limit: Optional[int] = None):
        """What a joining worker imports (``serve/fleet.py``): the cached
        plans, most recently used last (the last ``limit`` of them), and the
        analyzer-family cache. Plans travel by reference, their programs
        with them: a program is built once a plan and device
        (``ServePlan.programs``), so a joiner on the same device builds
        nothing."""
        plans = self.plan_cache.entries()
        if limit is not None:
            plans = plans[-limit:] if limit > 0 else []
        return plans, self._families.items()

    def warm_from(self, plans, families) -> None:
        """Adopt a donor's warm state before admitting traffic, so the
        joiner's first requests hit the plan cache."""
        for key, family in dict(families).items():
            self._families.put(key, family)
        for plan in plans:
            if plan.key is not None:
                self.plan_cache.put(plan)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until the queue is empty and the worker idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while len(self._queue) or not self._idle:
                if not self._running and len(self._queue):
                    raise ServiceClosedException("service stopped with requests pending")
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        raise TimeoutError("flush timed out")
                self._cv.wait(wait if wait is not None else 0.1)

    def __enter__(self) -> "VerificationService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # -- submission ----------------------------------------------------------

    def submit(self, data, checks: Sequence = (), required_analyzers: Sequence = (),
               tenant=None, run_policy=None, slo=None) -> VerificationFuture:
        """Queue one verification suite; returns its future. ``run_policy``
        (or the service's) is its fault budget; ``slo``
        (``admission.Slo``) its class, fair-share weight and absolute
        deadline. Backpressure is typed: a full queue raises
        ``ServiceOverloadedException``, a class over its queue budget or
        shed by the brownout ladder ``AdmissionRejectedException``, each
        with ``queue_depth``, ``retry_after_s`` and ``slo_class``."""
        from deequ_tpu_torch.obs.registry import SERVE_QUEUE_DEPTH, SERVE_SUBMITTED
        from deequ_tpu_torch.ops.plan_cost import PLAN_COST_MODEL

        slo = resolve_slo(slo if slo is not None else self.config.default_slo)
        # the suite's predicted cost, priced outside the queue's lock
        try:
            suite = list(required_analyzers)
            for check in checks:
                suite.extend(check.required_analyzers())
            predicted_cost = PLAN_COST_MODEL.estimate_suite(
                suite, int(getattr(data, "num_rows", 0) or 0)).total
        except Exception:  # noqa: BLE001 — pricing never refuses work: an
            # unpriced suite admits under the depth signals alone
            predicted_cost = 0.0
        future = VerificationFuture(tenant)
        future._on_done = self._observe_done
        req = ServeRequest(
            data=data, checks=tuple(checks), required_analyzers=tuple(required_analyzers),
            tenant=tenant,
            run_policy=run_policy if run_policy is not None else self.config.run_policy,
            future=future, slo=slo,
            deadline_at=(future.submitted_at + slo.deadline_seconds
                         if slo.deadline_seconds is not None else None),
            predicted_cost=predicted_cost,
        )
        with self._cv:
            # a service not yet started queues; only a stopped one refuses
            if self._closed:
                raise ServiceClosedException("submit on a stopped VerificationService")
            depth = len(self._queue)
            SERVE_QUEUE_DEPTH.set(depth)
            self._admission.admit(
                tenant=tenant, slo=slo, queue_depth=depth,
                class_depth=self._queue.class_depth(slo.cls),
                tenant_pending=self._queue.tenant_depth(tenant),
                queued_cost=self._queued_cost + predicted_cost,
            )
            self._queue.push(req)
            self._queued_cost += predicted_cost
            # counted after the push and before the worker is woken: an
            # accepted request only, and never resolved before it counts
            SERVE_SUBMITTED.inc()
            if self._recorder is not None:
                self._recorder.event("serve_submit", tenant=str(tenant), slo_class=slo.cls)
            self._cv.notify_all()
        return future

    def verify(self, data, checks: Sequence = (), **kw):
        """Submit and wait."""
        return self.submit(data, checks, **kw).result()

    def _observe_done(self, future: VerificationFuture, ok: bool) -> None:
        """Called once a resolved or rejected future: the registry's
        counters and latency histogram, the monitor, the brownout ladder's
        latency feed and, when tracing, the submit->resolve span on the
        tenant's track."""
        from deequ_tpu_torch.obs.registry import SERVE_LATENCY, SERVE_REJECTED, SERVE_RESOLVED

        (SERVE_RESOLVED if ok else SERVE_REJECTED).inc()
        if ok and self.monitor is not None and future._result is not None:
            try:
                self.monitor.observe_verification(future.tenant, future._result)
            except Exception:  # noqa: BLE001 — monitoring observes, it never
                # changes an outcome: the error is counted on MONITOR_STATS
                from deequ_tpu_torch.repository.monitor import MONITOR_STATS

                MONITOR_STATS.monitor_errors += 1
        latency = future.latency_seconds
        if latency is None:
            return
        tenant = "?" if future.tenant is None else str(future.tenant)
        SERVE_LATENCY.observe(tenant, latency)
        self._brownout.observe_latency(latency)
        if self._recorder is not None:
            self._recorder.record_span("serve_request", future.submitted_at, future.resolved_at,
                                       track=f"tenant/{tenant}", tenant=tenant, ok=ok)

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        from deequ_tpu_torch.device import use_device
        from deequ_tpu_torch.obs.recorder import recording_scope

        with (use_device(self._device) if self._device is not None
              else contextlib.nullcontext()), \
                (recording_scope(self._recorder) if self._recorder is not None
                 else contextlib.nullcontext()):
            while True:
                with self._cv:
                    stall, self._stall_seconds = self._stall_seconds, 0.0
                if stall > 0:
                    self._sleep_stall(stall)
                self.heartbeat = time.monotonic()
                batch = self._take_batch()
                if batch is None:
                    return
                if not batch:
                    continue  # a stall arrived while idle: take it first
                try:
                    self._serve_batch(batch)
                except Exception as e:  # noqa: BLE001 — the worker outlives any
                    # batch: what this one left unresolved is rejected typed
                    wrapped = wrap_if_necessary(e)
                    for req in batch:
                        if not req.future.done():
                            req.future._reject(wrapped)
                finally:
                    with self._cv:
                        self._idle = True
                        self._cv.notify_all()

    def _take_batch(self) -> Optional[List[ServeRequest]]:
        """Pop up to ``max_batch`` requests (class priority, then the
        tenants' weighted shares), waiting ``coalesce_window`` after the
        first arrival. Requests whose deadline expired in the queue are
        collected under the lock and shed after it is released."""
        from deequ_tpu_torch.obs.registry import SERVE_QUEUE_DEPTH

        cfg = self.config
        with self._cv:
            while not len(self._queue):
                if not self._running:
                    return None
                if self._stall_seconds:
                    return []
                self._idle = True
                self.heartbeat = time.monotonic()
                # idle ticks walk the ladder down: the last update saw the
                # whole backlog a wide batch then drained
                self._brownout.update(0)
                self._cv.notify_all()
                self._cv.wait(0.1)
            self._idle = False
        if cfg.coalesce_window > 0 and cfg.max_batch > 1:
            deadline = time.monotonic() + cfg.coalesce_window
            with self._cv:
                while len(self._queue) < cfg.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._running:
                        break
                    self._cv.wait(left)
        out: List[ServeRequest] = []
        shed: List[ServeRequest] = []
        with self._cv:
            SERVE_QUEUE_DEPTH.set(len(self._queue))
            self._brownout.update(
                len(self._queue), cost_frac=self._admission.cost_fraction(self._queued_cost))
            now = time.monotonic()
            while len(self._queue) and len(out) < cfg.max_batch:
                req = self._queue.pop(now, shed.append)
                if req is None:
                    break
                out.append(req)
            for req in out + shed:
                self._queued_cost -= float(getattr(req, "predicted_cost", 0.0) or 0.0)
            # an empty queue pins the ledger to zero: no float drift
            if not len(self._queue) or self._queued_cost < 0.0:
                self._queued_cost = 0.0
            self._brownout.update(
                len(self._queue), cost_frac=self._admission.cost_fraction(self._queued_cost))
        for req in shed:
            self._shed_expired(req)
        return out

    def _shed_expired(self, req: ServeRequest) -> None:
        """Resolve one expired request typed, once, on its own future;
        charge its tenant's budget ``deadline_shed`` (an exhaustion there
        is swallowed: the shed is already the outcome). Not a tenant
        failure: its data never ran."""
        from deequ_tpu_torch.obs.registry import SERVE_SHED_BY_CLASS
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.resilience.governance import try_charge

        waited = time.monotonic() - req.future.submitted_at
        SCAN_STATS.record_degradation(
            "deadline_shed", tenant=req.tenant, slo_class=req.slo.cls,
            deadline_ms=req.slo.deadline_ms, waited_s=round(waited, 4))
        SERVE_SHED_BY_CLASS[req.slo.cls].inc()
        try_charge(req.run_policy.arm() if req.run_policy is not None else None,
                   "deadline_shed", tenant=req.tenant)
        req.future._reject(DeadlineExceededException(
            f"request for tenant {req.tenant!r} expired in the queue: waited "
            f"{waited * 1000:.1f} ms past its {req.slo.cls!r} SLO deadline of "
            f"{req.slo.deadline_ms:g} ms — shed before dispatch",
            tenant=req.tenant, slo_class=req.slo.cls, deadline_ms=req.slo.deadline_ms,
            waited_s=waited, retry_after_s=self._admission.retry_after(self.pending_count()),
        ))

    # -- execution -----------------------------------------------------------

    def _serve_batch(self, batch: List[ServeRequest]) -> None:
        from deequ_tpu_torch.parallel.mesh import resolve_placement

        alive = [req for req in batch if req.future._claim()]
        if not alive:
            return
        batch_t0 = time.monotonic()
        # the worker's placement, in its context: a mesh serves serially
        # (the sharded numerics a caller would get inline); no card and no
        # CPU scope raises typed here, for every request of the batch
        device, mesh = resolve_placement()
        groups: Dict[Any, List[ServeRequest]] = {}
        serial: List[ServeRequest] = []
        for req in alive:
            try:
                self._admit(req, coalesce=mesh is None)
            except Exception as e:  # noqa: BLE001 — this request's outcome
                req.future._reject(wrap_if_necessary(e))
                continue
            if req.coalescable and not self.tenant_health.is_quarantined(req.tenant):
                groups.setdefault(req.key, []).append(req)
            else:
                serial.append(req)
        for members in groups.values():
            try:
                self._serve_coalesced(members, device)
            except Exception as e:  # noqa: BLE001 — one group's failure must
                # not strand its siblings' futures
                wrapped = wrap_if_necessary(e)
                for req in members:
                    if not req.future.done():
                        req.future._reject(wrapped)
        for req in serial:
            try:
                self._serve_serial(req)
            except Exception as e:  # noqa: BLE001 — failures before the engine
                # (a run_policy without arm()) reject this request typed
                if not req.future.done():
                    req.future._reject(wrap_if_necessary(e))
        self.batches_served += 1
        self.suites_served += len(alive)
        self._admission.note_served(
            len(alive), time.monotonic() - batch_t0,
            cost=sum(float(getattr(r, "predicted_cost", 0.0) or 0.0) for r in alive))

    def _admit(self, req: ServeRequest, coalesce: bool = True) -> None:
        """Fingerprint the request and decide whether it may coalesce
        (``plan_cache.PlanKey``). The needed columns are a property of the
        analyzer set alone: the first healthy build of a set records them
        (``_families``), and every later request fingerprints without
        building an op."""
        from deequ_tpu_torch.ops.scan_engine import _ChunkPacker
        from deequ_tpu_torch.serve.plan_cache import (
            PlanKey,
            build_serve_plan,
            layout_signature,
            schema_signature,
        )
        from deequ_tpu_torch.verification import _required

        req.analyzers = tuple(_required(req.checks, req.required_analyzers))
        req.coalescable = False
        data = req.data
        if not coalesce or getattr(data, "is_streaming", False) \
                or getattr(data, "is_persisted", False):
            # a stream reads through its own pipeline, and a persisted
            # table's serial scan walks its resident chunks
            return
        try:
            n_rows = int(data.num_rows or 0)
        except (AttributeError, TypeError):
            return
        if n_rows <= 0 or not req.analyzers:
            return
        family = self._families.get(req.analyzers)
        if family is None:
            # the first sight of this analyzer set: its plan, built from
            # this table. Only what the analyzer set decides is cached: a
            # grouping suite's serial verdict, or the needed columns of a
            # healthy build. A table's own degeneracy (a missing column, a
            # table past one chunk) serves serially and caches nothing
            plan = build_serve_plan(data, req.analyzers)
            self.plans_built += 1
            if plan.serial_class:
                self._families.put(req.analyzers, ((), False))
                return
            if not plan.coalescable or plan.op_failures or plan.precondition_failures:
                return
            self._families.put(req.analyzers, (plan.needed, True))
            plan.key = PlanKey(schema_signature(data, plan.needed), req.analyzers,
                               plan.layout, n_rows)
            self.plan_cache.put(plan)
            req.key = plan.key
            req.coalescable = True
            return
        needed, scan_only = family
        if not scan_only or any(n not in data for n in needed):
            return  # the serial route reports missing columns as failures
        try:
            packer = _ChunkPacker({n: data[n] for n in needed}, encode=self._encode)
        except Exception:  # noqa: BLE001 — a column that will not pack serves
            # serially, where the engine reports it typed
            return
        req.key = PlanKey(schema_signature(data, needed), req.analyzers,
                          layout_signature(packer.layout()), n_rows)
        req.packer = packer
        req.coalescable = True

    def _plan_for(self, req: ServeRequest):
        from deequ_tpu_torch.serve.plan_cache import build_serve_plan

        plan = self.plan_cache.get(req.key)
        if plan is None:
            plan = build_serve_plan(req.data, req.analyzers, key_hint=req.key)
            self.plans_built += 1
            self.plan_cache.put(plan)
        return plan

    def _serve_coalesced(self, members: List[ServeRequest], device) -> None:
        """One plan key's group: the plan, the coalesced dispatch with
        bisection, each member's result."""
        plan = self._plan_for(members[0])
        if not plan.coalescable:
            for req in members:
                self._serve_serial(req)
            return
        budgets = {id(req): (req.run_policy.arm() if req.run_policy is not None else None)
                   for req in members}
        self._dispatch_slice(plan, members, budgets, device)

    def _dispatch_slice(self, plan, members: List[ServeRequest], budgets: Dict[int, Any],
                        device, depth: int = 0) -> None:
        """Run one slice of a batch coalesced. A fault the ladder would
        retry charges every member's budget and bisects the slice; a lone
        member that still faults takes the serial rung. A sticky fault
        rejects every member typed, unsplit."""
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.serve.executor import run_coalesced

        try:
            results = run_coalesced(
                plan, [req.data for req in members], [str(req.tenant) for req in members],
                device, attempt=depth, packers=[req.packer for req in members],
                encode=self._encode,
            )
        except DeviceException as e:
            if not _bisectable(e):
                SCAN_STATS.record_degradation(
                    "coalesce_sticky_fault", members=len(members), depth=depth,
                    fault=type(e).__name__, error=str(e))
                for req in members:
                    self._record_tenant_failure(req)
                    req.future._reject(e)
                return
            survivors: List[ServeRequest] = []
            for req in members:
                budget = budgets.get(id(req))
                if budget is None:
                    survivors.append(req)
                    continue
                try:
                    budget.charge("coalesce_retry", tenant=req.tenant)
                    survivors.append(req)
                except RunBudgetExhaustedException as exhausted:
                    # this member's budget is spent: its result degrades,
                    # and the rest retry without it
                    self._finalize_budget_exhausted(req, exhausted, budget)
            if not survivors:
                return
            if len(survivors) == 1:
                self._serve_serial(survivors[0], budget=budgets.get(id(survivors[0])),
                                   after_fault=e)
                return
            SCAN_STATS.record_degradation(
                "coalesce_bisect", members=len(survivors), depth=depth, error=str(e))
            mid = len(survivors) // 2
            self._dispatch_slice(plan, survivors[:mid], budgets, device, depth + 1)
            self._dispatch_slice(plan, survivors[mid:], budgets, device, depth + 1)
            return
        except Exception as e:  # noqa: BLE001 — a shared scan's failure is
            # failure metrics for every member (the runner's rule)
            wrapped = wrap_if_necessary(e)
            for req in members:
                self._finalize_scan_failure(req, wrapped)
            return
        for req, scan_results in zip(members, results):
            self._finalize_member(req, plan, scan_results, budgets.get(id(req)), device)

    # -- finalization --------------------------------------------------------

    def _finalize_member(self, req, plan, scan_results, budget, device) -> None:
        """Scan results -> states -> metrics -> checks -> the resolved
        future: the host tail each member runs on its own."""
        from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
        from deequ_tpu_torch.verification import VerificationSuite

        try:
            ctx = AnalyzerContext.empty()
            for a, exc in plan.precondition_failures.items():
                ctx.metric_map[a] = a.to_failure_metric(exc)
            for a, exc in plan.op_failures.items():
                ctx.metric_map[a] = a.to_failure_metric(exc)
            ctx = AnalysisRunner._finalize_scanning_analyzers(
                ctx, plan.scannable, plan.extract_plan, scan_results)
            result = VerificationSuite._evaluate(req.checks, ctx)
            result.device = str(device)
            result.scan_stats = {"coalesced": True, "device_fetches": 1}
            if budget is not None:
                result.run_budget = budget.snapshot()
            self.tenant_health.record_success(req.tenant)
            req.future._resolve(result)
        except Exception as e:  # noqa: BLE001 — this member's outcome
            self._record_tenant_failure(req)
            req.future._reject(wrap_if_necessary(e))

    def _finalize_scan_failure(self, req, wrapped, count_failure: bool = True) -> None:
        """A shared scan's failure as failure metrics for every analyzer of
        this member."""
        from deequ_tpu_torch.analyzers.runner import AnalyzerContext
        from deequ_tpu_torch.verification import VerificationSuite

        if count_failure:
            self._record_tenant_failure(req)
        ctx = AnalyzerContext({a: a.to_failure_metric(wrapped) for a in req.analyzers})
        result = VerificationSuite._evaluate(req.checks, ctx)
        result.scan_stats = {"coalesced": False, "failed": str(wrapped)}
        req.future._resolve(result)

    def _finalize_budget_exhausted(self, req, exhausted, budget) -> None:
        """An exhausted budget degrades only this member: typed failure
        metrics and the ledger under ``degrade``, a typed rejection under
        ``raise``."""
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        SCAN_STATS.record_degradation("tenant_budget_exhausted", tenant=req.tenant,
                                      reason=exhausted.reason)
        self._record_tenant_failure(req)
        if not exhausted.degraded:
            req.future._reject(exhausted)
            return
        self._finalize_scan_failure(req, exhausted, count_failure=False)
        if req.future._result is not None and budget is not None:
            req.future._result.run_budget = budget.snapshot()

    def _record_tenant_failure(self, req) -> None:
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        if self.tenant_health.record_failure(req.tenant):
            SCAN_STATS.record_degradation(
                "tenant_quarantine", tenant=req.tenant,
                consecutive=self.tenant_health.failures.get(req.tenant))

    # -- the serial route ----------------------------------------------------

    def _serve_serial(self, req: ServeRequest, budget=None, after_fault=None) -> None:
        """``VerificationSuite`` for one request, its full fault ladder under
        the request's budget: the route of suites that do not coalesce and
        the rung of a lone member that faulted coalesced."""
        from deequ_tpu_torch.resilience.governance import run_budget_scope
        from deequ_tpu_torch.verification import VerificationSuite

        if budget is None and req.run_policy is not None:
            budget = req.run_policy.arm()
        try:
            with (run_budget_scope(budget) if budget is not None
                  else contextlib.nullcontext()):
                result = VerificationSuite.do_verification_run(
                    req.data, list(req.checks), list(req.required_analyzers),
                    on_device_error=self.config.on_device_error)
            result.scan_stats = dict(result.scan_stats or {})
            result.scan_stats["coalesced"] = False
            if after_fault is not None:
                result.scan_stats["isolated_after"] = str(after_fault)
            if budget is not None:
                result.run_budget = budget.snapshot()
            # completing only by degrading an exhausted budget, or a rung
            # whose scan failed on the device again, is a failure for
            # quarantine: it must not heal what it deepens
            faulted_again = after_fault is not None and any(
                not m.value.is_success and isinstance(m.value.exception, DeviceException)
                for m in result.metrics.values())
            if faulted_again or (budget is not None and budget.exhausted_reason is not None):
                self._record_tenant_failure(req)
            else:
                self.tenant_health.record_success(req.tenant)
            req.future._resolve(result)
        except RunBudgetExhaustedException as e:
            self._finalize_budget_exhausted(req, e, budget)
        except Exception as e:  # noqa: BLE001 — this request's outcome
            self._record_tenant_failure(req)
            req.future._reject(wrap_if_necessary(e))

    # -- introspection -------------------------------------------------------

    def pending_count(self) -> int:
        with self._cv:
            return len(self._queue)

    def stats(self) -> dict:
        with self._cv:
            pending = len(self._queue)
            by_class = {cls: self._queue.class_depth(cls) for cls in SLO_CLASSES}
        return {
            "batches_served": self.batches_served,
            "suites_served": self.suites_served,
            "pending": pending,
            "pending_by_class": by_class,
            "brownout_level": self._brownout.level,
            "plan_cache_entries": len(self.plan_cache),
            "quarantined_tenants": sorted(map(str, self.tenant_health.quarantined)),
        }
