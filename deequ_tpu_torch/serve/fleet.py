"""VerificationFleet — N serving workers with failover and one quarantine
(the counterpart of ``deequ_tpu/serve/fleet.py``).

A :class:`~deequ_tpu_torch.serve.service.VerificationService` is one
worker: it dies with its thread, its plan cache with it, and its
quarantine is its own. The fleet puts several behind one submission
surface:

- **Placement** — tenants route by a consistent hash of the admission-free
  plan fingerprint (``serve/router.py``): a tenant keeps the worker that
  holds its plan across a join or a leave, so a failover does not make
  the whole fleet build plans again.
- **Membership** — heartbeat-driven (``serve/membership.py``, the peer
  check's core applied in-process): a worker whose thread died or stalled
  past ``stall_timeout`` is declared lost (a typed
  :class:`~deequ_tpu_torch.exceptions.WorkerLostException`) by a monitor
  thread.
- **Failover** — the lost worker's accepted and unresolved requests,
  queued or in flight (the fleet's assignments are authoritative),
  re-dispatch onto survivors on their original futures. Plans are
  deterministic, so a re-dispatched result is bit for bit what the dead
  worker would have given; if the worker was only stalled and wakes to
  resolve late, the futures' first-resolution gate drops the duplicate.
- **No free retries** — a tenant's run budget is armed once, at fleet
  submit, and follows the request: each failover charges it
  ``worker_failover``, and an exhausted budget degrades or rejects as on
  one service.
- **One quarantine** — every worker shares one ``_TenantHealth``: a
  poison tenant quarantined by any worker is serial-only on all, and one
  success anywhere readmits it.
- **Warm join** — a joining worker imports the survivors' hot plans before
  it owns a ring arc.
- **Durability** — with ``ledger_dir`` every acceptance is fsynced to a
  ``RequestLedger`` (``serve/ledger.py``) before its future is returned,
  and every resolution tombstoned; a fleet opened on the same directory
  replays what was not resolved, onto the original futures when the
  caller passes them (``resume_futures``).

Placement on devices: the fleet's devices are the cards this process sees,
or the CPU when the caller asks for it (``use_device("cpu")``); without a
card and without that request the fleet raises
``DeviceUnavailableException``. Every worker of a fleet on one card runs
there. Its threads launch on the device's current stream, the legacy
default stream, so their kernels serialise on the card and a worker's
fetch also waits for the work the others queued before it: correct, and
simple to reason about.

Chaos seams: :meth:`kill_worker` (a scripted death), :meth:`stall_worker`
(the service's ``inject_stall``) and :meth:`rejoin_worker`.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from deequ_tpu_torch.exceptions import (
    CorruptStateException,
    DeadlineExceededException,
    RunBudgetExhaustedException,
    ServiceClosedException,
    ServiceOverloadedException,
    WorkerLostException,
)
from deequ_tpu_torch.serve.admission import Slo, resolve_slo
from deequ_tpu_torch.serve.membership import FleetMembership
from deequ_tpu_torch.serve.router import ConsistentHashRouter, route_digest
from deequ_tpu_torch.serve.service import (
    ServeConfig,
    ServeRequest,
    VerificationFuture,
    VerificationService,
    _TenantHealth,
)


class _PreArmedPolicy:
    """A run-policy stand-in whose ``arm()`` returns the same armed budget
    every time: how a tenant's budget follows its request through a
    failover (the adopting worker's ``arm()`` must not mint a fresh one)."""

    def __init__(self, budget):
        self.budget = budget

    def arm(self):
        return self.budget


@dataclass
class FleetConfig:
    """The fleet's knobs. ``n_workers``, ``heartbeat_interval``,
    ``failover_retries`` and ``ledger_dir`` default to
    ``DEEQU_TORCH_FLEET_WORKERS``, ``DEEQU_TORCH_HEARTBEAT_INTERVAL``,
    ``DEEQU_TORCH_FAILOVER_RETRIES`` and ``DEEQU_TORCH_FLEET_LEDGER_DIR``
    (``envcfg.py``; a malformed value raises ``EnvConfigError``).
    ``worker_knobs`` feed each worker's :class:`ServeConfig`;
    ``stall_timeout`` defaults to ``max(8 * heartbeat_interval, 2 s)``, so
    a busy batch is not taken for a stall; ``warm_plans`` bounds the plans
    a donor hands a joining worker."""

    n_workers: Optional[int] = None
    heartbeat_interval: Optional[float] = None
    stall_timeout: Optional[float] = None
    failover_retries: Optional[int] = None
    warm_plans: int = 8
    #: the membership's monitor thread on or off
    monitor: bool = True
    #: one ``repository.monitor.QualityMonitor`` fed by every worker's
    #: resolve seam, so a tenant's series is one whichever worker served
    #: it (a late resolution of a woken worker never reaches it: it hangs
    #: off the future's first-resolution gate)
    quality_monitor: Any = None
    quarantine_after: int = 2
    run_policy: Any = None
    worker_knobs: Optional[Dict[str, Any]] = None
    #: the durable request ledger (module doc); one fleet a directory
    ledger_dir: Optional[str] = None
    ledger_mode: str = "recover"
    #: True places worker i on device i mod the fleet's devices; False
    #: places every worker on the first. A program is built once a plan
    #: and device (``ServePlan.programs`` by ``str(device)``): on one card
    #: both are the same, and a warm transfer leaves a joiner nothing to
    #: build; over several cards a failover target builds each migrated
    #: plan's program once for its own device
    distinct_devices: bool = True

    def __post_init__(self):
        from deequ_tpu_torch.envcfg import env_value

        if self.heartbeat_interval is None:
            self.heartbeat_interval = env_value("DEEQU_TORCH_HEARTBEAT_INTERVAL")
        self.heartbeat_interval = float(self.heartbeat_interval)
        if self.heartbeat_interval <= 0:
            raise ValueError("heartbeat_interval must be > 0 seconds")
        if self.failover_retries is None:
            self.failover_retries = env_value("DEEQU_TORCH_FAILOVER_RETRIES")
        self.failover_retries = int(self.failover_retries)
        if self.failover_retries < 0:
            raise ValueError("failover_retries must be >= 0")
        if self.n_workers is None:
            self.n_workers = env_value("DEEQU_TORCH_FLEET_WORKERS")
        if self.n_workers is not None and int(self.n_workers) < 1:
            raise ValueError("n_workers must be >= 1")
        if self.stall_timeout is None:
            self.stall_timeout = max(8 * self.heartbeat_interval, 2.0)
        self.stall_timeout = float(self.stall_timeout)
        if self.warm_plans < 0:
            raise ValueError("warm_plans must be >= 0")
        self.worker_knobs = dict(self.worker_knobs or {})
        if self.ledger_dir is None:
            self.ledger_dir = env_value("DEEQU_TORCH_FLEET_LEDGER_DIR")


class FleetWorker:
    """One fleet member: a service on a device, and whether it is alive. A
    dead worker stays in the table (its id can rejoin) and owns no arc of
    the ring."""

    def __init__(self, idx: int, service: VerificationService, device):
        self.idx = idx
        self.service = service
        self.device = device
        self.alive = True

    def queue_depth(self) -> int:
        try:
            return self.service.pending_count()
        except ServiceClosedException:
            return 0


@dataclass
class _Assignment:
    """The fleet's record of one accepted request: what a failover
    re-dispatches when its worker dies (the dead worker's own queue is not
    consulted)."""

    data: Any
    checks: tuple
    required_analyzers: tuple
    tenant: Any
    budget: Any  # the armed RunBudget (None: ungoverned)
    digest: str
    worker: int
    failovers: int = 0
    #: the SLO and its absolute deadline, stamped once at fleet submit: a
    #: failover carries both, and a victim whose deadline passed is shed
    #: typed on its original future instead of replayed stale
    slo: Any = None
    deadline_at: Optional[float] = None
    #: the acceptance's ledger id (None without a ledger)
    accept_id: Optional[str] = None


#: the most recent fleet, read by the registry's ``fleet`` section
_ACTIVE_FLEET: Optional[weakref.ReferenceType] = None


def _fleet_section() -> dict:
    """The registry's ``fleet`` section: workers alive, each worker's queue
    depth, the failovers, and the hot-plan feed a joining worker draws
    from."""
    from deequ_tpu_torch.obs.registry import FLEET_FAILOVERS

    fleet = _ACTIVE_FLEET() if _ACTIVE_FLEET is not None else None
    if fleet is None:
        return {"workers_alive": 0, "failovers": FLEET_FAILOVERS.value}
    return fleet._section()


def _fleet_devices() -> List[torch.device]:
    """The devices a fleet built in this context places workers on: the
    CPU, or one named card, when the caller asked for it; else every card
    this process sees. No card and no request raises
    ``DeviceUnavailableException`` (``device.resolve_device``)."""
    from deequ_tpu_torch.device import explicit_device, resolve_device

    asked = explicit_device()
    if asked is not None and (torch.device(asked).type == "cpu"
                              or torch.device(asked).index is not None):
        return [resolve_device(asked)]
    resolve_device(asked)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class VerificationFleet:
    """The multi-worker serving entry point (module doc)."""

    def __init__(self, config: Optional[FleetConfig] = None, start: bool = True, trace=None,
                 resume_futures: Optional[Dict[str, Any]] = None, **knobs):
        global _ACTIVE_FLEET
        self.config = config if config is not None else FleetConfig(**knobs)
        self._trace = trace
        self._devices = _fleet_devices()
        n = self.config.n_workers
        if n is None:
            n = min(4, max(1, len(self._devices)))
        self.n_workers = int(n)
        # ONE quarantine ledger for the whole fleet
        self._tenant_health = _TenantHealth(self.config.quarantine_after)
        self._router = ConsistentHashRouter()
        self._workers: Dict[int, FleetWorker] = {}
        self._zombies: List[VerificationService] = []
        self._assignments: Dict[Any, _Assignment] = {}
        self._heat: Dict[str, int] = {}
        self._lock = threading.Lock()
        # serialises loss handling and submission against it: the monitor,
        # kill_worker and rejoin_worker must not interleave membership
        # changes, and a submit records its assignment before a loss
        # snapshots the victims, or a loss between enqueue and record would
        # orphan the future. Reentrant: a submit that finds a dead service
        # retires it inline
        self._failover_lock = threading.RLock()
        self._closed = False
        self.workers_lost = 0
        self.requests_redispatched = 0
        self._ledger = None
        #: accept_id -> future of the ledger records replayed at start
        self.resumed: Dict[str, Any] = {}
        if self.config.ledger_dir:
            from deequ_tpu_torch.serve.ledger import RequestLedger

            self._ledger = RequestLedger(self.config.ledger_dir, mode=self.config.ledger_mode)
        self.membership = FleetMembership(
            members=self._alive_ids, probe_of=self._probe_worker, on_loss=self._handle_loss,
            interval=self.config.heartbeat_interval, stall_timeout=self.config.stall_timeout)
        for idx in range(self.n_workers):
            self._workers[idx] = FleetWorker(idx, self._spawn_service(idx), self._device_for(idx))
            self._router.add_worker(idx)
        _ACTIVE_FLEET = weakref.ref(self)
        from deequ_tpu_torch.obs.registry import REGISTRY

        REGISTRY.register_collector("fleet", _fleet_section)
        self._update_alive_gauge()
        self._replay_ledger(resume_futures or {})
        if start and self.config.monitor:
            self.membership.start()

    # -- worker lifecycle --------------------------------------------------------

    def _device_for(self, idx: int) -> torch.device:
        if not self.config.distinct_devices:
            return self._devices[0]
        return self._devices[idx % len(self._devices)]

    def _spawn_service(self, idx: int) -> VerificationService:
        from deequ_tpu_torch.parallel.mesh import use_mesh

        knobs = dict(self.config.worker_knobs)
        # each worker is one device: built under no mesh, so it coalesces
        # on its own device (the fleet's parallelism is its workers)
        with use_mesh(None):
            return VerificationService(
                config=ServeConfig(**knobs) if knobs else ServeConfig(), start=True,
                trace=self._trace, device=self._device_for(idx),
                tenant_health=self._tenant_health, monitor=self.config.quality_monitor)

    def _alive_ids(self) -> List[int]:
        with self._lock:
            return sorted(i for i, w in self._workers.items() if w.alive)

    def _probe_worker(self, idx: int):
        with self._lock:
            worker = self._workers.get(idx)
        if worker is None:
            return False, 0.0
        thread = worker.service._thread
        return (thread is not None and thread.is_alive() and not worker.service._closed,
                worker.service.heartbeat)

    def rejoin_worker(self, idx: int) -> Optional[FleetWorker]:
        """Bring a lost worker id back: a fresh service, warmed from the
        survivors' hot plans before it owns an arc of the ring (a cold
        joiner would build plans exactly while the fleet is degraded)."""
        with self._failover_lock:
            with self._lock:
                if self._closed:
                    raise ServiceClosedException("fleet is stopped")
                existing = self._workers.get(idx)
                if existing is not None and existing.alive:
                    return existing
                donors = [w.service for w in self._workers.values() if w.alive]
            service = self._spawn_service(idx)
            self._warm(service, donors)
            worker = FleetWorker(idx, service, self._device_for(idx))
            with self._lock:
                self._workers[idx] = worker
                self._router.add_worker(idx)
            self._update_alive_gauge()
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

            SCAN_STATS.record_degradation("worker_rejoin", worker=idx,
                                          warmed_plans=len(service.plan_cache))
            return worker

    def prewarm(self) -> None:
        """Hand every alive worker's hot plans to every other: after it, any
        survivor already holds a dead worker's plans, and a failover builds
        none (on distinct devices each migrated program is still built once
        for its new device; see :class:`FleetConfig`)."""
        with self._lock:
            alive = [w for w in self._workers.values() if w.alive]
        for worker in alive:
            self._warm(worker.service, [d.service for d in alive if d is not worker])

    def _warm(self, service: VerificationService, donors) -> None:
        """Import each donor's ``warm_plans`` most recent plans and its
        analyzer-family cache."""
        for donor in donors:
            try:
                plans, families = donor.warm_state(self.config.warm_plans)
                service.warm_from(plans, families)
            except Exception:  # noqa: BLE001 — a warm-up is best effort: a
                # failed transfer leaves the joiner cold, never broken
                continue

    #: past this many routing digests the coldest half of the heat ledger is
    #: dropped (the hot-plan feed reads only the top ``warm_plans``)
    _HEAT_CAP = 1024

    def _record_heat(self, digest: str) -> None:
        """Caller holds ``self._lock``."""
        self._heat[digest] = self._heat.get(digest, 0) + 1
        if len(self._heat) > self._HEAT_CAP:
            keep = sorted(self._heat.items(), key=lambda kv: kv[1],
                          reverse=True)[: self._HEAT_CAP // 2]
            self._heat = dict(keep)

    # -- submission ------------------------------------------------------------

    @staticmethod
    def _analyzers_of(checks, required_analyzers) -> list:
        analyzers = list(required_analyzers)
        for check in checks:
            analyzers.extend(check.required_analyzers())
        return analyzers

    def route(self, data, checks: Sequence = (),
              required_analyzers: Sequence = ()) -> Optional[int]:
        """The worker id a submission would land on (to script a death)."""
        analyzers = self._analyzers_of(checks, required_analyzers)
        return self._router.place(route_digest(data, analyzers))

    def submit(self, data, checks: Sequence = (), required_analyzers: Sequence = (),
               tenant=None, run_policy=None, slo=None):
        """Queue one suite on its placed worker; returns the future. The
        tenant's budget (``run_policy`` or the fleet's) is armed here: the
        queue wait, the run and every failover draw on it. ``slo``'s
        absolute deadline is stamped here too, once, and follows the
        request.

        Overload spill: when the placed worker refuses admission typed
        (``ServiceOverloadedException`` and its subclasses), the submit
        walks the ring clockwise and offers the request to each other alive
        worker once; only when every one refuses does the placed worker's
        refusal, with its ``retry_after_s``, reach the caller."""
        digest = route_digest(data, self._analyzers_of(checks, required_analyzers))
        policy = run_policy if run_policy is not None else self.config.run_policy
        budget = policy.arm() if policy is not None else None
        slo = resolve_slo(slo)
        with self._failover_lock:
            with self._lock:
                if self._closed:
                    raise ServiceClosedException("submit on a stopped VerificationFleet")
                self._record_heat(digest)
            future = None
            refusal: Optional[ServiceOverloadedException] = None
            for wid in self._router.walk(digest):
                with self._lock:
                    worker = self._workers.get(wid)
                if worker is None or not worker.alive:
                    continue
                try:
                    future = worker.service.submit(
                        data, checks=checks, required_analyzers=required_analyzers,
                        tenant=tenant,
                        run_policy=_PreArmedPolicy(budget) if budget is not None else None,
                        slo=slo)
                    break
                except ServiceOverloadedException as e:
                    # keep the placed worker's refusal (its retry_after is
                    # where the tenant's plans live) and spill clockwise
                    if refusal is None:
                        refusal = e
                    continue
                except ServiceClosedException:
                    # the placed service died between placement and enqueue:
                    # retire it (its arcs leave with it) and walk on
                    self._handle_loss(wid, WorkerLostException(
                        f"worker {wid} service closed at submit", worker_ids=(wid,)))
            if future is None:
                if refusal is not None:
                    raise refusal
                raise ServiceClosedException(
                    "no alive workers in the fleet (all lost; rejoin_worker or restart)")
            asg = _Assignment(
                data=data, checks=tuple(checks), required_analyzers=tuple(required_analyzers),
                tenant=tenant, budget=budget, digest=digest, worker=worker.idx, slo=slo,
                deadline_at=(future.submitted_at + slo.deadline_seconds
                             if slo.deadline_seconds is not None else None),
            )
            with self._lock:
                self._assignments[future] = asg
            if self._ledger is not None:
                # durable at accept: the frame is fsynced before the caller
                # holds the future, so a crash at any later instant replays
                asg.accept_id = uuid.uuid4().hex
                future.accept_id = asg.accept_id
                self._ledger.append_accept(
                    asg.accept_id, tenant=tenant, digest=digest, slo_cls=slo.cls,
                    deadline_ms=slo.deadline_ms, weight=slo.weight,
                    deadline_left_s=(asg.deadline_at - time.monotonic()
                                     if asg.deadline_at is not None else None),
                    work=(data, tuple(checks), tuple(required_analyzers)),
                    quarantine=self._tenant_health.snapshot())
        self._chain_done(future)
        return future

    def verify(self, data, checks: Sequence = (), **kw):
        """Submit and wait."""
        return self.submit(data, checks, **kw).result()

    def _chain_done(self, future) -> None:
        """Wrap the future's observation seam so the assignment is dropped
        (and, with a ledger, tombstoned) the moment it resolves; the
        service's own observation runs first."""
        prev = future._on_done

        def _done(f, ok, _prev=prev):
            if _prev is not None:
                _prev(f, ok)
            self._drop_assignment(f)

        future._on_done = _done
        if future.done():
            # resolved between submit and chaining: the callback fired on
            # the unwrapped seam, so drop the assignment here
            self._drop_assignment(future)

    def _drop_assignment(self, future) -> None:
        with self._lock:
            popped = self._assignments.pop(future, None)
        if popped is not None and popped.accept_id is not None and self._ledger is not None:
            try:
                self._ledger.append_resolve(popped.accept_id)
            except (OSError, ValueError):
                # a tombstone lost to a closing ledger costs one replay at
                # resume, which the future's gate drops; never a result
                pass

    # -- failover --------------------------------------------------------------

    def kill_worker(self, idx: int, reason: str = "scripted death") -> int:
        """Simulate the death of worker ``idx`` and fail its accepted
        requests over; returns how many were re-dispatched."""
        return self._handle_loss(idx, WorkerLostException(
            f"worker {idx} died: {reason}", worker_ids=(idx,)))

    def stall_worker(self, idx: int, seconds: float) -> None:
        """Wedge worker ``idx``'s thread for ``seconds``: past
        ``stall_timeout`` the monitor declares it lost and fails it over;
        a shorter stall changes nothing, as a real transient one."""
        with self._lock:
            worker = self._workers.get(idx)
        if worker is not None and worker.alive:
            worker.service.inject_stall(seconds)

    def _handle_loss(self, idx: int, cause: WorkerLostException) -> int:
        """The membership's loss callback and ``kill_worker``'s body: retire
        the worker, then replay its unresolved assignments onto survivors
        on their original futures."""
        from deequ_tpu_torch.obs.registry import FLEET_FAILOVERS
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        with self._failover_lock:
            with self._lock:
                worker = self._workers.get(idx)
                if worker is None or not worker.alive or self._closed:
                    return 0
                worker.alive = False
                self._router.remove_worker(idx)
                self.workers_lost += 1
                # kept for stop(): a stalled thread may wake, and stop joins
                # it (its late resolutions are dropped by the futures' gate)
                self._zombies.append(worker.service)
            # halt without joining: a stalled thread cannot be joined, and a
            # death must not hold the failover behind it
            worker.service.stop(drain=False, join=False)
            self._update_alive_gauge()
            FLEET_FAILOVERS.inc()
            with self._lock:
                victims = [(f, a) for f, a in self._assignments.items()
                           if a.worker == idx and not f.done()]
            SCAN_STATS.record_degradation("worker_failover", worker=idx, tenants=len(victims),
                                          error=str(cause))
            redispatched = 0
            for future, asg in victims:
                redispatched += self._redispatch(future, asg, idx, cause)
            self.requests_redispatched += redispatched
            return redispatched

    def _redispatch(self, future, asg: _Assignment, lost_idx: int,
                    cause: WorkerLostException) -> int:
        """Replay one assignment onto a survivor, on its original future.
        A victim whose deadline passed is shed typed instead; otherwise the
        tenant's budget is charged (no free retries), and the future
        rejects typed when retries or survivors run out."""
        if asg.deadline_at is not None and time.monotonic() >= asg.deadline_at:
            self._shed_expired_victim(future, asg, lost_idx)
            return 0
        asg.failovers += 1
        if asg.budget is not None:
            try:
                asg.budget.charge("worker_failover", worker=lost_idx, tenant=asg.tenant)
            except RunBudgetExhaustedException as exhausted:
                self._finalize_budget_exhausted(future, asg, exhausted)
                return 0
        with self._lock:
            wid = self._router.place(asg.digest)
            target = self._workers.get(wid) if wid is not None else None
        if target is None or asg.failovers > self.config.failover_retries:
            future._reject(WorkerLostException(
                f"request for tenant {asg.tenant!r} lost worker {lost_idx} and "
                + ("no survivor remains" if target is None
                   else f"exhausted failover_retries={self.config.failover_retries}"),
                worker_ids=cause.worker_ids))
            return 0
        req = ServeRequest(
            data=asg.data, checks=asg.checks, required_analyzers=asg.required_analyzers,
            tenant=asg.tenant,
            run_policy=_PreArmedPolicy(asg.budget) if asg.budget is not None else None,
            future=future,
            # the original deadline: the queue wait accrues across the
            # failover, and the adopting worker's queue still sheds it
            slo=asg.slo, deadline_at=asg.deadline_at)
        try:
            target.service.resume([req])
        except ServiceClosedException as e:
            # the survivor died between placement and resume: reject typed
            # rather than strand the future
            future._reject(WorkerLostException(
                f"failover target worker {target.idx} already closed: {e}",
                worker_ids=(lost_idx, target.idx)))
            return 0
        asg.worker = target.idx
        self._chain_done(future)  # resume() rebound the observation seam
        return 1

    def _shed_expired_victim(self, future, asg: _Assignment, lost_idx: int) -> None:
        """Shed one victim whose deadline passed, typed and once, on its
        original future, charging its budget ``deadline_shed`` (an
        exhaustion there is swallowed: the shed is the outcome)."""
        from deequ_tpu_torch.obs.registry import SERVE_SHED_BY_CLASS
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.resilience.governance import try_charge

        cls = asg.slo.cls if asg.slo is not None else "standard"
        waited = time.monotonic() - future.submitted_at
        SCAN_STATS.record_degradation("deadline_shed", tenant=asg.tenant, slo_class=cls,
                                      worker=lost_idx, at="failover", waited_s=round(waited, 4))
        SERVE_SHED_BY_CLASS[cls].inc()
        try_charge(asg.budget, "deadline_shed", tenant=asg.tenant, worker=lost_idx)
        future._reject(DeadlineExceededException(
            f"request for tenant {asg.tenant!r} lost worker {lost_idx} after its {cls!r} "
            f"SLO deadline ({asg.slo.deadline_ms:g} ms) already passed — shed at failover "
            "instead of replayed stale",
            tenant=asg.tenant, slo_class=cls, deadline_ms=asg.slo.deadline_ms,
            waited_s=waited))

    def _finalize_budget_exhausted(self, future, asg: _Assignment,
                                   exhausted: RunBudgetExhaustedException) -> None:
        """A failover charge exhausted the tenant's budget: this request
        degrades (typed failure metrics and the budget) or rejects typed,
        as on one service."""
        from deequ_tpu_torch.analyzers.runner import AnalyzerContext
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.verification import VerificationSuite, _dedup_analyzers

        SCAN_STATS.record_degradation("tenant_budget_exhausted", tenant=asg.tenant,
                                      reason=exhausted.reason)
        if self._tenant_health.record_failure(asg.tenant):
            SCAN_STATS.record_degradation(
                "tenant_quarantine", tenant=asg.tenant,
                consecutive=self._tenant_health.failures.get(asg.tenant))
        if not exhausted.degraded:
            future._reject(exhausted)
            return
        ctx = AnalyzerContext({
            a: a.to_failure_metric(exhausted)
            for a in _dedup_analyzers(self._analyzers_of(asg.checks, asg.required_analyzers))})
        result = VerificationSuite._evaluate(asg.checks, ctx)
        result.scan_stats = {"coalesced": False, "failed": str(exhausted)}
        result.run_budget = asg.budget.snapshot()
        future._resolve(result)

    # -- resume from the ledger ------------------------------------------------

    def _replay_ledger(self, resume_futures: Dict[str, Any]) -> None:
        """Replay every accepted and untombstoned ledger record (the futures
        a dead fleet orphaned) through the workers' ``resume`` — onto the
        original futures where the caller passes them, fresh ones
        otherwise. A deadline resumes minus the wall time spent dead, and
        an expired one is shed typed instead of replayed stale."""
        if self._ledger is None:
            return
        outstanding = self._ledger.outstanding()
        if not outstanding:
            return
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
        from deequ_tpu_torch.serve.ledger import RequestLedger

        snap = self._ledger.latest_quarantine()
        if snap is not None:
            self._tenant_health.restore(snap)
        now_wall = time.time()
        with self._failover_lock:
            for accept_id, rec in outstanding.items():
                try:
                    tenant = RequestLedger.load_tenant(rec)
                    data, checks, required = RequestLedger.load_work(rec)
                except CorruptStateException as e:
                    SCAN_STATS.record_degradation("ledger_undecodable_record", id=accept_id,
                                                  error=str(e))
                    continue
                future = resume_futures.get(accept_id)
                if future is None:
                    future = VerificationFuture(tenant)
                future.accept_id = accept_id
                slo_rec = rec.get("slo") or {}
                slo = Slo(deadline_ms=slo_rec.get("deadline_ms"),
                          weight=float(slo_rec.get("weight", 1.0)),
                          cls=str(slo_rec.get("cls", "standard")))
                left = None
                if rec.get("deadline_left_s") is not None:
                    dead_for = now_wall - float(rec.get("accepted_wall", now_wall))
                    left = float(rec["deadline_left_s"]) - max(dead_for, 0.0)
                digest = rec.get("digest") or route_digest(
                    data, self._analyzers_of(checks, required))
                asg = _Assignment(
                    data=data, checks=tuple(checks), required_analyzers=tuple(required),
                    tenant=tenant, budget=None, digest=digest, worker=-1, slo=slo,
                    deadline_at=time.monotonic() + left if left is not None else None,
                    accept_id=accept_id)
                with self._lock:
                    self._assignments[future] = asg
                    self._record_heat(digest)
                self._chain_done(future)
                self.resumed[accept_id] = future
                if left is not None and left <= 0:
                    self._shed_expired_victim(future, asg, -1)
                    continue
                with self._lock:
                    wid = self._router.place(digest)
                    target = self._workers.get(wid) if wid is not None else None
                if target is None:
                    future._reject(WorkerLostException("resume replay found no alive workers",
                                                       worker_ids=()))
                    continue
                req = ServeRequest(data=data, checks=tuple(checks),
                                   required_analyzers=tuple(required), tenant=tenant,
                                   run_policy=None, future=future, slo=slo,
                                   deadline_at=asg.deadline_at)
                asg.worker = target.idx
                try:
                    target.service.resume([req])
                except ServiceClosedException as e:
                    future._reject(WorkerLostException(
                        f"resume replay target worker {target.idx} already closed: {e}",
                        worker_ids=(target.idx,)))
                    continue
                self._chain_done(future)  # resume() rebound the seam
        SCAN_STATS.record_degradation("coord_resume", replayed=len(self.resumed))

    # -- lifecycle -------------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            services = [w.service for w in self._workers.values() if w.alive]
        for service in services:
            service.flush(timeout)

    def stop(self, drain: bool = True) -> List:
        """Stop the fleet: ``drain=True`` serves every queued request first.
        The zombies (lost workers' services) are joined too, so no batch of
        theirs is still running on the device after it. Returns the
        futures still unresolved (none after a drain)."""
        self.membership.stop()
        with self._lock:
            self._closed = True
            services = [w.service for w in self._workers.values() if w.alive]
            zombies = list(self._zombies)
        for service in services:
            service.stop(drain=drain)
        for zombie in zombies:
            zombie.stop(drain=False)
        if self._ledger is not None:
            self._ledger.close()
        self._update_alive_gauge(0)
        with self._lock:
            return [f for f in self._assignments if not f.done()]

    def __enter__(self) -> "VerificationFleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # -- introspection ---------------------------------------------------------

    def _update_alive_gauge(self, value: Optional[int] = None) -> None:
        from deequ_tpu_torch.obs.registry import FLEET_WORKERS_ALIVE

        FLEET_WORKERS_ALIVE.set(value if value is not None else len(self._alive_ids()))

    def _section(self) -> dict:
        """The registry's ``fleet`` section (``_fleet_section``)."""
        from deequ_tpu_torch.obs.registry import FLEET_FAILOVERS

        with self._lock:
            workers = {
                str(i): {
                    "alive": w.alive,
                    "queue_depth": w.queue_depth() if w.alive else 0,
                    "suites_served": w.service.suites_served,
                    # each worker's brownout level (the registry's gauge is
                    # the last transition of any worker)
                    "brownout_level": w.service._brownout.level,
                }
                for i, w in self._workers.items()
            }
            hot = sorted(self._heat.items(), key=lambda kv: kv[1],
                         reverse=True)[: self.config.warm_plans]
            pending = sum(1 for f in self._assignments if not f.done())
        return {
            "workers_alive": sum(1 for w in workers.values() if w["alive"]),
            "workers_lost": self.workers_lost,
            "failovers": FLEET_FAILOVERS.value,
            "requests_redispatched": self.requests_redispatched,
            "requests_outstanding": pending,
            "workers": workers,
            "hot_plans": [{"digest": d[:12], "heat": n} for d, n in hot],
        }

    def stats(self) -> dict:
        return self._section()
