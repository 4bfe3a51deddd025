"""Per-tenant SLO admission control, deadline-aware fair queuing and the
brownout ladder — the serving layer's overload tier (the counterpart of
``deequ_tpu/serve/admission.py``).

Three mechanisms meet at the service's submit and queue seams:

- :class:`Slo` and :class:`AdmissionController` — every submission
  carries an SLO (``deadline_ms``, ``weight``, ``cls``: ``critical``,
  ``standard`` or ``best_effort``; defaults from ``DEEQU_TORCH_SLO_CLASS``
  and ``DEEQU_TORCH_SLO_DEADLINE_MS``). Admission runs at ``submit()``:
  each class owns a bounded share of the pending queue
  (:data:`CLASS_QUEUE_SHARE`: critical may use all of it, lower classes
  less, so a best_effort flood never fills the room critical requests
  admit into), and a refusal is typed
  (``AdmissionRejectedException``, a ``ServiceOverloadedException``) with
  a ``retry_after_s`` priced from the observed drain rate — and, once the
  service feeds it, from the queue's predicted plan cost
  (``ops/plan_cost.py``): a queue of heavy suites schedules a later retry
  than the same depth of light ones.
- :class:`TenantFairQueue` — the pending queue is class-tiered weighted
  deficit round-robin over per-tenant queues: classes pop in strict
  priority (a critical request never waits behind a lower class), and
  within a class a flooding tenant gets its weighted share of the batches
  and no more. A request whose absolute deadline expired in the queue is
  shed when it would pop, before any device work: resolved once, typed
  (``DeadlineExceededException``), on its own future.
- :class:`BrownoutController` — a 3-level ladder driven by the queue
  depth (what the ``serve_queue_depth`` gauge publishes), the recent
  latency and the queued cost: level 1 sheds best_effort admissions,
  level 2 also caps each tenant's queued requests, level 3 admits
  critical only; hysteretic, one level down an update. Computation is
  never degraded: the ladder changes which requests run, never how, so
  every completed result stays bit for bit an unloaded serial run.

Observables: the per-class ``serve_admitted_*``,
``serve_admission_rejected_*`` and ``serve_shed_*`` counters and the
``serve_brownout_level`` gauge (``obs/registry.py``); ``brownout`` and
``deadline_shed`` degradation events (on an armed recorder, instant
events).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from deequ_tpu_torch.exceptions import (
    AdmissionRejectedException,
    ServiceOverloadedException,
)

#: the SLO classes, in strict pop-priority order (index = priority)
SLO_CLASSES = ("critical", "standard", "best_effort")

#: fraction of ``max_pending`` each class may occupy while queued:
#: critical may use the whole queue, lower classes progressively less —
#: the reserved headroom is what keeps critical admissible (and its p99
#: inside its SLO) under a lower-class flood
CLASS_QUEUE_SHARE = {
    "critical": 1.0,
    "standard": 0.75,
    "best_effort": 0.5,
}


@dataclass(frozen=True)
class Slo:
    """One submission's service-level objective.

    ``deadline_ms`` is the ABSOLUTE submit->dispatch budget: a request
    still queued when it expires is shed typed pre-dispatch (None = no
    deadline, best-effort latency). ``weight`` is the tenant's
    fair-share weight inside its class (2.0 = twice the batch slots of
    a weight-1 tenant under contention). ``cls`` picks the admission /
    scheduling tier."""

    deadline_ms: Optional[float] = None
    weight: float = 1.0
    cls: str = "standard"

    def __post_init__(self):
        if self.cls not in SLO_CLASSES:
            raise ValueError(
                f"Slo.cls must be one of {list(SLO_CLASSES)}, "
                f"got {self.cls!r}"
            )
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError(
                f"Slo.deadline_ms must be > 0 ms or None, "
                f"got {self.deadline_ms!r}"
            )
        if not self.weight > 0:
            raise ValueError(f"Slo.weight must be > 0, got {self.weight!r}")

    @property
    def deadline_seconds(self) -> Optional[float]:
        if self.deadline_ms is None:
            return None
        return self.deadline_ms / 1000.0

    @staticmethod
    def default() -> "Slo":
        """The envcfg-registered default for submissions carrying no
        SLO: ``DEEQU_TORCH_SLO_CLASS`` (default ``standard``) +
        ``DEEQU_TORCH_SLO_DEADLINE_MS`` (default none)."""
        from deequ_tpu_torch.envcfg import env_value

        return Slo(
            deadline_ms=env_value("DEEQU_TORCH_SLO_DEADLINE_MS"),
            cls=env_value("DEEQU_TORCH_SLO_CLASS"),
        )


def resolve_slo(slo: Optional[Slo]) -> Slo:
    """Argument > envcfg default — the resolution every submit applies."""
    if slo is None:
        return Slo.default()
    if not isinstance(slo, Slo):
        raise TypeError(f"slo must be an Slo, got {type(slo).__name__}")
    return slo


class BrownoutController:
    """The 3-level overload ladder (module doc). ``update(depth)``
    recomputes the level from the queue-depth fraction (the same number
    the registry's ``serve_queue_depth`` gauge publishes) plus the
    recent-latency feed (``observe_latency`` — the same values the
    registry's serve latency histograms observe): ascent jumps straight
    to the highest threshold crossed; descent is hysteretic, one level
    per update, only once depth falls below that level's DOWN
    threshold. Level changes set the ``serve_brownout_level`` gauge and
    record a ``brownout`` degradation event (which the armed flight
    recorder picks up like every other rung)."""

    #: queue-depth fractions (of capacity) that RAISE to level 1/2/3
    UP = (0.5, 0.75, 0.9)
    #: fractions to DROP back below level 1/2/3 (hysteresis)
    DOWN = (0.25, 0.5, 0.7)

    def __init__(
        self,
        capacity: int,
        up: Tuple[float, ...] = UP,
        down: Tuple[float, ...] = DOWN,
        latency_high: Optional[float] = None,
        latency_window: int = 64,
        latency_horizon: float = 30.0,
        enabled: bool = True,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if len(up) != 3 or len(down) != 3:
            raise ValueError("up/down need one threshold per level (3)")
        if any(d >= u for d, u in zip(down, up)):
            raise ValueError(
                "each DOWN threshold must sit below its UP threshold "
                "(hysteresis)"
            )
        if list(up) != sorted(up) or list(down) != sorted(down):
            raise ValueError("brownout thresholds must ascend with level")
        self.capacity = int(capacity)
        self.up = tuple(up)
        self.down = tuple(down)
        #: recent submit->resolve latency (s) above which the ladder
        #: holds at least level 1 even with a shallow queue (a slow
        #: backend is overload too); None disables the latency signal
        self.latency_high = latency_high
        #: samples older than this (s) age out of the p95 window: the
        #: signal is fed by COMPLETIONS, and at level 1 a best_effort
        #: service may complete nothing — without expiry one slow patch
        #: would latch the ladder hot forever on an idle service
        self.latency_horizon = float(latency_horizon)
        self.enabled = bool(enabled)
        self.level = 0
        self.transitions = 0
        self._lat: deque = deque(maxlen=int(latency_window))

    def observe_latency(self, seconds: float) -> None:
        self._lat.append((time.monotonic(), float(seconds)))

    def recent_latency_p95(self) -> Optional[float]:
        horizon = time.monotonic() - self.latency_horizon
        while self._lat and self._lat[0][0] < horizon:
            self._lat.popleft()
        if not self._lat:
            return None
        ordered = sorted(v for _, v in self._lat)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    def update(self, depth: int, cost_frac: Optional[float] = None) -> int:
        """Recompute + return the level for the current queue depth.
        ``cost_frac`` is queued PREDICTED COST over cost
        capacity (ops/plan_cost.py via the admission controller): the
        ladder reads the max of the two pressures, so a queue of few but
        heavy suites browns out as early as a deep queue of light ones —
        thresholds derived from predicted plan cost, not depth alone."""
        if not self.enabled:
            return 0
        frac = depth / self.capacity
        if cost_frac is not None:
            frac = max(frac, float(cost_frac))
        target = 0
        for i, threshold in enumerate(self.up):
            if frac >= threshold:
                target = i + 1
        latency_hot = False
        if self.latency_high is not None:
            p95 = self.recent_latency_p95()
            latency_hot = p95 is not None and p95 >= self.latency_high
            if latency_hot:
                target = max(target, 1)
        prev = self.level
        if target > prev:
            new = target
        elif (
            prev > 0
            and frac < self.down[prev - 1]
            and not (latency_hot and prev == 1)
        ):
            new = prev - 1  # hysteretic: one step down per update
        else:
            new = prev
        if new != prev:
            self.level = new
            self.transitions += 1
            from deequ_tpu_torch.obs.registry import SERVE_BROWNOUT_LEVEL
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

            SERVE_BROWNOUT_LEVEL.set(new)
            SCAN_STATS.record_degradation(
                "brownout", level=new, prev=prev,
                queue_frac=round(frac, 3),
            )
        return self.level


class AdmissionController:
    """The submit()-time gate (module doc): class queue budgets, the
    brownout ladder's admission policy, and the per-tenant inflight cap.
    All refusals are typed ``ServiceOverloadedException`` family with
    ``retry_after_s`` derived from the observed drain rate."""

    def __init__(
        self,
        max_pending: int,
        brownout: Optional[BrownoutController] = None,
        class_share: Optional[Dict[str, float]] = None,
        inflight_cap: Optional[int] = None,
    ):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self.brownout = brownout
        share = dict(CLASS_QUEUE_SHARE)
        share.update(class_share or {})
        unknown = set(share) - set(SLO_CLASSES)
        if unknown:
            raise ValueError(f"unknown SLO classes in class_share: {unknown}")
        if any(not 0 < s <= 1.0 for s in share.values()):
            raise ValueError("class_share fractions must be in (0, 1]")
        self.class_share = share
        #: per-tenant queued-request cap applied at brownout level >= 2
        #: ("inflight" at the admission seam = admitted but not yet
        #: dispatched); default: an equal slice of the queue for 16
        #: tenants, never below 1
        self.inflight_cap = (
            int(inflight_cap) if inflight_cap is not None
            else max(1, self.max_pending // 16)
        )
        if self.inflight_cap < 1:
            raise ValueError("inflight_cap must be >= 1")
        # drain-rate EWMA behind retry_after (suites/s; None until the
        # first served batch reports in)
        self._rate: Optional[float] = None
        # cost-drain EWMAs (ops/plan_cost.py): cost units/s
        # served, and cost units per suite — retry_after prices the
        # QUEUED COST when the service feeds it, and the brownout
        # ladder's cost pressure normalizes against avg-cost * capacity
        self._cost_rate: Optional[float] = None
        self._avg_cost: Optional[float] = None

    def note_served(
        self, n: int, wall_seconds: float, cost: Optional[float] = None,
    ) -> None:
        """Feed the drain-rate estimate (called per served batch).
        ``cost`` is the batch's summed PREDICTED cost (plan-cost units);
        with it the controller also learns cost/s and cost/suite."""
        if n <= 0 or wall_seconds <= 0:
            return
        rate = n / wall_seconds
        self._rate = (
            rate if self._rate is None else 0.8 * self._rate + 0.2 * rate
        )
        if cost is not None and cost > 0:
            crate = cost / wall_seconds
            self._cost_rate = (
                crate if self._cost_rate is None
                else 0.8 * self._cost_rate + 0.2 * crate
            )
            per_suite = cost / n
            self._avg_cost = (
                per_suite if self._avg_cost is None
                else 0.8 * self._avg_cost + 0.2 * per_suite
            )

    def cost_fraction(self, queued_cost: Optional[float]) -> Optional[float]:
        """Queued predicted cost over cost CAPACITY (avg suite cost x
        max_pending) — the brownout ladder's second pressure feed. None
        until both a queued-cost ledger and a served-cost average
        exist."""
        if (
            queued_cost is None
            or self._avg_cost is None
            or self._avg_cost <= 0
        ):
            return None
        return float(queued_cost) / (self._avg_cost * self.max_pending)

    def retry_after(
        self, queue_depth: int, queued_cost: Optional[float] = None,
    ) -> float:
        """When a refused caller could plausibly be admitted. With a
        queued-cost ledger and an observed cost-drain rate,
        the schedule is time-to-drain the queued PREDICTED COST — a
        queue of heavy profiling suites schedules a later retry than the
        same depth of trivial checks; otherwise the legacy depth/rate
        estimate (bounded), or a small constant before any rate is
        known."""
        if (
            queued_cost is not None
            and self._cost_rate is not None
            and self._cost_rate > 0
        ):
            return min(
                30.0, max(0.005, float(queued_cost) / self._cost_rate)
            )
        if self._rate is None or self._rate <= 0:
            return 0.05
        return min(30.0, max(0.005, (queue_depth + 1) / self._rate))

    def admit(
        self,
        tenant,
        slo: Slo,
        queue_depth: int,
        class_depth: int,
        tenant_pending: int,
        queued_cost: Optional[float] = None,
    ) -> int:
        """Admit or raise typed. Returns the brownout level applied.
        ``class_depth`` is the queued count of ``slo.cls``;
        ``tenant_pending`` the tenant's queued count (the level-2 cap's
        subject); ``queued_cost`` the queue's summed PREDICTED plan cost
        (drives cost-aware ``retry_after_s`` and the
        brownout ladder's cost pressure). The caller (the service, under
        its queue lock) supplies the depths so decision and enqueue are
        atomic."""
        from deequ_tpu_torch.obs.registry import (
            SERVE_ADMISSION_REJECTED_BY_CLASS,
            SERVE_ADMITTED_BY_CLASS,
        )

        level = (
            self.brownout.update(
                queue_depth, cost_frac=self.cost_fraction(queued_cost)
            )
            if self.brownout is not None else 0
        )
        retry = self.retry_after(queue_depth, queued_cost=queued_cost)

        def refuse(exc):
            SERVE_ADMISSION_REJECTED_BY_CLASS[slo.cls].inc()
            raise exc

        if queue_depth >= self.max_pending:
            refuse(ServiceOverloadedException(
                f"{queue_depth} requests pending >= "
                f"max_pending={self.max_pending}",
                queue_depth=queue_depth, retry_after_s=retry,
                slo_class=slo.cls,
            ))
        if level >= 3 and slo.cls != "critical":
            refuse(AdmissionRejectedException(
                f"brownout level 3: admitting critical only, "
                f"shedding {slo.cls!r} (tenant {tenant!r})",
                reason="brownout_critical_only", queue_depth=queue_depth,
                retry_after_s=retry, slo_class=slo.cls,
            ))
        if level >= 1 and slo.cls == "best_effort":
            refuse(AdmissionRejectedException(
                f"brownout level {level}: shedding best_effort "
                f"admissions (tenant {tenant!r})",
                reason="brownout_best_effort", queue_depth=queue_depth,
                retry_after_s=retry, slo_class=slo.cls,
            ))
        if level >= 2 and tenant_pending >= self.inflight_cap:
            refuse(AdmissionRejectedException(
                f"brownout level {level}: tenant {tenant!r} at the "
                f"per-tenant inflight cap ({tenant_pending} >= "
                f"{self.inflight_cap})",
                reason="tenant_inflight_cap", queue_depth=queue_depth,
                retry_after_s=retry, slo_class=slo.cls,
            ))
        budget = self.class_share[slo.cls] * self.max_pending
        if class_depth >= budget:
            refuse(AdmissionRejectedException(
                f"SLO class {slo.cls!r} queue budget exhausted "
                f"({class_depth} >= {budget:g} of "
                f"max_pending={self.max_pending})",
                reason="class_budget", queue_depth=queue_depth,
                retry_after_s=retry, slo_class=slo.cls,
            ))
        SERVE_ADMITTED_BY_CLASS[slo.cls].inc()
        return level


class TenantFairQueue:
    """Class-tiered weighted deficit round-robin over per-tenant queues,
    with pop-time deadline shedding (module doc).

    NOT internally locked: the owning service serializes every call
    under its own condition lock (decision + mutation must be atomic
    with the rest of the service state anyway). ``pop`` hands expired
    requests to ``shed`` instead of returning them — the callback must
    only COLLECT (the service resolves the futures after releasing its
    lock, so a resolution callback can never deadlock against it)."""

    def __init__(self):
        # cls -> OrderedDict[tenant_key, deque[request]]; OrderedDict
        # order IS the round-robin rotation (move_to_end on each visit)
        self._tiers: Dict[str, "OrderedDict[str, deque]"] = {
            cls: OrderedDict() for cls in SLO_CLASSES
        }
        self._credit: Dict[Tuple[str, str], float] = {}
        self._len = 0
        # incremental depth ledgers: every submit's admission decision
        # reads class_depth + tenant_depth under the service lock, and
        # summing deques per call would make each submit O(tenants)
        self._class_len: Dict[str, int] = {cls: 0 for cls in SLO_CLASSES}
        self._tenant_len: Dict[str, int] = {}

    @staticmethod
    def _cls_of(req) -> str:
        slo = getattr(req, "slo", None)
        return slo.cls if slo is not None else "standard"

    @staticmethod
    def _tenant_key(req) -> str:
        return str(req.tenant)

    def push(self, req) -> None:
        cls = self._cls_of(req)
        tier = self._tiers[cls]
        key = self._tenant_key(req)
        bucket = tier.get(key)
        if bucket is None:
            bucket = deque()
            tier[key] = bucket
        bucket.append(req)
        self._len += 1
        self._class_len[cls] += 1
        self._tenant_len[key] = self._tenant_len.get(key, 0) + 1

    def _removed(self, cls: str, key: str) -> None:
        """Depth-ledger decrement for one request leaving the queue."""
        self._len -= 1
        self._class_len[cls] -= 1
        left = self._tenant_len.get(key, 0) - 1
        if left <= 0:
            self._tenant_len.pop(key, None)
        else:
            self._tenant_len[key] = left

    def __len__(self) -> int:
        return self._len

    def class_depth(self, cls: str) -> int:
        return self._class_len[cls]

    def tenant_depth(self, tenant) -> int:
        return self._tenant_len.get(str(tenant), 0)

    def depths(self) -> Dict[str, Dict[str, int]]:
        """{cls: {tenant: queued}} — the introspection feed."""
        return {
            cls: {t: len(dq) for t, dq in tier.items() if dq}
            for cls, tier in self._tiers.items()
        }

    def pop(self, now: float, shed: Callable[[object], None]):
        """The next request to dispatch, or None when (after shedding)
        nothing remains. Strict class priority; WDRR across tenants
        within a class; expired heads are handed to ``shed`` and never
        returned."""
        for cls in SLO_CLASSES:
            req = self._pop_tier(cls, now, shed)
            if req is not None:
                return req
        return None

    def _pop_tier(self, cls: str, now: float, shed):
        tier = self._tiers[cls]
        # spin guard: every full rotation grants every tenant its
        # weight, so some credit crosses 1.0 within ceil(1/min_weight)
        # rotations; the cap only backstops a pathological weight
        spins = 0
        while tier:
            tenant, bucket = next(iter(tier.items()))
            while bucket:
                head = bucket[0]
                deadline_at = getattr(head, "deadline_at", None)
                if deadline_at is None or now < deadline_at:
                    break
                bucket.popleft()
                self._removed(cls, tenant)
                shed(head)  # collect-only; resolved by the caller later
            if not bucket:
                del tier[tenant]
                self._credit.pop((cls, tenant), None)
                continue
            credit = self._credit.get((cls, tenant), 0.0)
            if credit < 1.0 and spins <= 4 * len(tier) + 100:
                slo = getattr(bucket[0], "slo", None)
                weight = slo.weight if slo is not None else 1.0
                self._credit[(cls, tenant)] = credit + weight
                tier.move_to_end(tenant)
                spins += 1
                continue
            remaining = max(credit - 1.0, 0.0)
            self._credit[(cls, tenant)] = remaining
            req = bucket.popleft()
            self._removed(cls, tenant)
            if not bucket:
                del tier[tenant]
                self._credit.pop((cls, tenant), None)
            elif remaining < 1.0:
                # spent: rotate away. A tenant still holding a whole
                # credit stays at the head and drains it on the next
                # pop — DRR serves each visit's full quantum as a
                # burst, or a weight-2 tenant would dilute to ~4:3
                # instead of 2:1 (every interleaved visit hands the
                # competition a fresh grant)
                tier.move_to_end(tenant)
            return req
        return None

    def drain(self) -> List:
        """Remove and return every queued request (class-priority then
        rotation order) — the ``stop(drain=False)`` carrier."""
        out: List = []
        for cls in SLO_CLASSES:
            tier = self._tiers[cls]
            for bucket in tier.values():
                out.extend(bucket)
            tier.clear()
        self._credit.clear()
        self._len = 0
        self._class_len = {cls: 0 for cls in SLO_CLASSES}
        self._tenant_len.clear()
        return out


# re-exported for callers that only need the typed refusal surface
__all__ = [
    "AdmissionController",
    "AdmissionRejectedException",
    "BrownoutController",
    "CLASS_QUEUE_SHARE",
    "resolve_slo",
    "Slo",
    "SLO_CLASSES",
    "TenantFairQueue",
]
