"""deequ_tpu_torch.serve — the in-process multi-tenant verification
service and fleet (the counterpart of ``deequ_tpu/serve``: its service,
admission, plan cache, coalesced executor, fleet and request ledger).

Many small suites from many tenants cost the card microseconds each, and
a run's fixed costs — building its ops and fold, a copy in, a fetch out —
dwarf them. This package pays those costs once a batch:

- :mod:`plan_cache` — suites are fingerprinted by (schema, analyzer set,
  packer layout, row count); a repeat tenant reuses the built plan and its
  program on the device and builds nothing (``ScanStats.plan_cache_hits``);
- :mod:`executor` — a coalesced batch: K tenants' tables in one host
  buffer, one copy, every member's K1 tasks in one batch, one fold merge
  and one fetch, each member bit for bit its serial run;
- :mod:`service` — :class:`VerificationService`: ``submit(...) ->
  VerificationFuture``, a worker with a coalescing window, per-tenant run
  budgets, bisection of a faulted batch, quarantine, kill-and-resume;
- :mod:`admission` — SLO classes, typed admission with ``retry_after_s``,
  the deadline-aware tenant-fair queue and the brownout ladder;
- :mod:`fleet` — :class:`VerificationFleet`: N services behind one
  ``submit``, placed by consistent hash (:mod:`router`), watched by
  heartbeat (:mod:`membership`), failing a lost worker's requests over
  onto survivors bit for bit and exactly once, with one quarantine, warm
  joins and an optional durable request ledger (:mod:`ledger`, framed by
  :mod:`transport`'s checksummed codec).
"""

from deequ_tpu_torch.serve.admission import (
    AdmissionController,
    BrownoutController,
    Slo,
    TenantFairQueue,
)
from deequ_tpu_torch.serve.fleet import FleetConfig, VerificationFleet
from deequ_tpu_torch.serve.ledger import RequestLedger
from deequ_tpu_torch.serve.membership import FleetMembership, WorkerLossReport
from deequ_tpu_torch.serve.plan_cache import PlanCache, PlanKey, ServePlan
from deequ_tpu_torch.serve.router import ConsistentHashRouter, route_digest
from deequ_tpu_torch.serve.service import (
    PendingWork,
    ServeConfig,
    VerificationFuture,
    VerificationService,
)

__all__ = [
    "AdmissionController",
    "BrownoutController",
    "ConsistentHashRouter",
    "FleetConfig",
    "FleetMembership",
    "PendingWork",
    "PlanCache",
    "PlanKey",
    "RequestLedger",
    "route_digest",
    "ServeConfig",
    "ServePlan",
    "Slo",
    "TenantFairQueue",
    "VerificationFleet",
    "VerificationFuture",
    "VerificationService",
    "WorkerLossReport",
]
