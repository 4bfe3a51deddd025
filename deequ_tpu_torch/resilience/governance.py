"""Run-level fault governance — ONE budget for the whole composed ladder
(the port of ``deequ_tpu/resilience/governance.py``).

Each rung of the resilience ladder (I/O retry, batch quarantine, OOM
bisection, encoded demotion, the refused CPU rung) bounds itself; nothing
else bounds what their composition may spend. This module is the one
ledger:

- :class:`RunPolicy` — the value object (``run_deadline`` wall seconds,
  ``max_total_attempts``, ``on_budget_exhausted``); built explicitly, by
  ``VerificationRunBuilder.with_run_budget(...)``, by
  ``run_scan(run_deadline=..., max_total_attempts=...)``, or process-wide
  from ``DEEQU_TORCH_RUN_DEADLINE`` / ``DEEQU_TORCH_RUN_ATTEMPTS``;
- :class:`RunBudget` — an armed policy (start time and charge ledger).
  Every rung charges it: ``resilience/retry.py`` its failed reads,
  ``ops/scan_executors.py`` its bisections, demotions and refusals. A
  clean first try never charges, so a healthy run spends nothing;
- :func:`run_budget_scope` — the ambient slot the charge sites read, so
  the hundred per-batch scans of a stream draw on ONE budget;
- :func:`fault_state_scope` — snapshot, reset and restore of the
  process-wide fault singletons (``DEVICE_HEALTH``, ``RETRY_TELEMETRY``)
  and the installed scan fault hook, so tests cannot leak breaker state
  or counters into each other.

Exhaustion is typed and immediate: the first charge past the budget
raises :class:`~deequ_tpu_torch.exceptions.RunBudgetExhaustedException`.
Under ``on_budget_exhausted="degrade"`` (the default) the verification
layers turn it into a partial result — failure metrics for what could
not finish and exact ``unverified_row_ranges`` — and under ``"raise"`` it
propagates. With a wall deadline, ``run_scan`` also runs each whole scan
attempt under one watchdog armed with the budget left, so even a hung
device call ends typed within ``run_deadline``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

from deequ_tpu_torch.exceptions import RunBudgetExhaustedException

#: the two exhaustion policies (mirrors on_batch_error / on_device_error)
_EXHAUST_MODES = ("degrade", "raise")


def default_run_deadline() -> Optional[float]:
    """The process-wide run wall deadline (seconds) from
    ``DEEQU_TORCH_RUN_DEADLINE``; unset, empty or 0 disables it, a
    malformed value raises ``EnvConfigError`` — a deployment that thinks
    it is governed must not run ungoverned."""
    from deequ_tpu_torch.envcfg import env_value

    return env_value("DEEQU_TORCH_RUN_DEADLINE")


def default_max_total_attempts() -> Optional[int]:
    """The process-wide attempt budget from ``DEEQU_TORCH_RUN_ATTEMPTS``;
    unset, empty or 0 disables it, a malformed value raises typed."""
    from deequ_tpu_torch.envcfg import env_value

    return env_value("DEEQU_TORCH_RUN_ATTEMPTS")


@dataclass(frozen=True)
class RunPolicy:
    """Run-level fault-budget policy (value object; ``arm()`` starts the
    clock). ``max_total_attempts`` bounds FAILURE-driven attempts across
    every rung of the composed ladder — a clean first try is free, the
    same accounting rule RetryTelemetry uses — and ``run_deadline``
    bounds the run's wall clock from arming."""

    run_deadline: Optional[float] = None
    max_total_attempts: Optional[int] = None
    on_budget_exhausted: str = "degrade"

    def __post_init__(self):
        if self.on_budget_exhausted not in _EXHAUST_MODES:
            raise ValueError(
                f"on_budget_exhausted must be one of {_EXHAUST_MODES}, "
                f"got {self.on_budget_exhausted!r}"
            )
        if self.run_deadline is not None and self.run_deadline <= 0:
            raise ValueError("run_deadline must be positive seconds")
        if self.max_total_attempts is not None and self.max_total_attempts < 0:
            raise ValueError("max_total_attempts must be >= 0")

    def arm(self) -> "RunBudget":
        return RunBudget(self)


class RunBudget:
    """One armed RunPolicy: the charge ledger every ladder rung draws on.

    ``charge(kind)`` is the only spending primitive — it increments the
    total and the per-kind ledger, mirrors into
    ``ScanStats.budget_charges``, and raises
    ``RunBudgetExhaustedException`` the moment the total passes
    ``max_total_attempts`` or the wall clock passes ``run_deadline``.
    Once exhausted, EVERY subsequent charge re-raises — a nested retry
    loop that catches the first raise cannot keep spending."""

    def __init__(self, policy: RunPolicy):
        self.policy = policy
        self.started = time.monotonic()
        self.attempts = 0
        self.charges: Dict[str, int] = {}
        self.exhausted_reason: Optional[str] = None

    # -- clock -----------------------------------------------------------

    def elapsed_seconds(self) -> float:
        return time.monotonic() - self.started

    def remaining_seconds(self) -> Optional[float]:
        """Wall budget left (None when no deadline is set; never
        negative). run_scan arms each scan attempt's watchdog with it, so
        a hung call converts to a typed DeviceHangException before the
        run is past its deadline."""
        if self.policy.run_deadline is None:
            return None
        return max(self.policy.run_deadline - self.elapsed_seconds(), 0.0)

    # -- spending --------------------------------------------------------

    def charge(self, kind: str, **detail) -> None:
        """Spend one attempt of ``kind`` ('io_retry' | 'oom_bisect' |
        'encoded_demote' | 'mesh_reshard' | 'cpu_fallback_refused' | ...);
        raises typed
        when this charge exhausts the budget (or it already was
        exhausted)."""
        self.attempts += 1
        self.charges[kind] = self.charges.get(kind, 0) + 1
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        SCAN_STATS.record_budget_charge()
        # the flight recorder's budget seam: every charge is an instant
        # event (which rung spent the budget, and when)
        from deequ_tpu_torch.obs.recorder import current_recorder

        rec = current_recorder()
        if rec is not None:
            rec.event("budget_charge", charge_kind=kind, attempts=self.attempts)
        reason = self.exhausted_reason
        if reason is None:
            cap = self.policy.max_total_attempts
            if cap is not None and self.attempts > cap:
                reason = "max_total_attempts"
            elif (
                self.policy.run_deadline is not None
                and self.elapsed_seconds() >= self.policy.run_deadline
            ):
                reason = "run_deadline"
        if reason is not None:
            self._exhaust(reason, kind, detail)

    def _exhaust(self, reason: str, kind: str, detail: dict) -> None:
        first = self.exhausted_reason is None
        self.exhausted_reason = reason
        if first:
            from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

            SCAN_STATS.record_budget_charge(exhausted=True)
        raise RunBudgetExhaustedException(
            reason,
            ledger=self.snapshot(),
            degraded=self.policy.on_budget_exhausted == "degrade",
            detail=(
                f"last charge kind={kind!r} "
                f"attempts={self.attempts}"
                + (
                    f"/{self.policy.max_total_attempts}"
                    if self.policy.max_total_attempts is not None
                    else ""
                )
                + f" elapsed={self.elapsed_seconds():.3f}s"
                + (
                    f"/{self.policy.run_deadline:g}s"
                    if self.policy.run_deadline is not None
                    else ""
                )
            ),
        )

    def snapshot(self) -> dict:
        """Point-in-time ledger copy (lands on
        ``VerificationResult.run_budget``)."""
        return {
            "run_deadline": self.policy.run_deadline,
            "max_total_attempts": self.policy.max_total_attempts,
            "on_budget_exhausted": self.policy.on_budget_exhausted,
            "attempts": self.attempts,
            "charges": dict(self.charges),
            "elapsed_seconds": round(self.elapsed_seconds(), 6),
            "exhausted": self.exhausted_reason,
        }


# -- ambient budget ----------------------------------------------------------

# thread-local, not a module global: concurrent governed runs must not
# charge each other's ledgers, and a watchdog worker abandoned by
# _governed_attempt keeps running — with a global slot its late charges
# would land on a later run's budget. Budgets therefore do not flow into
# new threads: the engine's governed attempt re-enters the scope on its
# worker with run_budget_scope.
_AMBIENT = threading.local()


def current_run_budget() -> Optional[RunBudget]:
    """This thread's ambient RunBudget (None = ungoverned)."""
    return getattr(_AMBIENT, "budget", None)


@contextmanager
def run_budget_scope(budget: Optional[RunBudget]):
    """Install ``budget`` as the ambient run budget for the block (on
    THIS thread). Every charge site inside — per-batch scans of a
    streaming run, nested retry wrappers, ladder rungs — draws on this
    one ledger. Worker threads spawned inside the block must re-enter
    the scope with the same budget (the engine's governed-attempt and
    prefetch seams do)."""
    prev = getattr(_AMBIENT, "budget", None)
    _AMBIENT.budget = budget
    try:
        yield budget
    finally:
        _AMBIENT.budget = prev


def resolve_run_policy(
    run_deadline: Optional[float] = None,
    max_total_attempts: Optional[int] = None,
    on_budget_exhausted: Optional[str] = None,
) -> Optional[RunPolicy]:
    """Arguments, then the environment, else ungoverned (None): the
    resolution every governed entry point (run_scan, do_analysis_run,
    do_verification_run) applies."""
    deadline = (
        float(run_deadline)
        if run_deadline is not None
        else default_run_deadline()
    )
    attempts = (
        int(max_total_attempts)
        if max_total_attempts is not None
        else default_max_total_attempts()
    )
    if on_budget_exhausted is not None:
        mode = on_budget_exhausted
    else:
        from deequ_tpu_torch.envcfg import env_value

        mode = env_value("DEEQU_TORCH_ON_BUDGET_EXHAUSTED")
    if deadline is None and attempts is None:
        if on_budget_exhausted is not None:
            raise ValueError(
                "on_budget_exhausted was set without a budget to govern: "
                "pass run_deadline and/or max_total_attempts"
            )
        return None
    return RunPolicy(
        run_deadline=deadline,
        max_total_attempts=attempts,
        on_budget_exhausted=mode,
    )


def charge_run_budget(kind: str, **detail) -> None:
    """Charge the ambient budget, if any (the retry layer's one-liner)."""
    budget = current_run_budget()
    if budget is not None:
        budget.charge(kind, **detail)


def try_charge(budget: Optional[RunBudget], kind: str, **detail) -> bool:
    """Charge ``budget`` (None = ungoverned, a no-op) and swallow its
    exhaustion: for a charge that is bookkeeping, not control flow — an
    outcome that is already typed and terminal must not be replaced by a
    budget error. Returns False when the charge exhausted (or found
    exhausted) the budget."""
    if budget is None:
        return True
    try:
        budget.charge(kind, **detail)
        return True
    except RunBudgetExhaustedException:
        return False


def run_budget_remaining() -> Optional[float]:
    """Ambient wall budget left, or None (no budget / no deadline) —
    backoff sleeps cap themselves at this so a retry loop cannot sleep
    past the run deadline."""
    budget = current_run_budget()
    if budget is None:
        return None
    return budget.remaining_seconds()


# -- fault-state isolation ---------------------------------------------------


@contextmanager
def fault_state_scope(reset: bool = True):
    """Isolate the process-wide fault singletons for the block.

    Snapshots ``DEVICE_HEALTH`` and ``MESH_HEALTH`` (ops/device_policy.py),
    ``RETRY_TELEMETRY`` (resilience/retry.py) and the installed scan fault
    hook; with ``reset=True`` (the default) the hook is removed and each
    singleton starts the block fresh (``reset=False`` keeps them live and
    only guarantees the restore). On exit everything is restored as it
    was: a test can trip the breaker and exhaust retries without leaking
    any of it into the next run. The singletons hold plain values (ints,
    floats, strings, one exception object) and flat dicts of them, so a
    copy of each, its dicts copied, is its snapshot."""
    from deequ_tpu_torch.ops.device_policy import (
        DEVICE_HEALTH,
        MESH_HEALTH,
        current_scan_fault_hook,
        install_scan_fault_hook,
    )
    from deequ_tpu_torch.resilience.retry import RETRY_TELEMETRY

    singletons = (DEVICE_HEALTH, MESH_HEALTH, RETRY_TELEMETRY)
    saved = [(obj, {k: dict(v) if isinstance(v, dict) else v for k, v in vars(obj).items()})
             for obj in singletons]
    prev_hook = current_scan_fault_hook()
    if reset:
        install_scan_fault_hook(None)
        for obj in singletons:
            obj.reset()
    try:
        yield
    finally:
        install_scan_fault_hook(prev_hook)
        for obj, state in saved:
            obj.__dict__.clear()
            obj.__dict__.update(state)
