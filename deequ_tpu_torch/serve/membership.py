"""Heartbeat-driven fleet membership — the peer check of
``parallel/distributed.py`` applied in-process (the counterpart of
``deequ_tpu/serve/membership.py``).

The multi-process tier already has a liveness check: ``check_peers`` runs
an injectable probe — ``probe(timeout) -> responsive member ids`` —
attributes the losses (``run_liveness_check``) and raises typed or returns
a report. The fleet reuses that core with another default probe: a worker
is alive when its service thread runs and its ``heartbeat`` (bumped every
worker loop) is fresher than ``stall_timeout``. A worker wedged inside a
dispatch looks like a dead one, on purpose: both stopped serving their
queue, and both need failover.

A loss surfaces as a typed
:class:`~deequ_tpu_torch.exceptions.WorkerLostException` or, under
``on_worker_loss="degrade"``, as a :class:`WorkerLossReport` the fleet's
failover consumes. A monitor thread polls every ``interval`` seconds
(``DEEQU_TORCH_HEARTBEAT_INTERVAL``) and calls the fleet's loss callback.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from deequ_tpu_torch.exceptions import WorkerLostException
from deequ_tpu_torch.parallel.distributed import run_liveness_check, validate_loss_mode


@dataclass
class WorkerLossReport:
    """One liveness check's outcome (as ``PeerLossReport``): ``lost`` the
    worker ids that stopped responding, ``surviving`` the rest."""

    n_workers: int
    surviving: List[int] = field(default_factory=list)
    lost: List[int] = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.lost)


class FleetMembership:
    """Liveness of one fleet's workers (module doc). ``members()`` gives
    the ids expected alive, ``probe_of(worker_id)`` (thread alive,
    heartbeat on the monotonic clock) of one, and ``on_loss(worker_id,
    exc)`` is the fleet's failover, called by the monitor once a newly
    lost worker."""

    def __init__(
        self,
        members: Callable[[], Sequence[int]],
        probe_of: Callable[[int], tuple],
        on_loss: Callable[[int, WorkerLostException], None],
        interval: float = 0.25,
        stall_timeout: float = 2.0,
    ):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if stall_timeout <= 0:
            raise ValueError(f"stall_timeout must be > 0, got {stall_timeout}")
        self._members = members
        self._probe_of = probe_of
        self._on_loss = on_loss
        self.interval = float(interval)
        self.stall_timeout = float(stall_timeout)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_probe(self, timeout: float) -> List[int]:
        """The responsive worker ids: thread alive and heartbeat fresher
        than ``stall_timeout`` (the peer probe's contract; tests replace
        it with a plain callable)."""
        now = time.monotonic()
        alive = []
        for wid in self._members():
            thread_alive, heartbeat = self._probe_of(wid)
            if thread_alive and (now - heartbeat) <= self.stall_timeout:
                alive.append(wid)
        return alive

    def check_workers(
        self,
        timeout: Optional[float] = None,
        on_worker_loss: str = "fail",
        probe: Optional[Callable[[float], Sequence[int]]] = None,
    ) -> WorkerLossReport:
        """Check that every expected worker responds (the fleet's
        ``check_peers``): ``"fail"`` raises a typed ``WorkerLostException``
        naming the lost workers, ``"degrade"`` returns the report."""
        validate_loss_mode(on_worker_loss, "on_worker_loss")
        expected = sorted(self._members())
        report = WorkerLossReport(n_workers=len(expected))
        if not expected:
            return report
        probe = probe or self._default_probe
        # an unattributable stall makes every worker suspect: even "degrade"
        # cannot pick a failover target, so the shared core raises typed
        alive, lost = run_liveness_check(
            expected,
            timeout if timeout is not None else self.stall_timeout,
            probe,
            lambda e: WorkerLostException(
                f"fleet liveness probe timed out unattributably: {e}",
                worker_ids=tuple(expected)),
        )
        report.surviving = alive
        report.lost = lost
        if lost and on_worker_loss == "fail":
            raise WorkerLostException(
                f"lost contact with fleet worker(s) {lost} (surviving: {alive}); "
                "their accepted requests need failover re-dispatch",
                worker_ids=tuple(lost))
        return report

    def poll(self) -> WorkerLossReport:
        """One monitor tick: check liveness and call ``on_loss`` for every
        newly lost worker (degrade: the fleet fails over, it does not
        abort)."""
        report = self.check_workers(on_worker_loss="degrade")
        for wid in report.lost:
            self._on_loss(wid, WorkerLostException(
                f"worker {wid} stopped heartbeating "
                f"(stall_timeout={self.stall_timeout:g}s)",
                worker_ids=(wid,)))
        return report

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="deequ-torch-fleet-hb")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _monitor(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll()
            except WorkerLostException:
                # an unattributable probe timeout names no target to fail
                # over to; the next tick usually attributes (a dead fleet
                # surfaces typed at the next submit)
                continue
            except Exception as e:  # noqa: BLE001 — the monitor outlives a
                # failover that raised (a tenant's own checks run in the
                # budget finalisation): the error is a degradation event,
                # and the next tick checks again
                from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

                SCAN_STATS.record_degradation("fleet_monitor_error", error=str(e),
                                              kind_of_error=type(e).__name__)
                continue
