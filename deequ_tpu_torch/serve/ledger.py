"""The durable request ledger — the fleet's record of accepted work,
persisted at accept time in the checksummed frame format (the counterpart
of ``deequ_tpu/serve/ledger.py``).

The fleet's assignments and the futures it resolves live in its process's
memory, so a dead host orphans every accepted request; ``PendingWork``
covers only a graceful ``stop(drain=False)``. The ledger closes that
hole: every acceptance appends one checksummed frame
(:func:`~deequ_tpu_torch.serve.transport.encode_frame`: the wire and the
disk hold the same bytes) to an append-only file, fsynced before the
submit returns its future, and every resolution appends a tombstone.
Accepted minus tombstoned is the work a dead fleet still owed; a fresh
fleet on the same directory re-dispatches it, onto the original futures
where the caller survived (the future's first-resolution gate keeps it
exactly once either way).

A record torn mid-append makes the file's tail unreadable, never its
head. ``mode="recover"`` moves only the torn bytes to a counter-suffixed
``.corrupt`` sidecar (a second recovery never overwrites the first's
evidence), truncates the file to its last whole frame and loads every
record before it; ``mode="raise"`` raises the typed
``CorruptStateException``. Frames are sequential: nothing after the first
tear is trusted.

Every record carries its writer's epoch (0 when unfenced). ``outstanding()``
reconciles duplicates across epochs — the highest epoch's record of an
accept id owns it; a ``reaccept`` restamps a record's epoch; a tombstone
settles whatever its epoch, a stale one counted — and ``max_epoch()`` is
the floor a fenced writer starts above. Each accept frame also carries the
fleet's quarantine snapshot, so a resumed fleet restores who was
quarantined along with what was queued.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.resilience.atomic import quarantine_path
from deequ_tpu_torch.serve.transport import dump_blob, encode_frame, load_blob, read_frame

#: the one append-only ledger file of a fleet's ledger_dir
LEDGER_FILENAME = "requests.dql"
#: torn tails recovered past are kept under this suffix, never deleted
CORRUPT_SUFFIX = ".corrupt"


class RequestLedger:
    """Append-only checksummed record of a fleet's accepted work (module
    doc). Appends are thread-safe (submit and resolve race from different
    threads); recovery runs once, at open."""

    def __init__(self, ledger_dir: str, mode: str = "recover"):
        if mode not in ("recover", "raise"):
            raise ValueError(f"mode must be 'recover' or 'raise', got {mode!r}")
        self.ledger_dir = ledger_dir
        self.path = os.path.join(ledger_dir, LEDGER_FILENAME)
        self.mode = mode
        self._lock = threading.Lock()
        self.records: List[dict] = []
        self.torn_tail_bytes = 0
        #: reconciliation counts, recomputed by each outstanding()
        self.cross_epoch_duplicates = 0
        self.cross_epoch_reaccepts = 0
        self.stale_tombstones = 0
        os.makedirs(ledger_dir, exist_ok=True)
        self._recover()
        # unbuffered: each frame goes down in one O_APPEND write, so two
        # live writers interleave whole frames, never halves
        self._handle = open(self.path, "ab", buffering=0)

    # -- recovery --------------------------------------------------------------

    def _recover(self) -> None:
        """Read every whole frame; the first damage is a torn tail,
        quarantined or raised by ``mode``."""
        if not os.path.exists(self.path):
            return
        records: List[dict] = []
        good_end = 0
        error: Optional[CorruptStateException] = None
        with open(self.path, "rb") as f:
            while True:
                try:
                    msg = read_frame(f, f"request ledger {LEDGER_FILENAME}")
                except CorruptStateException as e:
                    error = e
                    break
                if msg is None:
                    break
                records.append(msg)
                good_end = f.tell()
        self.records = records
        if error is None:
            return
        if self.mode == "raise":
            raise error
        # only the torn tail goes: its bytes to the sidecar, the file
        # truncated to its last whole frame
        self.torn_tail_bytes = os.path.getsize(self.path) - good_end
        with open(self.path, "rb") as f:
            f.seek(good_end)
            tail = f.read()
        with open(quarantine_path(None, self.path, CORRUPT_SUFFIX), "wb") as sidecar:
            sidecar.write(tail)
            sidecar.flush()
            os.fsync(sidecar.fileno())
        with open(self.path, "ab") as f:
            f.truncate(good_end)
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        SCAN_STATS.record_degradation("ledger_torn_tail", path=self.path,
                                      dropped_bytes=self.torn_tail_bytes, error=str(error))

    # -- appends ---------------------------------------------------------------

    def _append(self, record: dict) -> None:
        from deequ_tpu_torch.obs.registry import LEDGER_APPENDS

        frame = encode_frame(record)
        with self._lock:
            self._handle.write(frame)
            self._handle.flush()
            # append-only by protocol: an fsync a frame, and a torn tail
            # recovered at open (a rewrite a record would cost O(N))
            os.fsync(self._handle.fileno())
            self.records.append(record)
        LEDGER_APPENDS.inc()

    def append_accept(self, accept_id: str, *, tenant: Any, digest: str, slo_cls: str,
                      deadline_ms: Optional[float], weight: float,
                      deadline_left_s: Optional[float], work: Any,
                      quarantine: Optional[dict] = None, epoch: int = 0) -> None:
        """One accepted request, durable before its future is returned:
        ``work`` is (data, checks, required_analyzers), what a fresh fleet
        needs to re-dispatch it. ``deadline_left_s`` is the deadline left
        at accept (a monotonic stamp means nothing to another process);
        ``accepted_wall``, stamped here, lets a resume subtract the time
        spent dead. ``epoch`` is the writer's (0: unfenced)."""
        self._append({
            "kind": "accept",
            "id": accept_id,
            "epoch": int(epoch),
            "accepted_wall": time.time(),
            "tenant_blob": dump_blob(tenant),
            "digest": digest,
            "slo": {"cls": slo_cls, "deadline_ms": deadline_ms, "weight": weight},
            "deadline_left_s": deadline_left_s,
            "work_blob": dump_blob(work),
            "quarantine_blob": dump_blob(quarantine) if quarantine is not None else None,
        })

    def append_resolve(self, accept_id: str, epoch: int = 0) -> None:
        """The tombstone: the request resolved (a result or a typed
        rejection: nothing is owed). A stale-epoch tombstone still settles
        (the future's gate already fired) and is counted."""
        self._append({"kind": "resolve", "id": accept_id, "epoch": int(epoch)})

    def append_reaccept(self, accept_id: str, epoch: int) -> None:
        """A resuming writer's claim on one replayed accept: restamps the
        record's epoch without copying its blobs again."""
        self._append({"kind": "reaccept", "id": accept_id, "epoch": int(epoch)})

    # -- replay ----------------------------------------------------------------

    @staticmethod
    def _epoch_of(rec: Optional[dict]) -> int:
        return int((rec or {}).get("epoch") or 0)

    def outstanding(self) -> Dict[str, dict]:
        """Accepted minus tombstoned, in accept order (module doc for the
        reconciliation across epochs)."""
        out: Dict[str, dict] = {}
        self.cross_epoch_duplicates = 0
        self.cross_epoch_reaccepts = 0
        self.stale_tombstones = 0
        for rec in self.records:
            kind = rec.get("kind")
            if kind == "accept":
                prev = out.get(rec["id"])
                if prev is not None:
                    self.cross_epoch_duplicates += 1
                    if self._epoch_of(rec) < self._epoch_of(prev):
                        continue  # the stale duplicate loses
                out[rec["id"]] = rec
            elif kind == "reaccept":
                prev = out.get(rec.get("id"))
                if prev is not None and self._epoch_of(rec) > self._epoch_of(prev):
                    merged = dict(prev)
                    merged["epoch"] = self._epoch_of(rec)
                    out[rec["id"]] = merged
                    self.cross_epoch_reaccepts += 1
            elif kind == "resolve":
                popped = out.pop(rec.get("id"), None)
                if popped is not None and self._epoch_of(rec) < self._epoch_of(popped):
                    self.stale_tombstones += 1
        return out

    def max_epoch(self) -> int:
        """The highest epoch any record holds."""
        return max((self._epoch_of(r) for r in self.records), default=0)

    def latest_quarantine(self) -> Optional[dict]:
        """The newest quarantine snapshot an accept frame carried."""
        snap = None
        for rec in self.records:
            blob = rec.get("quarantine_blob")
            if rec.get("kind") == "accept" and blob is not None:
                snap = blob
        return load_blob(snap, "ledger quarantine") if snap else None

    @staticmethod
    def load_work(rec: dict) -> Tuple[Any, tuple, tuple]:
        """One accept record's (data, checks, required_analyzers)."""
        return load_blob(rec["work_blob"], "ledger work record")

    @staticmethod
    def load_tenant(rec: dict) -> Any:
        return load_blob(rec["tenant_blob"], "ledger tenant field")

    def close(self) -> None:
        with self._lock:
            try:
                self._handle.close()
            except OSError:
                pass
