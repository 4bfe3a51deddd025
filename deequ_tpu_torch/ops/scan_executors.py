"""Scan executors — the run strategies behind ``run_scan`` (the port of
``deequ_tpu/ops/scan_executors.py`` for one device).

``ops/scan_engine.run_scan`` owns resolution (the switches, the deadline,
the run budget, the breaker) and then hands the scan to one executor,
chosen by :func:`classify`:

- ``"streaming"`` — one governed pass over a StreamingTable (no ladder: a
  half-read stream cannot rewind);
- ``"resident"`` — the fault ladder of an in-memory scan on one device:
  on an OOM, eviction of residency, then encoded->decoded demotion, then
  chunk bisection; past them, or on any other device fault, a typed raise
  — or, under ``on_device_error="fallback"``, the refusal of the CPU rung
  (:func:`refuse_cpu_rung`), where the reference re-runs the scan on its
  CPU backend.

Every rung re-enters ``scan_engine._run_scan_once``, which plans the
attempt anew (residency, layout, chunk rows) and starts a fresh fold, and
every retry charges the run budget before it is spent. The mesh rungs
(reshard, straggler) come with the multi-card mesh; the serving and
windowed executors with serving.

Engine internals are reached through the module (``_engine()``), never
imported by name, so a test's monkeypatch of ``scan_engine`` reaches the
executors.
"""

from __future__ import annotations

import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from deequ_tpu_torch.exceptions import (
    DeviceException,
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceOOMException,
)


def _engine():
    from deequ_tpu_torch.ops import scan_engine

    return scan_engine


def classify(table) -> str:
    """Which run strategy a scan of ``table`` takes."""
    return "streaming" if getattr(table, "is_streaming", False) else "resident"


def run_streaming_scan(
    table,
    ops: Sequence,
    *,
    device: torch.device,
    chunk_rows: Optional[int],
    defer: bool,
    device_deadline: Optional[float],
    encoded_ingest: bool,
    budget,
    scan_id: int,
):
    """One governed pass over a StreamingTable: the whole stream is one
    attempt, under one attempt-level watchdog when the run budget has a
    wall deadline."""
    eng = _engine()
    if defer:
        raise ValueError("run_scan(defer=True) takes an in-memory table")
    return eng._governed_attempt(
        budget,
        lambda: eng._run_scan_stream(table, ops, device, chunk_rows, encoded_ingest,
                                     scan_id=scan_id, device_deadline=device_deadline),
        f"stream scan {scan_id} (run budget)",
        device,
    )


def _release_frames(exc: BaseException) -> None:
    """Release what an exception chain keeps of a failed attempt. Its
    tracebacks hold the attempt's frames, and a frame holds its locals and
    its function — a closure over the attempt's fold, planes and unpacked
    values: a retry made while they live would meet the same OOM at every
    chunk size. So the chain's text is kept on ``exc`` (a note where the
    Python has ``add_note``, and ``released_attempt`` everywhere) and every
    traceback of the chain is cleared and dropped."""
    chain, seen = [], set()
    link = exc
    while link is not None and id(link) not in seen:
        seen.add(id(link))
        chain.append(link)
        link = link.__cause__ or link.__context__
    text = "".join(traceback.format_exception(exc)).rstrip()
    for link in chain:
        traceback.clear_frames(link.__traceback__)
        link.__traceback__ = None
    exc.released_attempt = text
    if hasattr(exc, "add_note"):  # Python 3.11 on
        exc.add_note("the failed attempt, released before the next rung:\n" + text)


def refuse_cpu_rung(table, scan_id: int, reason: str, cause: Optional[BaseException],
                    budget, **detail) -> None:
    """The port's CPU rung: where the reference re-runs a scan on its CPU
    backend, charge the run budget (``cpu_fallback_refused``; an exhausted
    budget raises its own typed exception instead), drop the table's
    residency on the card that failed, record a ``cpu_fallback_refused``
    event, count ``fallback_refused`` and raise
    DeviceFallbackRefusedException from ``cause``. Nothing runs on the
    CPU."""
    eng = _engine()
    if budget is not None:
        budget.charge("cpu_fallback_refused", scan_id=scan_id)
    eng._evict_device_cache(table)
    error = "" if cause is None else str(cause)
    eng.SCAN_STATS.fallback_refused += 1
    eng.SCAN_STATS.record_degradation(
        "cpu_fallback_refused", scan_id=scan_id, reason=reason, error=error, **detail,
    )
    refused = DeviceFallbackRefusedException(
        f"scan {scan_id}: on_device_error='fallback' reached the CPU rung ({reason}); "
        "the port does not run a CUDA scan on the CPU"
        + (f" — cause: {error}" if error else ""),
        boundary=getattr(cause, "boundary", "execute"),
        reason=reason,
    )
    raise refused from cause


def run_laddered_scan(
    table,
    ops: Sequence,
    *,
    device: torch.device,
    chunk_rows: Optional[int],
    defer: bool,
    on_device_error: str,
    device_deadline: Optional[float],
    select_kernel: bool,
    encoded_ingest: bool,
    budget,
    scan_id: int,
):
    """The in-memory fault ladder on one device (module doc). Each attempt
    runs under the run budget's watchdog (``_governed_attempt``); a fault
    is handled after its ``except`` block has released the attempt: the
    frames of the exception chain are cleared, the residency evicted and
    the allocator's cache freed before the next attempt allocates."""
    eng = _engine()
    chunk_override = chunk_rows
    attempt = 0
    depth = 0
    while True:
        floor = min(eng.MIN_BISECT_CHUNK_ROWS, max(table.num_rows, 1))
        scan_ctx = {"scan_id": scan_id, "attempt": attempt}
        report: Dict[str, Any] = {}
        try:
            result = eng._governed_attempt(
                budget,
                lambda: eng._run_scan_once(
                    table, ops, device, chunk_override, defer, device_deadline,
                    scan_ctx, report, select_kernel=select_kernel, encoded=encoded_ingest,
                ),
                f"scan {scan_id} attempt {attempt} (run budget)",
                device,
            )
            eng.DEVICE_HEALTH.record_success()
            return result
        except DeviceException as e:
            fault = e
        _release_frames(fault)
        eng.SCAN_STATS.device_faults += 1
        eng.DEVICE_HEALTH.record_fault(fault)
        if isinstance(fault, DeviceOOMException):
            used = int(report.get("chunk") or chunk_override or max(table.num_rows, 1))
            freed = eng._evict_device_cache(table)
            if device.type == "cuda":
                torch.cuda.empty_cache()  # the freed blocks back to the card
            # encoded -> decoded first, at the same chunk: the decode
            # gathers and dictionary tables are allocations the decoded
            # layout does not make; an OOM there bisects as before
            if encoded_ingest and report.get("encoded"):
                if budget is not None:
                    budget.charge("encoded_demote", scan_id=scan_id)
                encoded_ingest = False
                eng.SCAN_STATS.encoded_demotions += 1
                eng.SCAN_STATS.record_degradation(
                    "encoded_demote", scan_id=scan_id, chunk=used,
                    evicted_bytes=freed, error=str(fault),
                )
                attempt += 1
                continue
            halved = max(floor, used // 2)
            if halved < used:
                if budget is not None:
                    budget.charge("oom_bisect", scan_id=scan_id)
                depth += 1
                eng.SCAN_STATS.oom_bisections += 1
                eng.SCAN_STATS.bisection_depth = max(eng.SCAN_STATS.bisection_depth, depth)
                eng.SCAN_STATS.record_degradation(
                    "oom_bisect", scan_id=scan_id, chunk_from=used, chunk_to=halved,
                    depth=depth, evicted_bytes=freed, error=str(fault),
                )
                chunk_override = halved
                attempt += 1
                continue
            reason = "oom_at_bisection_floor"
            detail = {"chunk": used}
        else:
            # a lost device is sticky and a kernel that does not build stays
            # so: no rung retries them on the card; nor a hang
            if isinstance(fault, DeviceHangException):
                eng.SCAN_STATS.watchdog_timeouts += 1
                eng.SCAN_STATS.record_degradation(
                    "watchdog_timeout", scan_id=scan_id, deadline=fault.deadline,
                    error=str(fault),
                )
            reason = type(fault).__name__
            detail = {}
        if on_device_error == "fallback":
            refuse_cpu_rung(table, scan_id, reason, fault, budget, **detail)
        raise fault
