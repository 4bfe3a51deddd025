"""Scan executors — the run strategies behind ``run_scan`` (the port of
``deequ_tpu/ops/scan_executors.py``).

``ops/scan_engine.run_scan`` owns resolution (the switches, the deadlines,
the run budget, the breaker, the mesh's up-front quarantine) and then
hands the scan to one executor, chosen by :func:`classify`:

- ``"streaming"`` — one governed pass over a StreamingTable (no ladder: a
  half-read stream cannot rewind), under the tighter of the device and
  straggler deadlines over a mesh;
- ``"resident"`` — the fault ladder of an in-memory scan
  (:func:`run_laddered_scan`): on an OOM, eviction of residency, then
  encoded->decoded demotion, then chunk bisection; past them, or on any
  other device fault, a typed raise — or, under
  ``on_device_error="fallback"``, the refusal of the CPU rung
  (:func:`refuse_cpu_rung`), where the reference re-runs the scan on its
  CPU backend. Over a mesh of two or more members the mesh rungs arm
  themselves, as in the reference: a fault that names members reshards
  the scan onto the survivors (``mesh_reshard``, charged to the run
  budget) before any refusal, an OOM that names its card does so once
  the bisection reached its floor, and a hang under the straggler
  deadline is a ``mesh_straggler``. With no member left the port's rule
  holds: a typed raise or ``DeviceFallbackRefusedException``, never the
  CPU.

Every rung
re-enters ``scan_engine._run_scan_once``, which plans the attempt anew
(residency, layout, chunk rows) and starts a fresh fold, and every retry
charges the run budget before it is spent. The serving and windowed
executors come with serving.

Engine internals are reached through the module (``_engine()``), never
imported by name, so a test's monkeypatch of ``scan_engine`` reaches the
executors.
"""

from __future__ import annotations

import contextlib
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from deequ_tpu_torch.exceptions import (
    DeviceException,
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceOOMException,
)
from deequ_tpu_torch.obs.recorder import current_recorder


def _engine():
    from deequ_tpu_torch.ops import scan_engine

    return scan_engine


def classify(table) -> str:
    """Which run strategy a scan of ``table`` takes."""
    return "streaming" if getattr(table, "is_streaming", False) else "resident"


def _attempt_deadline(device_deadline: Optional[float], shard_deadline: Optional[float],
                      n_dev: int) -> Optional[float]:
    """The watchdog of an attempt's device calls: over two or more members
    the tighter of the device and straggler deadlines."""
    if shard_deadline is None or n_dev <= 1:
        return device_deadline
    return shard_deadline if device_deadline is None else min(device_deadline, shard_deadline)


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
    mesh=None,
    shard_deadline: Optional[float] = None,
):
    """One governed pass over a StreamingTable: the whole stream is one
    attempt, under one attempt-level watchdog when the run budget has a
    wall deadline. A stream cannot reshard (it does not rewind), but over a
    mesh the straggler deadline arms its device calls too, so a stalled
    member becomes a typed DeviceHangException, never a frozen run."""
    eng = _engine()
    if defer:
        raise ValueError("run_scan(defer=True) takes an in-memory table")
    deadline = _attempt_deadline(device_deadline, shard_deadline, eng.mesh_size(mesh))
    rec = current_recorder()
    with (rec.span("scan_attempt", scan_id=scan_id, attempt=0, stream=True)
          if rec is not None else contextlib.nullcontext()):
        return eng._governed_attempt(
            budget,
            lambda: eng._run_scan_stream(table, ops, device, chunk_rows, encoded_ingest,
                                         scan_id=scan_id, device_deadline=deadline, mesh=mesh),
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
    eng.SCAN_STATS.bump(fallback_refused=1)
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
    mesh=None,
    shard_deadline: Optional[float] = None,
):
    """The in-memory fault ladder, on one device or over a mesh (module
    doc). Each attempt runs under the run budget's watchdog
    (``_governed_attempt``); a fault is handled after its ``except`` block
    has released the attempt: the frames of the exception chain are
    cleared, the residency evicted and the allocator's cache freed before
    the next attempt allocates. The rungs, in the reference's order: for
    an OOM, encoded demotion, then bisection (to a multiple of the mesh
    size), then a reshard when the OOM names members; for any other fault
    a reshard when it names members; then the refusal or the typed
    raise."""
    eng = _engine()
    rec = current_recorder()
    chunk_override = chunk_rows
    attempt = 0
    depth = 0
    while True:
        # one span an attempt: the boundary spans of its device calls nest
        # under it, and a rung taken below records its event inside the
        # attempt it degraded
        with (rec.span("scan_attempt", scan_id=scan_id, attempt=attempt)
              if rec is not None else contextlib.nullcontext()):
            if mesh is not None:
                device = mesh.lead
            n_dev = eng.mesh_size(mesh)
            floor = max(n_dev, min(eng.MIN_BISECT_CHUNK_ROWS, max(table.num_rows, 1)))
            straggler_armed = shard_deadline is not None and n_dev > 1
            deadline = _attempt_deadline(device_deadline, shard_deadline, n_dev)
            scan_ctx = {"scan_id": scan_id, "attempt": attempt,
                        "device_ids": eng.mesh_device_ids(mesh)}
            report: Dict[str, Any] = {}
            try:
                result = eng._governed_attempt(
                    budget,
                    lambda: eng._run_scan_once(
                        table, ops, device, chunk_override, defer, deadline,
                        scan_ctx, report, select_kernel=select_kernel, encoded=encoded_ingest,
                        mesh=mesh,
                    ),
                    f"scan {scan_id} attempt {attempt} (run budget)",
                    device,
                )
                eng.DEVICE_HEALTH.record_success()
                if n_dev > 1:
                    eng.MESH_HEALTH.record_success(eng.mesh_device_ids(mesh))
                return result
            except DeviceException as e:
                fault = e
            _release_frames(fault)
            eng.SCAN_STATS.bump(device_faults=1)

            def reshard() -> bool:
                """Shrink the mesh around the members ``fault`` names; True
                when a member survives and the scan should run again."""
                nonlocal mesh, chunk_override, depth
                mesh_ids = set(eng.mesh_device_ids(mesh))
                lost = [d for d in getattr(fault, "device_ids", ()) if d in mesh_ids]
                if not lost or len(mesh_ids) <= 1:
                    return False
                eng.SCAN_STATS.bump(mesh_faults=1)
                eng.MESH_HEALTH.record_fault(fault)
                shrunk = eng.mesh_excluding(mesh, set(lost) | set(eng.MESH_HEALTH.quarantined()))
                if shrunk is None:
                    return False
                if budget is not None:
                    budget.charge("mesh_reshard", scan_id=scan_id)
                # the residency is sharded over the old mesh, the lost
                # members included: it cannot serve the shrunken one
                freed = eng._evict_device_cache(table)
                eng.SCAN_STATS.bump(mesh_reshards=1)
                eng.SCAN_STATS.record_degradation(
                    "mesh_reshard", scan_id=scan_id, lost_devices=sorted(lost),
                    mesh_from=len(mesh_ids), mesh_to=shrunk.size, evicted_bytes=freed,
                    error=str(fault),
                )
                mesh = shrunk
                # the pressure that drove a bisection left with the member: the
                # survivors start again at the caller's chunk size
                chunk_override = chunk_rows
                depth = 0
                return True

            if isinstance(fault, DeviceOOMException):
                eng.DEVICE_HEALTH.record_fault(fault)
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
                    eng.SCAN_STATS.bump(encoded_demotions=1)
                    eng.SCAN_STATS.record_degradation(
                        "encoded_demote", scan_id=scan_id, chunk=used,
                        evicted_bytes=freed, error=str(fault),
                    )
                    attempt += 1
                    continue
                halved = max(floor, used // 2)
                halved = max(n_dev, halved // n_dev * n_dev)
                if halved < used:
                    if budget is not None:
                        budget.charge("oom_bisect", scan_id=scan_id)
                    depth += 1
                    eng.SCAN_STATS.bump(oom_bisections=1)
                    eng.SCAN_STATS.raise_to(bisection_depth=depth)
                    eng.SCAN_STATS.record_degradation(
                        "oom_bisect", scan_id=scan_id, chunk_from=used, chunk_to=halved,
                        depth=depth, evicted_bytes=freed, error=str(fault),
                    )
                    chunk_override = halved
                    attempt += 1
                    continue
                # at the floor an OOM that names one card sheds that member
                # before the mesh gives up
                if reshard():
                    attempt += 1
                    continue
                reason = "oom_at_bisection_floor"
                detail = {"chunk": used}
            else:
                if isinstance(fault, DeviceHangException):
                    eng.SCAN_STATS.bump(watchdog_timeouts=1)
                    # a straggler only when the straggler deadline was the one
                    # that bound: a tighter device deadline's hang is a plain
                    # watchdog timeout
                    if straggler_armed and (device_deadline is None
                                            or shard_deadline <= device_deadline):
                        eng.SCAN_STATS.bump(mesh_stragglers=1)
                        eng.SCAN_STATS.record_degradation(
                            "mesh_straggler", scan_id=scan_id, deadline=fault.deadline,
                            mesh_size=n_dev, error=str(fault),
                        )
                    else:
                        eng.SCAN_STATS.record_degradation(
                            "watchdog_timeout", scan_id=scan_id, deadline=fault.deadline,
                            error=str(fault),
                        )
                # a fault that names members costs those members, never the
                # mesh: the scan goes on over the survivors
                if reshard():
                    attempt += 1
                    continue
                # a lost device is sticky and a kernel that does not build stays
                # so: no rung retries them on the card; nor a hang
                eng.DEVICE_HEALTH.record_fault(fault)
                reason = type(fault).__name__
                detail = {}
            if on_device_error == "fallback":
                refuse_cpu_rung(table, scan_id, reason, fault, budget, **detail)
            raise fault
