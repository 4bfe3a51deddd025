"""The coalesced executor — K tenants' suites, one copy, one K1 batch, one
fold merge and one fetch (the counterpart of ``deequ_tpu/serve/executor.py``).

:func:`run_coalesced` takes K members of one ServePlan (one schema, one
analyzer set, one packer layout and one row count) and runs them as one
dispatch on the group scan's construction (``ops/scan_engine.py``):

- every member's planes (and op lookup tables) are packed into ONE host
  buffer, each member in an aligned slot of its own, and copied to the
  device once (``_GroupBuffer``; the ``coalesce_assembly`` span);
- each member's ops run on views of its slot — the shapes its own serial
  scan gives it — and the K members' K1 tasks resolve in ONE
  ``masked_reduce.reduce_into`` call, member k's outputs at their offsets
  in row k of the output, and fold with the identities in ONE
  ``merge_tags`` over the K rows, the masks and source indices tiled K
  times (``_group_rows``). K1's bits depend only on a task's rows and
  ``n``, never on its place in the batch, so each member is bit for bit
  its serial ``VerificationSuite.run``, whatever K and its row;
- the (K, S) output is fetched ONCE and unflattened a member.

The ops that are not K1 (HLL registers, string lookups, DataType,
patterns, KLL sorts) run a member, as in the group scan.

The tenant axis is not padded. The reference pads it to a power of two to
bound XLA's count of compiled programs; a launch here compiles nothing,
so a padding slice would be pure waste, and ``coalesce_padded_slots``
stays 0. A *program* (``serve/plan_cache.py``) is built once a plan and
device: the ops with their kernels chosen, in canonical order, and the
fold plan whose index tensors live on the device.

Threads: a fleet's workers run batches side by side, and plans (with
their programs) travel between workers by reference. A program is built
under :data:`_PROGRAM_LOCK` (host work only: the plan and its kernel
choices), so a plan and device build one; its fold is built by the first
batch outside that lock and published only if none was, so the program
lock is held across no launch and no fetch. The census counters this module bumps go
through ``ScanStats.bump``, under the stats' lock.

A batch packs, copies and steps while it holds its device's turn
(:func:`_device_turn`), and fetches after giving it back. Every torch call
releases the GIL for its few microseconds, so workers that step at once on
one card hand the GIL back and forth at every op, each hand-off an OS
thread switch; in turns, one worker steps while the others wait on the
turn or on their fetches, and a worker's host work still overlaps the
card's work for the others.

Fault seams: the copy, the step and the fetch are device boundaries
(``device_call``: classification, the watchdog, the fault hook at the
execute boundary, whose context carries ``"coalesced": K`` and the
members' labels); a classified fault raises out to the service, which
bisects the batch when the port's ladder would retry the fault.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deequ_tpu_torch.obs.recorder import current_recorder
from deequ_tpu_torch.ops.device_policy import default_device_deadline, device_call
from deequ_tpu_torch.ops.scan_engine import (
    _SCAN_IDS,
    SCAN_STATS,
    _ChunkPacker,
    _group_rows,
    _GroupBuffer,
    fetch,
)
from deequ_tpu_torch.ops.scan_plan import plan_packed_scan


@dataclass
class _Program:
    """A plan's program on a device (``serve/plan_cache.py``): the packed
    plan (the ops in canonical order, kernels chosen) and the fold plan,
    built by the first batch that runs it."""

    plan_ir: Any
    fold: Any = None


#: serialises the build of a program (module doc)
_PROGRAM_LOCK = threading.Lock()
#: one turn a device (module doc), by ``str(device)``
_DEVICE_TURNS: Dict[str, threading.Lock] = {}


def _device_turn(device) -> threading.Lock:
    """The lock a batch holds on ``device`` from packing to its step
    (``dict.setdefault`` is atomic: every caller gets the one kept)."""
    return _DEVICE_TURNS.setdefault(str(device), threading.Lock())


def _member_packer(plan, table, encode: bool) -> _ChunkPacker:
    """A packer of one member's needed columns."""
    return _ChunkPacker({n: table[n] for n in plan.needed}, encode=encode)


def _program(plan, device, platform: str, packer) -> tuple:
    """(program, perm, built, shared): the plan's program on ``device`` —
    its own, a shared one (``SUBPLAN_CACHE``) adopted with its permutation,
    or a new one — whether this batch builds it, and whether another plan
    key built it. The census counts batches (``programs_built`` /
    ``programs_reused``)."""
    from deequ_tpu_torch.serve.plan_cache import SUBPLAN_CACHE, canonical_op_order, subplan_key

    cached = plan.program_for(device)
    if cached is None:
        with _PROGRAM_LOCK:
            # looked up again under the lock: another worker may have built
            # it since
            cached = plan.program_for(device)
            if cached is None:
                canon, perm = canonical_op_order(plan)
                plan_ir = plan_packed_scan([plan.exec_ops[i] for i in canon], packer,
                                           chunk_rows=plan.key.chunk, platform=platform)
                key = subplan_key(plan, canon, device, plan_ir.variant, plan_ir.hist_variant,
                                  "encoded" if plan_ir.encoded_columns else "decoded")
                shared = SUBPLAN_CACHE.get(key)
                if shared is not None:
                    plan.put_program(device, (shared, perm))
                    SCAN_STATS.bump(programs_reused=1)
                    return shared, perm, False, True
                program = _Program(plan_ir)
                plan.put_program(device, (program, perm))
                SUBPLAN_CACHE.put(key, program)
                SCAN_STATS.bump(programs_built=1)
                return program, perm, True, False
    SCAN_STATS.bump(programs_reused=1)
    return cached[0], cached[1], False, False


def run_coalesced(
    plan,
    tables: Sequence,
    labels: Sequence[str],
    device,
    device_deadline: Optional[float] = None,
    attempt: int = 0,
    packers: Sequence = (),
    encode: bool = True,
) -> List[List[Dict[str, np.ndarray]]]:
    """Run K member tables of ``plan`` as ONE dispatch and ONE fetch on
    ``device`` (module doc). Returns each member's scan results (per exec
    op, in the plan's exec order: what ``run_scan`` returns for its table
    alone). ``packers``: each member's packer from admission (its layout
    already matched the plan key), None to pack afresh. Raises a typed
    ``Device*Exception`` at the transfer, execute or fetch boundary.

    Census: a batch whose program was built counts its K members as
    ``plan_cache_misses``, one that found it as ``plan_cache_hits`` (and
    ``subplan_cache_hits`` when another plan key built it)."""
    K = len(tables)
    if K == 0 or K != len(labels):
        raise ValueError("run_coalesced needs one label a member and at least one member")
    device = torch.device(device)
    if device_deadline is None:
        device_deadline = default_device_deadline()
    n = plan.key.chunk
    packers = [packers[k] if k < len(packers) and packers[k] is not None
               else _member_packer(plan, t, encode) for k, t in enumerate(tables)]
    program, perm, built, shared = _program(plan, device, device.type, packers[0])
    ops = program.plan_ir.ops
    if built:
        SCAN_STATS.bump(plan_cache_misses=K)
    else:
        SCAN_STATS.bump(plan_cache_hits=K)
        if shared:
            SCAN_STATS.record_subplan_hit(K)

    with _device_turn(device):
        # the batch's host work that grows with K: pack every member into one
        # buffer, its slot the shape its own scan packs
        rec = current_recorder()
        with (rec.span("coalesce_assembly", tenants=K) if rec is not None
              else contextlib.nullcontext()):
            buffer = _GroupBuffer(packers, n, ops, tables)
        SCAN_STATS.bump(bytes_packed=buffer.host.nbytes)
        device_call(lambda: buffer.to_device(device), "transfer",
                    what=f"coalesced transfer (K={K})", deadline=device_deadline, device=device)

        # the kernel census a member, as its serial scan counts it
        SCAN_STATS.bump(scan_passes=1, rows_scanned=K * n, coalesced_batches=1,
                        coalesced_tenants=K, device_sort_passes=program.plan_ir.sort_ops * K,
                        encoded_scan_passes=int(bool(program.plan_ir.encoded_columns)))

        # one scan id a coalesced dispatch: the fault hook scripts by scan id,
        # and a bisected retry is a fresh dispatch with ``attempt`` its depth
        hook_ctx = {"scan_id": next(_SCAN_IDS), "attempt": attempt, "chunk_index": 0,
                    "device_ids": (), "coalesced": K,
                    "tenants": tuple(str(label) for label in labels)}
        needed = list(plan.needed)

        def step():
            out, fold = _group_rows(buffer, packers, ops, needed, n, device, program.fold,
                                    caller="coalesced")
            if program.fold is None:
                with _PROGRAM_LOCK:
                    if program.fold is None:
                        program.fold = fold
            return out, fold

        t_d = time.perf_counter()
        out, fold = device_call(step, "execute", what=f"coalesced dispatch (K={K})",
                                deadline=device_deadline, hook_ctx=hook_ctx, device=device)
        SCAN_STATS.bump(dispatch_seconds=time.perf_counter() - t_d)
    t_f = time.perf_counter()
    (host,) = device_call(lambda: fetch(out), "fetch", what="coalesced drain",
                          deadline=device_deadline, device=device)
    SCAN_STATS.bump(drain_wait_seconds=time.perf_counter() - t_f)
    results = []
    for k in range(K):
        canonical = fold.unflatten(host[k], 1)
        results.append([canonical[perm[i]] for i in range(len(canonical))])
    return results
