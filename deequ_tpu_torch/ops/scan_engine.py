"""The fused scan, on one device or row-sharded over a mesh — the
counterpart of ``deequ_tpu/ops/scan_engine.py:run_scan``.

One pass over the table runs every scan-shareable analyzer of a run:

- the table is cut into chunks by the reference's rule (``_auto_chunk_rows``);
- ``_ChunkPacker`` packs each chunk into one f64 value plane, one
  validity-mask plane and one string-code plane, and moves each plane to
  the card in one copy;
- one step per chunk evaluates every op's ``update`` on those tensors; an
  op's masked reductions come back as K1 tasks
  (``ops/masked_reduce.py``), which the engine resolves together, one
  kernel batch a chunk on a card, into the chunk's flat state vector;
- ``_DeviceFoldPlan`` folds the chunk partials on the device by tag —
  ``sum``/``min``/``max`` elementwise in chunk order, ``gather`` leaves
  (Welford moments) appended per chunk — and the scan fetches the whole
  folded state ONCE (``ScanStats.device_fetches``).

A table ``persist()``-ed on the scan's device (``persist_table``) is
packed and copied once, into larger chunks (``DeviceTableCache``); a scan
of it walks the resident chunks with the same step and fold, and its KLL
summaries take the radix select (``ops/scan_plan.py``,
``ops/select_device.py``) instead of the sort. A dictionary-encoded
numeric column (``Column.encoding``) rides an int16 code plane, streamed
or resident, and decodes on the device with one gather of its dictionary.

A :class:`~deequ_tpu_torch.data.streaming.StreamingTable` — a table read
a batch at a time from a source, never held whole — takes the streaming
route (:func:`_run_scan_stream`): a reader thread decodes batches behind
a bounded queue (:func:`_prefetch`), each batch is cut into chunks and
packed as it comes, each chunk's copy to the card is issued from a
pinned, double-buffered staging slot on a copy stream of its own before
the previous chunk's step is queued on the compute stream, and the fold holds a fixed number of chunks' gather leaves
(:data:`STREAM_FOLD_CAPACITY`), draining them to the host when full and
compacting KLL summaries there; a stream of monoid ops fetches once.

Arriving batches of an incremental stream (``analyzers/incremental.py``)
scan in groups (:func:`run_scan_group`): equal-size one-chunk batches of
one packer layout are packed into one host buffer, copied to the card
once, scanned batch by batch on views of that copy, and fetched once a
group — each batch's results bit for bit those of its own ``run_scan``.

Every scan resolves its switches, deadline and run budget once
(:func:`run_scan`) and runs under an executor of ``ops/scan_executors.py``:
an in-memory scan's attempts (:func:`_run_scan_once`) climb the device
fault ladder — eviction, encoded->decoded demotion, chunk bisection, a
mesh reshard, then a typed raise or the refused CPU rung — each chunk's
transfer and step and the fetch a device boundary
(``ops/device_policy.py:device_call``: classification, the watchdog, the
fault hook).

Over a mesh (``parallel/mesh.py``) every scan is row-sharded as the
reference's: the chunk rounds up to a multiple of the n members, each
member holds ``local_n = chunk / n`` rows of it (members past the chunk's
last row hold fewer, or none: the rows that would pad it exist nowhere),
and its step runs on its own device with ``capacity = local_n``. Each
member's flat vector is copied to the lead, and the chunk's vectors fold
there (:func:`mesh_merge`, K8: sum, min and max in member order by
``k1_merge``, then into the chunk fold; gather leaves member-major, as
``all_gather`` lays them out). A table persisted over a mesh holds each
member's rows of each chunk on that member's device.

The card has native f64, so the port computes in f64 and carries no
counterpart of the reference's (hi, lo) f32 pairs; ``ops/masked_reduce.py``
is the counterpart of ``ops/df32.py``'s reductions.
Moments are per-chunk (count, mean, M2) combined with the Chan merge by
the analyzers' states, never a raw sum of squares.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.data.table import Column, DType
from deequ_tpu_torch.exceptions import device_boundary
from deequ_tpu_torch.ops.device_policy import (  # noqa: F401 — the engine's fault seam
    DEVICE_HEALTH,
    MESH_HEALTH,
    call_with_deadline,
    check_not_abandoned,
    current_watchdog_call_abandoned,
    default_device_deadline,
    default_shard_deadline,
    device_call,
    install_scan_fault_hook,
)
from deequ_tpu_torch.expr.eval import Val
from deequ_tpu_torch.obs.recorder import current_recorder, recording_scope
from deequ_tpu_torch.ops import masked_reduce
from deequ_tpu_torch.ops.lut_cache import dictionary_lut_device
from deequ_tpu_torch.ops.scan_plan import encoded_ingest_enabled, plan_scan_ops
from deequ_tpu_torch.parallel.mesh import (  # noqa: F401 — the executors' mesh seam
    _UNSET,
    Mesh,
    mesh_device_ids,
    mesh_excluding,
    mesh_size,
    round_chunk,
    scoped_mesh,
    shard_bounds,
)

DEFAULT_CHUNK_BYTES = 512 << 20
MAX_CHUNK_ROWS = 1 << 23

# resident chunks are larger (the reference's persist_table rule): a chunk
# costs a step of launches, and the device holds the whole table anyway
RESIDENT_CHUNK_BYTES = 2 << 30
RESIDENT_MAX_CHUNK_ROWS = 1 << 25

#: the share of a card's memory that persisted tables may hold together;
#: the rest is the scans' working set (a batched KLL summary of 50 columns
#: of a 2 GiB resident chunk peaks near 11 GB)
RESIDENT_FRACTION = 0.5

#: streaming chunks are smaller than in-memory ones: several copies of a
#: chunk live at once (the decoded batch in the reader's queue, the packed
#: staging slots, the chunk on the card), so host memory stays a few
#: chunks' worth (the reference's rule, so both packages cut a stream alike)
STREAM_CHUNK_BYTES = 128 << 20

#: the chunks of gather leaves a stream's device fold holds (a stream's
#: chunk count is unknown up front); when full they drain to the host in
#: one fetch and the fold goes on — the elementwise accumulator never
#: drains, so sums, minima and maxima fold in chunk order on the card
STREAM_FOLD_CAPACITY = 512

#: fold tags a ScanOp leaf may carry
FOLD_TAGS = ("sum", "min", "max", "gather")


def _chunk_bounds(num_rows: int, chunk: int) -> List[Tuple[int, int]]:
    """(start, stop) of each chunk; an empty table is one empty chunk."""
    return [
        (start, min(start + chunk, num_rows))
        for start in range(0, max(num_rows, 1), chunk)
    ]


def _auto_chunk_rows(
    cols: Dict[str, Column],
    target_bytes: int = DEFAULT_CHUNK_BYTES,
    max_rows: int = MAX_CHUNK_ROWS,
) -> int:
    """The reference's chunking rule (scan_engine.py:_auto_chunk_rows_from_dtypes),
    kept as it is so both packages cut a table at the same rows: the
    per-chunk Welford moments then partition identically."""
    bytes_per_row = 0
    for col in cols.values():
        if col.dtype == DType.STRING:
            bytes_per_row += 4
        elif col.dtype == DType.FRACTIONAL:
            bytes_per_row += 9
        else:
            bytes_per_row += 5
    bytes_per_row = max(bytes_per_row, 1)
    rows = target_bytes // bytes_per_row
    return int(min(max(rows, 1 << 18), max_rows))


@dataclass
class ScanOp:
    """One analyzer's contribution to the fused scan.

    ``update(vals, row_valid, n, capacity)`` maps one chunk's column Vals
    (device tensors), its row-validity mask, its row count and the scan's
    chunk capacity (the rows of every chunk but a shorter last one: what
    fixes a partial's static width) to a dict of partial-state leaves: a
    tensor, a K1 task (``masked_reduce.Reduction``) or one output of one,
    or a list of task outputs (a vector), which the engine resolves once a
    chunk; ``tags`` names each leaf's fold tag (:data:`FOLD_TAGS`).

    ``luts``: ``(column, key, build)`` host lookup tables over a string
    column's dictionary, built and moved to the device once per dictionary
    (``ops/lut_cache.py``: ``key`` names the derivation) and read in
    ``update`` as ``vals[column].lut(key)``. ``batch_hint``: ops
    with the same hint kind and parameters may be coalesced into one
    batched op by the runner (``("kll", sketch_size, column)``).

    ``sorts_chunk``: ``update`` sorts each chunk on the device (the KLL
    summary); ``select_update``: the same partials by the radix select,
    which a resident scan runs instead where the select is the faster
    (``ops/scan_plan.py``), ``select_size`` its sketch size and
    ``hist_widths`` the bins of its select's histogram passes (the input
    of the plan's histogram variant).

    ``compact``: a host compaction of the op's gathered leaves (a dict of
    them, returned with the same keys and trailing shapes, fewer rows),
    which a stream applies where a drain of its fold leaves more than
    ``compact_threshold`` values in one gather leaf (the KLL summaries:
    ``analyzers/sketches.py:_make_kll_compact``)."""

    columns: Tuple[str, ...]
    update: Callable[[Dict[str, Val], torch.Tensor, int, int], Dict[str, Any]]
    tags: Dict[str, str]
    luts: Tuple[Tuple[str, str, Callable], ...] = ()
    batch_hint: Optional[Tuple] = None
    sorts_chunk: bool = False
    select_update: Optional[Callable] = None
    select_size: int = 0
    hist_widths: Tuple[int, ...] = ()
    compact: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None
    compact_threshold: int = 1 << 20


#: the tallies open in this context (:meth:`ScanStats.tally`), innermost
#: last
_TALLIES: contextvars.ContextVar[Tuple["RunTally", ...]] = contextvars.ContextVar(
    "deequ_torch_scan_tallies", default=())


class RunTally:
    """What one context added to :data:`SCAN_STATS` while the tally was
    open: counter deltas by name, degradation events and unverified row
    ranges. A watchdog call runs in a copy of its caller's context, so its
    counts land here; another thread's (a fleet's other workers) do not."""

    __slots__ = ("counts", "events", "unverified")

    def __init__(self):
        self.counts: Dict[str, Any] = {}
        self.events: List[Dict[str, Any]] = []
        self.unverified: List[Tuple[int, int]] = []


class ScanStats:
    """Execution-report counters (the reference's ScanStats, the subset the
    port's slice touches): fused passes, rows scanned, device->host
    fetches and their bytes, grouping passes, device sorts, and the
    histogram census by route — ``hist_kernel_dispatches`` counts
    grouping counts that ran a CUDA kernel (a resident string count:
    one a chunk), ``hist_plain_dispatches`` those that ran a plain
    version on a CPU tensor, ``hist_host_dispatches`` those of tables
    small enough for ``np.bincount`` on the host
    (``segment.host_group_limit()``) — and by variant (the reference's):
    ``hist_scatter_dispatches``, ``hist_onehot_dispatches`` and
    ``hist_pallas_dispatches`` count the device dispatches under the
    variant each resolved (``device_policy.resolve_hist_variant``): the
    grouping counts, and the histogram passes of a select plan's plain
    version (on a card K4 counts its passes inside its kernel, so none is
    dispatched there). ``fused_group_passes`` counts the
    grouping passes that rode a fused dispatch
    (``segment.fused_group_counts``: a group of K sets counts K here and
    one histogram dispatch); each is a grouping pass too.

    Residency (the reference's meanings): ``resident_passes`` scans that
    walked a persisted table, ``bytes_resident`` the resident bytes they
    read (``bytes_packed`` counts only host packing),
    ``encoded_scan_passes`` scans whose layout had an int16 code plane;
    ``device_sort_passes`` chunk sorts (a sorting KLL op a chunk, plus
    the grouping sorts of ``ops/segment.py``) and
    ``device_select_passes`` KLL ops a chunk that ran the radix select
    instead.

    Streams: ``chunks_staged`` and ``bytes_staged`` count the chunks a
    streaming scan copied to the device and their plane bytes;
    ``ingest_overlap_frac`` is the share of them whose copy was issued
    while the previous chunk was still staged and not yet scanned — the
    double buffer's issue order, (n - 1) / n for n chunks by construction
    and 0 for one; whether the card really copied while it computed shows
    only in a trace of the copy and compute streams; ``fold_drains``
    counts the fold's gather drains to the host before a stream's end,
    ``kll_compactions`` the host compactions of gathered KLL summaries
    (one an op and drain, the stream's end included) and
    ``kll_midscan_compactions`` those made at a drain before the end.

    Spill (``spill/``, the reference's meanings): ``spill_runs`` sorted
    runs written, ``spill_bytes_written`` / ``spill_bytes_read`` their
    bytes to and from disk, ``spill_merge_passes`` the merge cascade's
    disk passes, ``peak_group_state_bytes`` the largest in-memory
    grouping tail a spill store held (what a group memory budget bounds).
    ``deferred_fetches`` counts the fetches of :func:`fetch_deferred`,
    each draining the deferred scans of a resilient stream's batches
    since the last checkpoint boundary.

    Device faults (``ops/scan_executors.py``, the reference's meanings):
    ``device_faults`` classified faults a scan attempt met,
    ``oom_bisections`` OOM-driven chunk halvings and ``bisection_depth``
    the deepest any scan needed, ``encoded_demotions`` encoded attempts
    moved to the decoded layout, ``watchdog_timeouts`` hung calls the
    watchdog converted, ``fallback_refused`` scans that reached the
    reference's CPU rung and were refused (where the reference counts
    ``fallback_scans``), ``degradation_events`` one dict a rung taken
    (:meth:`record_degradation`) and ``unverified_row_ranges`` the
    [start, stop) rows a degraded run finished without verifying
    (:meth:`record_unverified`). Run governance: ``budget_charges``
    attempts charged to a run budget, ``budget_exhaustions`` budgets that
    ran out.

    Meshes (the reference's meanings): ``mesh_faults`` faults that named
    mesh members, ``mesh_reshards`` meshes rebuilt over the survivors,
    ``mesh_stragglers`` hangs under the straggler deadline,
    ``peer_losses`` peer processes a multi-process check lost;
    ``member_launches`` counts each member's kernel launches by kernel
    ({member id: {"K1": n, "K2": n, "K4": n, "K5": n, "K6": n, "K7": n}}), the
    launches made inside that member's step or count.

    Serving (``serve/``, the reference's meanings): ``plan_cache_hits`` /
    ``plan_cache_misses`` count suites whose coalesced batch found or built
    its program, ``programs_built`` / ``programs_reused`` the batches that
    built or reused one, ``subplan_cache_hits`` the suites served from a
    program another plan key built; ``coalesced_batches`` and
    ``coalesced_tenants`` the coalesced dispatches and their members;
    ``coalesce_padded_slots`` stays 0 (the port pads no tenant axis).
    ``dispatch_seconds`` and ``drain_wait_seconds`` are the host's wall at
    the execute and fetch boundaries of in-memory and coalesced scans."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.scan_passes = 0
        self.chunks_processed = 0
        self.rows_scanned = 0
        self.bytes_packed = 0
        self.grouping_passes = 0
        self.device_sort_passes = 0
        self.device_select_passes = 0
        self.resident_passes = 0
        self.bytes_resident = 0
        self.encoded_scan_passes = 0
        self.device_fetches = 0
        self.bytes_fetched = 0
        self.hist_kernel_dispatches = 0
        self.hist_plain_dispatches = 0
        self.hist_host_dispatches = 0
        self.hist_scatter_dispatches = 0
        self.hist_onehot_dispatches = 0
        self.hist_pallas_dispatches = 0
        self.fused_group_passes = 0
        # KLL chunk sorts: one per torch.sort of a KLL op (a batched op
        # sorts all its columns at once), and the columns they sorted
        self.kll_sort_passes = 0
        self.kll_sorted_columns = 0
        # device->host fetches of the most recent fused scan (the
        # one-fetch-per-scan contract: 1)
        self.last_scan_fetches = 0
        # group scans of an incremental stream (run_scan_group; each also
        # counts one scan pass) and the fetches their dispatch and drain
        # made (the one-fetch-per-group contract: equal counts)
        self.group_scan_passes = 0
        self.group_fetches = 0
        # streaming scans (_run_scan_stream)
        self.chunks_staged = 0
        self.chunks_staged_overlapped = 0
        self.bytes_staged = 0
        self.fold_drains = 0
        self.kll_compactions = 0
        self.kll_midscan_compactions = 0
        # the spill engine (spill/)
        self.spill_runs = 0
        self.spill_bytes_written = 0
        self.spill_bytes_read = 0
        self.spill_merge_passes = 0
        self.peak_group_state_bytes = 0
        # deferred scans (run_scan(defer=True), fetch_deferred)
        self.deferred_fetches = 0
        # the device fault ladder and run governance
        self.device_faults = 0
        self.oom_bisections = 0
        self.bisection_depth = 0
        self.encoded_demotions = 0
        self.watchdog_timeouts = 0
        self.fallback_refused = 0
        self.degradation_events: List[Dict[str, Any]] = []
        self.unverified_row_ranges: List[Tuple[int, int]] = []
        self.budget_charges = 0
        self.budget_exhaustions = 0
        # meshes
        self.mesh_faults = 0
        self.mesh_reshards = 0
        self.mesh_stragglers = 0
        self.peer_losses = 0
        self.member_launches: Dict[int, Dict[str, int]] = {}
        # serving (serve/): plan-cache hits and misses by suite, programs
        # built and reused, coalesced batches and their members, padded
        # slots (0 in the port: no tenant axis is padded), sub-plan hits
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.programs_built = 0
        self.programs_reused = 0
        self.coalesced_batches = 0
        self.coalesced_tenants = 0
        self.coalesce_padded_slots = 0
        self.subplan_cache_hits = 0
        # host wall seconds at the execute and fetch boundaries of the
        # in-memory and coalesced scans (the fetch synchronises)
        self.dispatch_seconds = 0.0
        self.drain_wait_seconds = 0.0

    @property
    def ingest_overlap_frac(self) -> float:
        if not self.chunks_staged:
            return 0.0
        return self.chunks_staged_overlapped / self.chunks_staged

    def _add(self, name: str, delta) -> None:
        """Add ``delta`` to counter ``name`` and to every tally open in this
        context. Caller holds the lock."""
        setattr(self, name, getattr(self, name) + delta)
        for tally in _TALLIES.get():
            tally.counts[name] = tally.counts.get(name, 0) + delta

    def bump(self, **deltas) -> None:
        """Add each delta to its counter under the lock: every counter is
        bumped here or in a ``record_*`` method, so counts stay exact while
        threads bump at once (a fleet's workers scan side by side)."""
        with self._lock:
            for name, delta in deltas.items():
                self._add(name, delta)

    def raise_to(self, **values) -> None:
        """Raise each high-water counter to its value, under the lock."""
        with self._lock:
            for name, value in values.items():
                setattr(self, name, max(getattr(self, name), value))

    @contextlib.contextmanager
    def tally(self):
        """Yield a :class:`RunTally` of what this context adds to the
        counters, events and unverified ranges until the block ends."""
        own = RunTally()
        token = _TALLIES.set(_TALLIES.get() + (own,))
        try:
            yield own
        finally:
            _TALLIES.reset(token)

    def record_staged(self, nbytes: int, overlapped: bool) -> None:
        """One chunk copied to the device by a streaming scan;
        ``overlapped``: its copy was issued while the previous chunk was
        staged and not yet scanned."""
        self.bump(chunks_staged=1, chunks_staged_overlapped=int(overlapped),
                  bytes_staged=int(nbytes))

    def record_fetch(self, nbytes: int) -> None:
        """One device->host fetch and its bytes. A fetch made by a watchdog
        call that was abandoned is dropped: its scan already failed typed
        and the ladder moved on, so its late count would land on whatever
        run is active when the call wakes."""
        if current_watchdog_call_abandoned():
            return
        self.bump(device_fetches=1, bytes_fetched=int(nbytes))

    def record_degradation(self, kind: str, **detail) -> Dict[str, Any]:
        """Append one rung taken (kind: 'oom_bisect', 'encoded_demote',
        'watchdog_timeout', 'cpu_fallback_refused', 'budget_exhausted',
        'fusion_demote', and on a mesh 'mesh_reshard', 'mesh_quarantine',
        'mesh_straggler', 'stale_residency_evicted', 'peer_lost') for
        ``scan_execution_report`` and ``VerificationResult.device_events``
        (the mesh kinds also on ``mesh_events``)."""
        event = {"kind": kind, **detail}
        with self._lock:
            self.degradation_events.append(event)
            for tally in _TALLIES.get():
                tally.events.append(event)
        # the flight recorder's rung seam: every ladder's rungs report here,
        # so each is an instant event inside the span it fired in
        rec = current_recorder()
        if rec is not None:
            rec.event(kind, **{k: v for k, v in detail.items()
                               if isinstance(v, (int, float, str, bool, type(None)))})
        return event

    def record_unverified(self, start: int, stop: int, reason: str,
                          kind: str = "budget_exhausted") -> Dict[str, Any]:
        """Mark rows [start, stop) unverified: a budget-exhausted run
        finished without them. The omission is reported, never silent
        (``VerificationResult.unverified_row_ranges``)."""
        rows = (int(start), int(stop))
        with self._lock:
            self.unverified_row_ranges.append(rows)
            for tally in _TALLIES.get():
                tally.unverified.append(rows)
        return self.record_degradation(kind, start=int(start), stop=int(stop), reason=reason)

    def record_budget_charge(self, exhausted: bool = False) -> None:
        """One charge to a run budget, or (``exhausted``) a budget that ran
        out."""
        if exhausted:
            self.bump(budget_exhaustions=1)
        else:
            self.bump(budget_charges=1)

    def record_subplan_hit(self, n: int = 1) -> None:
        """``n`` suites served from a program another plan key built
        (``serve/plan_cache.SUBPLAN_CACHE``)."""
        self.bump(subplan_cache_hits=int(n))

    def record_kll_sort(self, columns: int) -> None:
        self.bump(kll_sort_passes=1, kll_sorted_columns=int(columns))

    def record_hist_dispatch(self, name: str, n: int = 1) -> None:
        """``n`` histogram dispatches under ``name``: a route ("kernel",
        "plain" or "host") or a variant ("scatter", "onehot", "pallas")."""
        self.bump(**{f"hist_{name}_dispatches": int(n)})

    def record_fused_group_pass(self, n: int = 1) -> None:
        """``n`` grouping passes that rode one fused dispatch."""
        self.bump(fused_group_passes=int(n))

    def record_member_launches(self, member: int, counts: Dict[str, int]) -> None:
        """Add one member's kernel launches (``counts`` by kernel)."""
        with self._lock:
            mine = self.member_launches.setdefault(int(member), {})
            for kernel, n in counts.items():
                mine[kernel] = mine.get(kernel, 0) + int(n)

    def snapshot(self) -> Dict[str, Any]:
        """Every counter, read under the lock; the event and range lists
        are copies, not live views."""
        with self._lock:
            snap = {k: v for k, v in vars(self).items() if not k.startswith("_")}
            snap["degradation_events"] = [dict(e) for e in self.degradation_events]
            snap["unverified_row_ranges"] = [tuple(r) for r in self.unverified_row_ranges]
            snap["member_launches"] = {m: dict(c) for m, c in self.member_launches.items()}
        snap["ingest_overlap_frac"] = self.ingest_overlap_frac
        return snap


SCAN_STATS = ScanStats()


def _launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by kernel."""
    from deequ_tpu_torch.ops import histogram_device, hll, select_device

    return {"K1": masked_reduce.LAUNCHES, "K2": hll.LAUNCHES, "K4": select_device.LAUNCHES,
            "K5": histogram_device.LAUNCHES, "K6": histogram_device.ONEHOT_LAUNCHES,
            "K7": histogram_device.FUSED_LAUNCHES}


@contextlib.contextmanager
def member_scope(member: Optional[int], device):
    """Run the block as mesh member ``member`` (None: no mesh): on
    ``device``'s CUDA context, its kernel launches counted in
    ``ScanStats.member_launches``."""
    if member is None:
        yield
        return
    before = _launch_counts()
    guard = torch.cuda.device(device) if torch.device(device).type == "cuda" \
        else contextlib.nullcontext()
    try:
        with guard:
            yield
    finally:
        after = _launch_counts()
        SCAN_STATS.record_member_launches(
            member, {k: after[k] - before[k] for k in after if after[k] != before[k]}
        )


def mesh_merge(is_sum: torch.Tensor, is_min: torch.Tensor, flats: Sequence[torch.Tensor],
               src: torch.Tensor) -> torch.Tensor:
    """K8, the tagged merge of a mesh's members (the reference's
    ``_tag_collective`` psum/pmin/pmax): ``flats`` are one chunk's member
    vectors, on the lead, in member order; the elementwise entries ``src``
    selects fold member by member, starting from member 0's own, through
    ``masked_reduce.merge_tags`` — ``k1_merge`` on a card (its launches
    counted under the caller ``"mesh"``), the plain version on the CPU.
    Returns the chunk's merged elementwise vector."""
    acc = flats[0][src]
    for flat in flats[1:]:
        acc = masked_reduce.merge_tags(is_sum, is_min, acc, flat, src, caller="mesh")
    return acc


def fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy device tensors to host numpy arrays as ONE accounted fetch
    (one ``record_fetch`` for the group: the call sites fetch arrays that
    come back together)."""
    with device_boundary("fetch"):
        out = [t.detach().cpu().numpy() for t in tensors]
    SCAN_STATS.record_fetch(sum(a.nbytes for a in out))
    return out


def _enc_lut(dictionary: np.ndarray) -> np.ndarray:
    """An encoded column's decode table: its dictionary as f64 with one
    trailing 0.0, the value a null row (code -1) gathers."""
    return np.append(dictionary.astype(np.float64), 0.0)


class _ChunkPacker:
    """Packs one chunk of a table into four contiguous host planes and
    moves each to the device in one copy:

    - ``values``: (k, rows) float64 — every numeric and boolean column
      (int64 values are exact in f64 below 2^53, as on the reference's
      wide-f64 plane);
    - ``masks``: (m, rows) bool — only columns with nulls ship a row;
    - ``codes``: (s, rows) int32 — string dictionary codes, -1 = null;
    - ``enc``: (e, rows) int16 — the codes of dictionary-encoded numeric
      columns (``encode``, default on), -1 = null: validity rides in the
      codes, and the values decode on the device (:meth:`unpack_vals`).
    """

    def __init__(self, cols: Dict[str, Column], encode: bool = True):
        self.cols = cols
        numeric = [n for n, c in cols.items() if c.dtype != DType.STRING]
        self.enc_names = [
            n for n in numeric
            if encode and cols[n].encoding is not None
        ]
        self.numeric_names = [n for n in numeric if n not in self.enc_names]
        self.string_names = [n for n, c in cols.items() if c.dtype == DType.STRING]
        self.masked_names = [
            n for n in self.numeric_names if not bool(cols[n].mask.all())
        ]

    #: each plane's dtype, in ``pack``'s order
    PLANE_DTYPES = (np.float64, np.bool_, np.int32, np.int16)

    def layout(self) -> Tuple[Tuple[str, ...], ...]:
        """The planes' row names: two tables whose packers have one layout
        pack into planes of the same shapes and meanings."""
        return (tuple(self.numeric_names), tuple(self.masked_names),
                tuple(self.string_names), tuple(self.enc_names))

    def plane_rows(self) -> Tuple[int, ...]:
        return tuple(len(names) for names in self.layout())

    def pack(self, start: int, stop: int, out=None) -> Tuple[np.ndarray, ...]:
        """Rows [start, stop) as the four planes (values, masks, codes,
        enc); into ``out`` (four arrays of those shapes) when given."""
        n = stop - start
        if out is None:
            out = tuple(np.empty((rows, n), dtype=dt)
                        for rows, dt in zip(self.plane_rows(), self.PLANE_DTYPES))
        values, masks, codes, enc = out
        for i, name in enumerate(self.numeric_names):
            values[i] = self.cols[name].values[start:stop]
        for i, name in enumerate(self.masked_names):
            masks[i] = self.cols[name].mask[start:stop]
        for i, name in enumerate(self.string_names):
            codes[i] = self.cols[name].codes[start:stop]
        for i, name in enumerate(self.enc_names):
            enc[i] = self.cols[name].encoding.codes[start:stop]
        return values, masks, codes, enc

    def to_device(self, planes, device) -> Tuple[torch.Tensor, ...]:
        with device_boundary("transfer"):
            return tuple(torch.from_numpy(p).to(device) for p in planes)

    def enc_luts(self, device) -> Dict[str, torch.Tensor]:
        """Each encoded column's decode table on ``device``, built and
        copied once per dictionary (``ops/lut_cache.py``)."""
        with device_boundary("transfer"):
            return {
                name: dictionary_lut_device(
                    self.cols[name].encoding.dictionary, "enc_f64", _enc_lut, device
                )
                for name in self.enc_names
            }

    def unpack_vals(self, values, masks, codes, enc, row_valid, luts=None,
                    enc_luts=None, names=None) -> Dict[str, Val]:
        """Slice the device planes back into per-column Vals (views; an
        encoded column decodes by one gather of its ``enc_luts`` table,
        bit for bit the value its decoded plane row would hold). ``luts``
        ({column: {key: device tensor}}) rides on string Vals; ``names``
        limits the Vals to the columns a scan reads."""
        want = set(self.cols) if names is None else set(names)
        if enc_luts is None and self.enc_names:
            enc_luts = self.enc_luts(enc.device)
        mask_row = {n: i for i, n in enumerate(self.masked_names)}
        vals: Dict[str, Val] = {}
        for i, name in enumerate(self.numeric_names):
            if name not in want:
                continue
            mask = masks[mask_row[name]] if name in mask_row else row_valid
            if self.cols[name].dtype == DType.BOOLEAN:
                vals[name] = Val("bool", values[i] != 0.0, mask)
            else:
                vals[name] = Val("num", values[i], mask)
        for j, name in enumerate(self.string_names):
            if name in want:
                vals[name] = Val(
                    "str", codes[j], None, dictionary=self.cols[name].dictionary,
                    luts=(luts or {}).get(name),
                )
        for i, name in enumerate(self.enc_names):
            if name not in want:
                continue
            lut = enc_luts[name]
            code = enc[i].to(torch.int32)
            valid = code >= 0
            data = lut.index_select(0, torch.where(valid, code, lut.numel() - 1))
            if self.cols[name].encoding.validity is None:
                valid = row_valid
            vals[name] = Val("num", data, valid)
        return vals


#: guards the publication of a fold plan's single_rows tiling
_TILING_LOCK = threading.Lock()


class _DeviceFoldPlan:
    """Folds per-chunk flat state vectors on the device so a scan fetches
    once (the reference's ``_DeviceFoldPlan``).

    - :meth:`flatten` lays one chunk's partials out as ONE f64 vector (ops,
      then keys): tensor leaves are copied (cast) into their slots, and
      the chunk's K1 tasks (``ops/masked_reduce.py``: a leaf that is a
      ``Reduction`` or its outputs) are resolved at once, each output
      written at its slot — by the kernel on a card, by the plain versions
      on the CPU;
    - sum/min/max leaves live in one elementwise f64 accumulator and merge
      with plain f64 add/minimum/maximum in chunk order
      (``masked_reduce.merge_tags``), starting from the monoid identity
      (0, +inf, -inf) — the same operations, in the same order, as the
      reference's fold;
    - 'gather' leaves (per-chunk Welford moments, KLL summaries) are
      written into row ``ci`` of a (capacity, width) buffer — the device
      equivalent of the host concatenation, order preserved.

    Over a mesh of ``members`` members each chunk brings one flat vector a
    member (:meth:`merge_members`): the elementwise entries fold across
    the members first (:func:`mesh_merge`, K8) and then into the
    accumulator, and each member's gather leaves take a row of their own,
    chunk-major and member-major within a chunk — ``capacity`` chunks
    then fill ``capacity * members`` rows.

    An in-memory scan sizes ``capacity`` to its chunk count. A stream
    cannot know its chunk count, so its fold holds
    :data:`STREAM_FOLD_CAPACITY` chunks: when that many are gathered
    (:attr:`gather_full`), :meth:`drain_gathered` fetches them and empties
    the buffer, while the elementwise accumulator keeps folding on the
    device — a stream's sums fold in chunk order whatever its length, and
    a stream with no gather leaf fetches once, at its end.

    Leaves are f64 on the device (counts are exact below 2^53); integer
    leaves come back as int64 at :meth:`unflatten`. A leaf's size and
    whether it is an integer come from the tensor, or from its task.
    """

    def __init__(self, ops: Sequence[ScanOp], partials, capacity: int, device,
                 members: int = 1):
        self._layout = []  # per op: [(key, tag, region_offset, size, shape, is_int)]
        self._slots = []  # per op: [(flat offset, size)]
        elem_src, gather_src = [], []
        sum_mask, min_mask, init = [], [], []
        src = elem_off = gather_off = 0
        for op, part in zip(ops, partials):
            leaves, slots = [], []
            for key, leaf in part.items():
                tag = op.tags[key]
                if tag not in FOLD_TAGS:
                    raise ValueError(f"unknown fold tag {tag!r}")
                size, shape, is_int = _leaf_shape(leaf)
                idx = np.arange(src, src + size)
                if tag == "gather":
                    gather_src.append(idx)
                    leaves.append((key, tag, gather_off, size, shape, is_int))
                    gather_off += size
                else:
                    elem_src.append(idx)
                    sum_mask.append(np.full(size, tag == "sum"))
                    min_mask.append(np.full(size, tag == "min"))
                    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[tag]
                    init.append(np.full(size, ident))
                    leaves.append((key, tag, elem_off, size, shape, is_int))
                    elem_off += size
                slots.append((src, size))
                src += size
            self._layout.append(leaves)
            self._slots.append(slots)

        def cat(parts, dtype):
            return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

        def dev(a):
            return torch.from_numpy(a).to(device)

        self.device = torch.device(device)
        self.flat_size = src
        self.elem_size = elem_off
        self.gather_size = gather_off
        self.capacity = capacity
        self.members = members
        self._elem_src = dev(cat(elem_src, np.int64))
        self._gather_src = dev(cat(gather_src, np.int64))
        self._is_sum = dev(cat(sum_mask, bool))
        self._is_min = dev(cat(min_mask, bool))
        self._acc = dev(cat(init, np.float64))
        self._gathered = torch.zeros(
            (capacity * members, self.gather_size), dtype=torch.float64, device=device
        )
        self._filled = 0
        # single_rows' masks, identities and indices tiled for the most rows
        # seen yet; K rows read the first K * elem_size entries
        self._tiled: Optional[Tuple[torch.Tensor, ...]] = None

    def flatten(self, partials, row_valid: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
        """One chunk's partials as its flat f64 vector, on ``device`` (the
        partials' own: a mesh member's; default the fold's). ``row_valid``
        is the chunk's row-validity mask, which the engine builds all-true:
        a task drops it (``Reduction.without``) and reads no such mask."""
        return self.flatten_rows([partials], row_valid, device)[0]

    def flatten_rows(self, rows, row_valid: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
        """K chunks' partials (``rows``: the batches of a group scan, the
        members of a coalesced batch) as one (K, flat size) tensor: each
        row's tensor leaves copied into it, and the K1 tasks of all K rows
        resolved by ONE ``reduce_into``, row k's outputs at their slots of
        row k. Each row is bit for bit :meth:`flatten` of its partials
        alone: K1's bits depend only on a task's rows and ``n``, never on
        its place in the batch or the other tasks there. ``row_valid`` is
        one mask all rows share."""
        flats = torch.empty((len(rows), self.flat_size), dtype=torch.float64,
                            device=self.device if device is None else device)
        tasks: Dict[int, Tuple[masked_reduce.Reduction, List[int]]] = {}
        for k, partials in enumerate(rows):
            base = k * self.flat_size
            for part, slots in zip(partials, self._slots):
                for leaf, (off, size) in zip(part.values(), slots):
                    outs = masked_reduce.outputs_of(leaf)
                    if outs is None:
                        flats[k, off:off + size].copy_(leaf.reshape(-1))
                        continue
                    for j, (task, index) in enumerate(outs):
                        entry = tasks.setdefault(id(task), (task, [-1] * task.n_outputs))
                        if entry[1][index] != -1:
                            raise ValueError("a task output is placed in two scan leaves")
                        entry[1][index] = base + off + j
        if tasks:
            masked_reduce.reduce_into(
                flats.view(-1), [task.without(row_valid) for task, _ in tasks.values()],
                [offs for _, offs in tasks.values()],
            )
        return flats

    def _merged(self, acc: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
        return masked_reduce.merge_tags(self._is_sum, self._is_min, acc, flat, self._elem_src)

    def merge(self, flat: torch.Tensor) -> None:
        """Fold one chunk's flat vector into the accumulator."""
        self.merge_members([flat])

    def merge_members(self, flats: Sequence[torch.Tensor]) -> None:
        """Fold one chunk's member vectors (on the fold's device, in member
        order; one without a mesh): the members' elementwise entries by
        :func:`mesh_merge`, then the accumulator; each member's gather
        leaves into a row of their own."""
        if self.gather_full:
            raise ValueError("the fold's gather buffer is full: drain it first")
        if len(flats) != self.members:
            raise ValueError(f"the fold takes {self.members} member vectors a chunk")
        if self.elem_size:
            if len(flats) == 1:
                self._acc = self._merged(self._acc, flats[0])
            else:
                chunk = mesh_merge(self._is_sum, self._is_min, flats, self._elem_src)
                self._acc = masked_reduce.merge_tags(self._is_sum, self._is_min,
                                                     self._acc, chunk)
        for flat in flats:
            if self.gather_size:
                self._gathered[self._filled] = flat[self._gather_src]
            self._filled += 1

    @property
    def gather_full(self) -> bool:
        """Whether the gather buffer holds ``capacity`` chunks (a fold
        with no gather leaf never fills)."""
        return bool(self.gather_size) and self._filled >= self.capacity * self.members

    def drain_gathered(self) -> List[Dict[str, np.ndarray]]:
        """Fetch the gathered chunks (one fetch) and empty the buffer:
        per-op dicts of the gather leaves alone, stacked over the chunks
        drained. The elementwise accumulator stays on the device."""
        filled, self._filled = self._filled, 0
        (host,) = fetch(self._gathered[:filled].reshape(-1))
        # on the CPU the fetched array is a view of the buffer the next
        # chunks overwrite
        return self.unflatten(host.copy(), filled, gather_only=True)

    @property
    def single_size(self) -> int:
        return self.elem_size + self.gather_size

    def single(self, flat: torch.Tensor) -> torch.Tensor:
        """The vector a scan of ONE chunk with this flat vector fetches:
        the same merge from the identities, then its gather leaves —
        bit for bit what :meth:`merge` and :meth:`fetch_unflatten` give a
        one-chunk table."""
        return self.single_rows(flat.unsqueeze(0))[0]

    def single_rows(self, flats: torch.Tensor, caller: str = "fold") -> torch.Tensor:
        """For each row of ``flats`` ((K, flat size), :meth:`flatten_rows`)
        the vector a scan of ONE chunk with that flat vector fetches: the
        elementwise entries merged from the identities — all K rows in ONE
        ``merge_tags`` (the masks, identities and source indices tiled K
        times; ``caller`` names it in ``MERGE_LAUNCHES_BY_CALLER``) — then
        the gather leaves. Row k is bit for bit what :meth:`merge` and
        :meth:`fetch_unflatten` give a one-chunk table of row k's chunk;
        the fold's own accumulator is not touched. One tiling is kept, for
        the most rows seen yet: K rows take its first K * ``elem_size``
        entries, which are the tiling for K, so the tiling's device memory
        grows with the largest K alone."""
        K = flats.shape[0]
        if self.elem_size:
            # threads share a plan's fold (a fleet's workers): each reads
            # the published tiling once, builds a wider one of its own when
            # it is short, and publishes that only if still the widest — a
            # tiling is never written after it is published
            tiled = self._tiled
            if tiled is None or tiled[0].numel() < K * self.elem_size:
                offsets = torch.arange(K, dtype=torch.int64, device=self.device) * self.flat_size
                tiled = (
                    self._is_sum.repeat(K), self._is_min.repeat(K), self._acc.repeat(K),
                    (self._elem_src.unsqueeze(0) + offsets.unsqueeze(1)).reshape(-1),
                )
                with _TILING_LOCK:
                    if self._tiled is None or self._tiled[0].numel() < tiled[0].numel():
                        self._tiled = tiled
            is_sum, is_min, acc, src = (t[:K * self.elem_size] for t in tiled)
            elem = masked_reduce.merge_tags(is_sum, is_min, acc, flats.reshape(-1), src,
                                            caller=caller).view(K, self.elem_size)
        else:
            elem = flats.new_empty((K, 0))
        return torch.cat([elem, flats[:, self._gather_src]], dim=1)

    def flat_result(self) -> torch.Tensor:
        """The fold's result as one new device vector: the accumulator,
        then the gathered chunks."""
        return torch.cat([self._acc, self._gathered[: self._filled].reshape(-1)])

    def fetch_unflatten(self) -> List[Dict[str, np.ndarray]]:
        """The scan's one device->host fetch, unpacked into per-op dicts of
        numpy leaves (gather leaves stacked over chunks)."""
        (host,) = fetch(self.flat_result())
        return self.unflatten(host, self._filled)

    def unflatten(self, host: np.ndarray, filled: int,
                  gather_only: bool = False) -> List[Dict[str, np.ndarray]]:
        """A fetched vector of ``filled`` chunks as per-op dicts of numpy
        leaves; with ``gather_only`` the vector holds the gathered chunks
        alone, and so do the dicts."""
        elem = host[: 0 if gather_only else self.elem_size]
        gathered = host[len(elem):].reshape(filled, self.gather_size)
        out = []
        for leaves in self._layout:
            result = {}
            for key, tag, off, size, shape, is_int in leaves:
                if gather_only and tag != "gather":
                    continue
                if tag == "gather":
                    leaf = gathered[:, off:off + size].reshape((filled,) + shape)
                    if not shape:
                        leaf = leaf.reshape(filled)
                else:
                    leaf = elem[off:off + size].reshape(shape)
                result[key] = leaf.astype(np.int64) if is_int else leaf
            out.append(result)
        return out


def _leaf_shape(leaf) -> Tuple[int, Tuple[int, ...], bool]:
    """(size, shape, is_int) of a partial leaf: a tensor, one K1 task
    output (a scalar) or a list of them (a vector)."""
    outs = masked_reduce.outputs_of(leaf)
    if outs is None:
        return leaf.numel(), tuple(leaf.shape), not (leaf.is_floating_point()
                                                     or leaf.is_complex())
    ints = {task.is_int(index) for task, index in outs}
    if len(ints) != 1:
        raise ValueError("a vector leaf mixes integer and float task outputs")
    shape = () if isinstance(leaf, (masked_reduce.Reduction, masked_reduce.Output)) \
        else (len(outs),)
    return len(outs), shape, ints.pop()


def _device_luts(ops: Sequence[ScanOp], cols: Dict[str, Column], device):
    """Every op's lookup tables on the device: {column: {key: tensor}},
    each built and copied once per dictionary and device
    (``ops/lut_cache.py``), so a second scan of the same table builds
    none."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for op in ops:
        for col, key, build in op.luts:
            per_col = out.setdefault(col, {})
            if key not in per_col:
                with device_boundary("transfer"):
                    per_col[key] = dictionary_lut_device(
                        cols[col].dictionary, key, build, device
                    )
    return out


def _member_luts(ops: Sequence[ScanOp], cols: Dict[str, Column], members):
    """:func:`_device_luts` on every member's device: {device: {column:
    {key: tensor}}}. The LUT memo keys on the device
    (``lut_cache.dictionary_lut_device``), so each distinct device holds
    one copy: a virtual mesh's members share theirs."""
    return {dev: _device_luts(ops, cols, dev) for dev in dict.fromkeys(d for _, d in members)}


def _members_of(mesh: Optional[Mesh], device) -> Tuple[Tuple[Optional[int], torch.device], ...]:
    """The (member id, device) pairs a scan runs on: the mesh's members,
    or one member with no id on ``device``."""
    if mesh is None:
        return ((None, torch.device(device)),)
    return mesh.members


class DeviceTableCache:
    """A table's packed chunks resident on a device — the analogue of
    Spark's ``df.persist()`` (the reference's ``DeviceTableCache``):
    ``device_chunks`` holds one tuple of device planes
    (values, masks, codes, enc) a chunk of ``chunk`` rows, packed by
    ``packer`` from every column of the table; ``nbytes`` counts them.

    Persisted over a mesh (``mesh``), ``device_chunks[ci]`` holds one
    plane tuple a member — member ``i``'s ``local_n`` rows of chunk ``ci``
    on its device (:meth:`shard`) — and ``member_bytes`` each member's
    bytes, which count against the budget of that member's device."""

    def __init__(self, packer: _ChunkPacker, chunk: int, device_chunks, device, nbytes: int,
                 mesh: Optional[Mesh] = None, member_bytes: Sequence[int] = ()):
        self.packer = packer
        self.chunk = chunk
        self.device_chunks = device_chunks
        self.device = torch.device(device)
        self.nbytes = nbytes
        self.mesh = mesh
        self.member_bytes = list(member_bytes)
        _ACTIVE_CACHES.add(self)

    def shard(self, ci: int, member: int):
        """Member ``member``'s planes of chunk ``ci`` (the chunk's planes
        without a mesh)."""
        planes = self.device_chunks[ci]
        return planes if self.mesh is None else planes[member]

    def bytes_on(self, device) -> int:
        """The resident bytes this cache holds on ``device``."""
        device = torch.device(device)
        if self.mesh is None:
            return self.nbytes if self.device == device else 0
        return sum(b for b, dev in zip(self.member_bytes, self.mesh.devices) if dev == device)

    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices the cache holds chunks on."""
        return (self.device,) if self.mesh is None else tuple(dict.fromkeys(self.mesh.devices))

    def mesh_matches(self, mesh: Optional[Mesh]) -> bool:
        """Whether the cache was sharded over ``mesh`` (both None: one
        device each)."""
        return mesh == self.mesh

    def matches(self, device, needed_cols, mesh: Optional[Mesh] = None) -> bool:
        if not self.mesh_matches(mesh):
            return False
        if mesh is None and torch.device(device) != self.device:
            return False
        return set(needed_cols) <= set(self.packer.cols)


# the live caches, weakly held: persist() checks the combined resident
# bytes of every table persisted on its device against that device's
# budget, not the newest alone
_ACTIVE_CACHES: "weakref.WeakSet[DeviceTableCache]" = weakref.WeakSet()


def total_resident_bytes(device=None) -> int:
    """The resident bytes of every persisted table, or of those on
    ``device`` alone (a mesh cache counts its members there)."""
    if device is None:
        return sum(c.nbytes for c in _ACTIVE_CACHES)
    return sum(c.bytes_on(device) for c in _ACTIVE_CACHES)


def has_resident_budget(device) -> bool:
    """Whether ``device`` has a default resident budget: a card has one;
    the CPU, where a host table needs no copy, has none."""
    return torch.device(device).type == "cuda"


def resident_budget(device) -> int:
    """The default cap on resident bytes: :data:`RESIDENT_FRACTION` of the
    card's memory. The CPU has none; its callers pass ``max_bytes``."""
    device = torch.device(device)
    if not has_resident_budget(device):
        raise ValueError(
            "persist on the CPU needs max_bytes: the resident budget is a "
            "share of a card's memory"
        )
    return int(RESIDENT_FRACTION * torch.cuda.get_device_properties(device).total_memory)


def persist_table(
    table,
    device=None,
    chunk_rows: Optional[int] = None,
    max_bytes: Optional[int] = None,
    encode: Optional[bool] = None,
    mesh=_UNSET,
) -> DeviceTableCache:
    """Pack every column of ``table`` and copy it to ``device`` once, into
    chunks of the reference's resident size; attach the cache as
    ``table._device_cache``. The device and mesh resolve as every entry
    point resolves them (``parallel/mesh.py:resolve_placement``: ``cuda``
    unless the caller asks for the CPU; a mesh asked for, or the default
    mesh of a machine with several cards): over a mesh of n members the
    chunk rounds up to a multiple of n and each member holds its
    ``chunk / n`` rows of every chunk on its own device. Encoded columns
    stay encoded unless ``encode=False`` (None:
    ``scan_plan.encoded_ingest_enabled``, on unless
    ``DEEQU_TORCH_ENCODED_INGEST=0``). Persisting a persisted table
    replaces its chunks. Raises MemoryError, leaving the table not
    persisted, when the combined resident bytes on a device would pass
    ``max_bytes`` (:func:`resident_budget` of that device by default)."""
    from deequ_tpu_torch.parallel.mesh import resolve_placement

    device, mesh = resolve_placement(device, mesh)
    members = _members_of(mesh, device)
    n_dev = len(members)
    devices = list(dict.fromkeys(dev for _, dev in members))
    caps = {dev: max_bytes if max_bytes is not None else resident_budget(dev)
            for dev in devices}
    _evict_device_cache(table)
    cols = {name: table[name] for name in table.column_names}
    n_rows = table.num_rows
    chunk = round_chunk(chunk_rows or min(
        _auto_chunk_rows(cols, RESIDENT_CHUNK_BYTES, RESIDENT_MAX_CHUNK_ROWS),
        max(n_rows, 1),
    ), n_dev)
    local_n = chunk // n_dev
    packer = _ChunkPacker(cols, encode=encoded_ingest_enabled(encode))
    base = {dev: total_resident_bytes(dev) for dev in devices}
    added = dict.fromkeys(devices, 0)
    member_bytes = [0] * n_dev
    device_chunks = []
    for start, stop in _chunk_bounds(n_rows, chunk):
        shards = []
        for i, (_, dev) in enumerate(members):
            planes = packer.pack(*shard_bounds(start, stop, local_n, i))
            size = sum(p.nbytes for p in planes)
            member_bytes[i] += size
            added[dev] += size
            if base[dev] + added[dev] > caps[dev]:
                raise MemoryError(
                    f"persist_table: the combined resident size on {dev} would pass "
                    f"{caps[dev]} bytes; stream instead or raise max_bytes"
                )
            shards.append(packer.to_device(planes, dev))
        device_chunks.append(shards[0] if mesh is None else tuple(shards))
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    cache = DeviceTableCache(packer, chunk, device_chunks, device, sum(member_bytes),
                             mesh=mesh, member_bytes=member_bytes)
    table._device_cache = cache
    return cache


def _evict_device_cache(table) -> int:
    """Drop the table's resident chunks now and take them off the budget;
    returns the bytes freed: on a card, what ``torch.cuda.memory_allocated``
    fell by on each device the cache held (nothing while another
    reference still holds the chunks), on the CPU the chunks' bytes."""
    cache = getattr(table, "_device_cache", None)
    if cache is None:
        return 0
    cards = [dev for dev in cache.devices() if dev.type == "cuda"]
    before = {dev: torch.cuda.memory_allocated(dev) for dev in cards}
    host_bytes = sum(cache.bytes_on(dev) for dev in cache.devices() if dev.type != "cuda")
    cache.device_chunks = []
    cache.nbytes = 0
    cache.member_bytes = [0] * len(cache.member_bytes)
    _ACTIVE_CACHES.discard(cache)
    table._device_cache = None
    return host_bytes + sum(
        max(before[dev] - torch.cuda.memory_allocated(dev), 0) for dev in cards
    )


def _resident_cache(table, device, needed, chunk_rows,
                    mesh: Optional[Mesh] = None) -> Optional[DeviceTableCache]:
    """The table's resident cache when it can serve this scan: the same
    device and mesh, every needed column, and the chunk size if one was
    asked."""
    cache = getattr(table, "_device_cache", None)
    if cache is None or not cache.matches(device, needed, mesh):
        return None
    if chunk_rows is not None and chunk_rows != cache.chunk:
        return None
    return cache


class DeferredScan:
    """A fused scan of an in-memory table whose kernels are queued and
    whose fold is not fetched yet (``run_scan(defer=True)``): it holds the
    scan's flat vector on the device, a tensor of its own (never a view of
    a buffer that is refilled). :func:`fetch_deferred` fetches several at
    once; :meth:`result` gives this one's leaves (fetching it alone if no
    one did), or raises what went wrong when they were unpacked."""

    def __init__(self, fold: "_DeviceFoldPlan", vector: torch.Tensor, filled: int,
                 deadline: Optional[float] = None):
        self._fold = fold
        self._vector = vector
        self._filled = filled
        self._deadline = deadline
        self._results: Optional[List[Dict[str, np.ndarray]]] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._vector is None

    def _settle(self, host: np.ndarray) -> None:
        self._vector = None
        try:
            self._results = self._fold.unflatten(host, self._filled)
        except BaseException as e:  # noqa: BLE001 — kept for result()
            # an interrupt mid-unpack leaves the scan failed too: a later
            # result() raises it again and never reads half its leaves
            self._error = e
            if not isinstance(e, Exception):
                raise

    def result(self) -> List[Dict[str, np.ndarray]]:
        if not self.done:
            fetch_deferred([self])
        if self._error is not None:
            raise self._error
        return self._results


def fetch_deferred(scans: Sequence[DeferredScan]) -> None:
    """Fetch every pending scan of ``scans`` in ONE device->host copy: their
    vectors are concatenated on the device, and each slice is unpacked
    into its scan's leaves in order. A scan whose unpacking fails keeps
    its error for :meth:`DeferredScan.result`; the others are not
    touched by it. The fetch is a device boundary like any other: a fault
    surfacing there raises typed, under the scans' watchdog deadline."""
    pending = [s for s in scans if not s.done]
    if not pending:
        return
    sizes = [int(s._vector.numel()) for s in pending]
    deadline = next((s._deadline for s in pending if s._deadline is not None), None)
    (host,) = device_call(
        lambda: fetch(torch.cat([s._vector for s in pending])),
        "fetch", what="deferred scan fetch", deadline=deadline,
        device=pending[0]._vector.device,
    )
    SCAN_STATS.bump(deferred_fetches=1)
    off = 0
    for scan, size in zip(pending, sizes):
        scan._settle(host[off:off + size])
        off += size


#: the smallest chunk the OOM bisection tries before giving up: below it
#: an OOM is no longer about the chunk's size (something else holds the
#: card's memory), and log2(RESIDENT_MAX_CHUNK_ROWS / 64) = 19 bounds the
#: halvings of one scan
MIN_BISECT_CHUNK_ROWS = 64

#: the least watchdog a governed attempt gets, however little of the run
#: budget's wall is left: a 0-second watchdog would turn every healthy
#: call into a hang; the budget's own wall check ends the run typed after
MIN_BUDGET_WATCHDOG_SECONDS = 0.05

# one id a logical run_scan call, the same across its retries: the key the
# deterministic fault hook scripts against
_SCAN_IDS = itertools.count()


def _governed_attempt(budget, fn: Callable, what: str, device):
    """Run one WHOLE scan attempt under the run budget's wall watchdog (one
    worker a governed attempt, never one a device call): a hang anywhere
    in the attempt becomes a typed ``DeviceHangException`` at the budget
    left, so a run ends within its ``run_deadline``. Without a budget, or
    a budget without a deadline, ``fn`` runs inline. The ambient budget is
    thread-local, so the worker re-enters its scope: charge sites inside
    the attempt draw on this run's ledger, and a worker abandoned after a
    timeout can charge only its own (exhausted) budget."""
    wall_left = budget.remaining_seconds() if budget is not None else None
    if wall_left is None:
        return fn()
    from deequ_tpu_torch.resilience.governance import run_budget_scope

    # the recorder is thread-local too: the worker re-enters it, parented
    # to the caller's open span, so the attempt's spans keep recording
    rec = current_recorder()
    rec_parent = rec.current_span_id() if rec is not None else None

    def governed_fn():
        with run_budget_scope(budget), (recording_scope(rec, rec_parent) if rec is not None
                                        else contextlib.nullcontext()):
            return fn()

    return call_with_deadline(
        governed_fn, max(wall_left, MIN_BUDGET_WATCHDOG_SECONDS), what, "execute", device,
    )


def run_scan(
    table,
    ops: Sequence[ScanOp],
    device,
    chunk_rows: Optional[int] = None,
    select_kernel: Optional[bool] = None,
    encoded_ingest: Optional[bool] = None,
    defer: bool = False,
    on_device_error: str = "fail",
    device_deadline: Optional[float] = None,
    run_deadline: Optional[float] = None,
    max_total_attempts: Optional[int] = None,
    on_budget_exhausted: Optional[str] = None,
    mesh=_UNSET,
    shard_deadline: Optional[float] = None,
    trace=None,
):
    """Run all ops in ONE fused pass over the table on ``device``. Returns
    one dict of reduced numpy leaves per op. The whole pass performs one
    device->host fetch. A table persisted on ``device`` is read from its
    resident chunks (no packing, no copy), and its KLL summaries take the
    radix select unless ``select_kernel`` is False
    (``ops/scan_plan.py``). ``encoded_ingest`` (None:
    ``scan_plan.encoded_ingest_enabled``) False packs every column decoded;
    a table persisted with encoded columns is then streamed.

    A StreamingTable takes the streaming route (:func:`_run_scan_stream`):
    chunks of the source's batch rows (``chunk_rows`` when given), staged
    through a double buffer behind a reader thread, the fold draining its
    gather leaves to the host every :data:`STREAM_FOLD_CAPACITY` chunks —
    one fetch for a stream of monoid ops. Its KLL ops sort, as every
    non-resident scan's do.

    ``defer=True`` (an in-memory table) queues the scan and returns a
    :class:`DeferredScan` instead of fetching: the resilient stream loop
    fetches its batches' scans together at a checkpoint boundary.

    Device faults (``ops/device_policy.py``, ``ops/scan_executors.py``):

    - raw torch and CUDA failures at a chunk's transfer, its step and the
      fetch raise as typed ``Device*Exception``s;
    - a ``DeviceOOMException`` evicts the table's residency and frees the
      allocator's cache, then demotes an encoded attempt to the decoded
      layout at the same chunk, else halves the chunk and retries — down
      to :data:`MIN_BISECT_CHUNK_ROWS` — each rung a recorded degradation
      event; a bisected attempt starts a fresh fold;
    - ``device_deadline`` (seconds; default ``DEEQU_TORCH_DEVICE_DEADLINE``)
      arms the watchdog on each chunk's step and on the fetch: a call past
      it raises ``DeviceHangException``;
    - a lost device, a kernel that will not build, a hang, or an OOM at the
      bisection floor ends the ladder: ``on_device_error="fail"`` (the
      default) raises the typed fault; ``"fallback"``, where the reference
      re-runs the scan on the CPU, raises ``DeviceFallbackRefusedException``
      with the fault as its ``__cause__``, as it does up front while the
      device's circuit breaker is open (``DEVICE_HEALTH``); the port never
      moves a CUDA run onto the CPU.

    Meshes (``parallel/mesh.py``): ``mesh`` (default: the ``use_mesh``
    scope; a mesh must be led by ``device``) shards every chunk's rows over
    its members (module doc). Members that ``MESH_HEALTH`` quarantined are
    left out up front (a ``mesh_quarantine`` event). A fault that names
    members sheds them: the mesh is rebuilt over the survivors, residency
    pinned to the old mesh evicted, and the scan runs again
    (``mesh_reshard``); with no member left the scan fails typed, or its
    CPU rung is refused. ``shard_deadline`` (default
    ``DEEQU_TORCH_SHARD_DEADLINE``) arms the straggler watchdog on each
    chunk step of a scan over two or more members: a stall past it raises
    ``DeviceHangException`` (``mesh_straggler``).

    Run governance (``resilience/governance.py``): ``run_deadline`` /
    ``max_total_attempts`` (defaults ``DEEQU_TORCH_RUN_DEADLINE`` /
    ``DEEQU_TORCH_RUN_ATTEMPTS``) arm one budget for this scan that every
    rung charges before it is spent; a scan under an ambient budget (one
    verification run's) charges that one instead. The first charge past it
    raises a typed ``RunBudgetExhaustedException``; with a wall deadline
    each whole attempt runs under one watchdog armed with the budget
    left.

    Tracing (``obs/``): ``trace`` (a FlightRecorder, True or False) scopes
    a recorder for this scan, every attempt included; None takes the
    caller's scope or the recorder ``DEEQU_TORCH_TRACE=1`` arms. Each
    attempt is a ``scan_attempt`` span, each device boundary a span inside
    it, each rung an instant event."""
    from deequ_tpu_torch.obs.recorder import maybe_arm_from_env, resolve_recorder
    from deequ_tpu_torch.ops import scan_executors
    from deequ_tpu_torch.ops.scan_plan import select_kernel_enabled
    from deequ_tpu_torch.resilience.governance import (
        current_run_budget,
        resolve_run_policy,
        run_budget_scope,
    )

    if on_device_error not in ("fail", "fallback"):
        raise ValueError(
            f"on_device_error must be 'fail' or 'fallback', got {on_device_error!r}"
        )
    maybe_arm_from_env()
    if trace is not None:
        with recording_scope(resolve_recorder(trace)):
            return run_scan(table, ops, device, chunk_rows, select_kernel, encoded_ingest,
                            defer, on_device_error, device_deadline, run_deadline,
                            max_total_attempts, on_budget_exhausted, mesh, shard_deadline)
    device = torch.device(device)
    mesh = scoped_mesh(device, mesh)
    if mesh is not None:
        device = mesh.lead
    budget = current_run_budget()
    if budget is None:
        policy = resolve_run_policy(run_deadline, max_total_attempts, on_budget_exhausted)
        if policy is not None:
            # a scan-local budget, ambient for every charge site inside
            with run_budget_scope(policy.arm()):
                return run_scan(table, ops, device, chunk_rows, select_kernel,
                                encoded_ingest, defer, on_device_error, device_deadline,
                                mesh=mesh, shard_deadline=shard_deadline)
    # the switches resolve once a run, so every rung plans alike; the
    # encoded switch is also the ladder's demotion state
    select_kernel = select_kernel_enabled(select_kernel)
    encoded = encoded_ingest_enabled(encoded_ingest)
    if device_deadline is None:
        device_deadline = default_device_deadline()
    if shard_deadline is None:
        shard_deadline = default_shard_deadline()
    scan_id = next(_SCAN_IDS)
    if scan_executors.classify(table) == "streaming":
        return scan_executors.run_streaming_scan(
            table, ops, device=device, chunk_rows=chunk_rows, defer=defer,
            device_deadline=device_deadline, encoded_ingest=encoded,
            budget=budget, scan_id=scan_id, mesh=mesh, shard_deadline=shard_deadline,
        )
    # members MESH_HEALTH quarantined stay out up front (half-open: it
    # readmits them now and then as a probe): a dead member must not fail
    # every scan again before each reshard
    mesh_exhausted = False
    if mesh_size(mesh) > 1:
        _, excluded = MESH_HEALTH.healthy_subset(mesh.device_ids)
        if excluded:
            shrunk = mesh_excluding(mesh, excluded)
            if shrunk is None:
                mesh_exhausted = True
            else:
                SCAN_STATS.record_degradation(
                    "mesh_quarantine", scan_id=scan_id, excluded_devices=sorted(excluded),
                    mesh_from=mesh.size, mesh_to=shrunk.size,
                )
                mesh = shrunk
    # "fallback" alone asks the breaker: its question advances the
    # half-open probe's count
    if on_device_error == "fallback" and (mesh_exhausted or DEVICE_HEALTH.should_force_fallback()):
        scan_executors.refuse_cpu_rung(
            table, scan_id, "mesh_exhausted" if mesh_exhausted else "unhealthy_backend",
            DEVICE_HEALTH.last_fault, budget,
            consecutive_faults=DEVICE_HEALTH.consecutive_faults,
        )
    return scan_executors.run_laddered_scan(
        table, ops, device=device, chunk_rows=chunk_rows, defer=defer,
        on_device_error=on_device_error, device_deadline=device_deadline,
        select_kernel=select_kernel, encoded_ingest=encoded, budget=budget,
        scan_id=scan_id, mesh=mesh, shard_deadline=shard_deadline,
    )


def _run_scan_once(
    table,
    ops: Sequence[ScanOp],
    device: torch.device,
    chunk_rows: Optional[int],
    defer: bool,
    device_deadline: Optional[float],
    scan_ctx: Dict[str, Any],
    report: Dict[str, Any],
    select_kernel: bool = True,
    encoded: bool = True,
    mesh: Optional[Mesh] = None,
):
    """One attempt of the fused in-memory scan, each chunk's transfer, each
    chunk's step (the fault hook's seam, ``scan_ctx`` plus its
    ``chunk_index``) and the fetch a device boundary (``device_call``).
    ``report`` returns the chunk rows the attempt used and whether it read
    an encoded layout, for the ladder's next rung. Every attempt starts a
    fresh fold sized for its own chunk count. Over ``mesh`` each chunk's
    step runs every member's shard on its device and folds them on the
    lead (module doc); a cache persisted over another mesh is evicted
    (``stale_residency_evicted``): its shards may sit on a member that is
    gone."""
    n_rows = table.num_rows
    needed = sorted({c for op in ops for c in op.columns})
    if mesh is not None:
        device = mesh.lead
    members = _members_of(mesh, device)
    n_dev = len(members)
    cache = getattr(table, "_device_cache", None)
    if (cache is not None and (cache.mesh is not None or mesh is not None)
            and not cache.mesh_matches(mesh)):
        freed = _evict_device_cache(table)
        SCAN_STATS.record_degradation(
            "stale_residency_evicted", scan_id=scan_ctx.get("scan_id"), evicted_bytes=freed,
        )
    cache = _resident_cache(table, device, needed, chunk_rows, mesh)
    if cache is not None and cache.packer.enc_names and not encoded:
        cache = None
    if cache is not None:
        packer, chunk = cache.packer, cache.chunk
    else:
        packer = _ChunkPacker({name: table[name] for name in needed}, encode=encoded)
        chunk = round_chunk(chunk_rows or min(_auto_chunk_rows(packer.cols), max(n_rows, 1)),
                            n_dev)
    local_n = chunk // n_dev
    report["chunk"] = chunk
    bounds = _chunk_bounds(n_rows, chunk)
    plan = plan_scan_ops(ops, packer, cache is not None, select_kernel, local_n,
                         torch.device(device).type)
    report["encoded"] = bool(plan.encoded_columns)
    ops = plan.ops
    n_chunks = len(bounds)
    op_luts = _member_luts(ops, packer.cols, members)
    enc_luts = {dev: packer.enc_luts(dev) for dev in op_luts}
    SCAN_STATS.bump(scan_passes=1, rows_scanned=n_rows,
                    device_sort_passes=plan.sort_ops * n_chunks,
                    device_select_passes=plan.select_ops * n_chunks,
                    encoded_scan_passes=int(bool(plan.encoded_columns)))
    if cache is not None:
        SCAN_STATS.bump(resident_passes=1, bytes_resident=cache.nbytes)
    fetches_before = SCAN_STATS.device_fetches
    fold: Optional[_DeviceFoldPlan] = None

    def transfer(start: int, stop: int):
        shards, nbytes = [], 0
        for i, (_, dev) in enumerate(members):
            host = packer.pack(*shard_bounds(start, stop, local_n, i))
            shards.append(packer.to_device(host, dev))
            nbytes += sum(p.nbytes for p in host)
        return shards, nbytes

    def step(shards, start: int, stop: int) -> None:
        nonlocal fold
        flats = []
        for i, (member, dev) in enumerate(members):
            lo, hi = shard_bounds(start, stop, local_n, i)
            with member_scope(member, dev):
                row_valid = torch.ones(hi - lo, dtype=torch.bool, device=dev)
                vals = packer.unpack_vals(*shards[i], row_valid, op_luts[dev], enc_luts[dev],
                                          needed)
                partials = [op.update(vals, row_valid, hi - lo, local_n) for op in ops]
                if fold is None:
                    fold = _DeviceFoldPlan(ops, partials, n_chunks, device, members=n_dev)
                flat = fold.flatten(partials, row_valid, dev)
            flats.append(flat if dev == device else flat.to(device, non_blocking=True))
        fold.merge_members(flats)

    for ci, (start, stop) in enumerate(bounds):
        # an attempt abandoned by its run-budget watchdog steps no further
        check_not_abandoned()
        if cache is not None:
            shards = [cache.shard(ci, i) for i in range(n_dev)]
        else:
            shards, nbytes = device_call(
                lambda: transfer(start, stop), "transfer", what=f"chunk {ci} transfer",
                deadline=device_deadline, device=device,
            )
            SCAN_STATS.bump(bytes_packed=nbytes)
        t_d = time.perf_counter()
        device_call(
            lambda: step(shards, start, stop), "execute", what=f"chunk {ci} step",
            deadline=device_deadline, hook_ctx={**scan_ctx, "chunk_index": ci},
            device=device,
        )
        SCAN_STATS.bump(dispatch_seconds=time.perf_counter() - t_d, chunks_processed=1)
    if defer:
        return DeferredScan(fold, fold.flat_result(), fold._filled, device_deadline)
    # CUDA runs asynchronously: a fault or a stall of the card surfaces at
    # this synchronising copy, so the watchdog and classification hold here
    t_f = time.perf_counter()
    results = device_call(fold.fetch_unflatten, "fetch", what="scan fetch",
                          deadline=device_deadline, device=device)
    SCAN_STATS.bump(drain_wait_seconds=time.perf_counter() - t_f)
    SCAN_STATS.last_scan_fetches = SCAN_STATS.device_fetches - fetches_before
    return results


# -- the out-of-core streaming scan ----------------------------------------------


def _prefetch(iterator, depth: int = 2):
    """Run ``iterator`` on a reader thread behind a queue of ``depth``
    items, so host decoding overlaps packing, copies and device work, and
    memory stays bounded by ``depth`` items. An exception of the reader
    reaches the consumer at its place in the stream, however long the
    consumer takes to free a slot; a consumer that abandons the generator
    stops the reader instead of leaving it blocked on a full queue. The
    reader re-enters the caller's run budget (thread-local): the read
    retries a source makes there charge this run's ledger — and the
    caller's recorder, when one is armed, so their retry events land on
    this run's trace."""
    from deequ_tpu_torch.resilience.governance import current_run_budget, run_budget_scope

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    budget = current_run_budget()
    rec = current_recorder()
    # scoped only when armed: a scope of None would arm the counter and
    # take every disarmed seam of the process off its one-read path
    rec_scope = (recording_scope(rec, rec.current_span_id()) if rec is not None
                 else contextlib.nullcontext())

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            with run_budget_scope(budget), rec_scope:
                for item in iterator:
                    if not put(item):
                        return
            put(done)
        except BaseException as e:  # noqa: BLE001 — handed to the consumer, raised there
            put(e)

    # in a copy of the consumer's context: its counts reach the run's tally
    reader = threading.Thread(target=contextvars.copy_context().run, args=(run,), daemon=True,
                              name="deequ-torch-prefetch")
    reader.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class _StagingSlots:
    """The double buffer of a stream's host-to-device copies. A chunk's
    planes are packed into one staging slot (each plane at a 512-byte
    boundary, as a fresh allocation would sit) and copied to the device in
    one copy. On a card the slots are pinned and the copy is issued
    ``non_blocking`` on a copy stream of its own, so the card copies chunk
    k+1 while its compute stream scans chunk k, and the host packs the
    chunk after. The copy's event orders the two streams
    (:meth:`ready`, before the chunk's step) and guards its slot: a slot
    is packed again only after the event has completed — refilling it
    earlier would corrupt a chunk in flight. On the CPU each chunk packs
    into a fresh array (the device tensor is a view of it)."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.pinned else None
        self._slots: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self._events: List[Optional[Any]] = [None] * self.SLOTS
        self._next = 0

    def _host_buffer(self, total: int):
        """(host uint8 tensor, slot index or None) with room for ``total``."""
        if not self.pinned:
            return torch.from_numpy(np.empty(total, dtype=np.uint8)), None
        i = self._next
        self._next = (i + 1) % self.SLOTS
        if self._events[i] is not None:
            self._events[i].synchronize()  # this slot's last copy is done
            self._events[i] = None
        buf = self._slots[i]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            self._slots[i] = buf
        return buf, i

    def stage(self, packer: "_ChunkPacker", start: int, stop: int):
        """Rows [start, stop) packed and their copy to the device issued:
        (the four device planes, their bytes, the copy's event or None).
        The planes may be read only on a stream that waited on the event
        (:meth:`ready`)."""
        n = stop - start
        shapes = [((rows, n), np.dtype(dt))
                  for rows, dt in zip(packer.plane_rows(), _ChunkPacker.PLANE_DTYPES)]
        offsets, total, nbytes = [], 0, 0
        for shape, dt in shapes:
            size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            offsets.append((total, size))
            total += _aligned(size)
            nbytes += size
        host, slot = self._host_buffer(max(total, 1))
        host_np = host.numpy()
        packer.pack(start, stop, out=tuple(
            host_np[off:off + size].view(dt).reshape(shape)
            for (off, size), (shape, dt) in zip(offsets, shapes)))
        event = None
        with device_boundary("transfer"):
            if slot is None:
                dev = host
            else:
                compute = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(self.copy_stream):
                    dev = torch.empty(host.numel(), dtype=torch.uint8, device=self.device)
                    dev.copy_(host, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self.copy_stream)
                # the buffer belongs to the copy stream's pool: it must not
                # be handed out again before the compute stream is done
                dev.record_stream(compute)
                self._events[slot] = event
        planes = []
        for (off, size), (shape, dt) in zip(offsets, shapes):
            tdt = torch.from_numpy(np.empty(0, dtype=dt)).dtype
            if size == 0:
                planes.append(torch.empty(shape, dtype=tdt, device=self.device))
            else:
                planes.append(dev[off:off + size].view(tdt).reshape(shape))
        return tuple(planes), nbytes, event

    def ready(self, event) -> None:
        """Order the compute stream after a chunk's copy (its event from
        :meth:`stage`), just before the chunk's step is queued: waiting
        any earlier would hold the previous chunk's step behind it."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)


class _StreamGather:
    """A stream's gather leaves on the host, across the fold's drains:
    each drained block joins the earlier ones along the chunk axis, and
    where a drain leaves more than ``op.compact_threshold`` values in one
    of an op's gather leaves, ``op.compact`` folds them (the KLL
    summaries). A stream whose gather fits one fold — every stream of at
    most :data:`STREAM_FOLD_CAPACITY` chunks — is never compacted, so it
    gives an in-memory scan's bits."""

    def __init__(self, ops: Sequence[ScanOp]):
        self.ops = ops
        self.blocks: Optional[List[Dict[str, np.ndarray]]] = None
        self.drains = 0

    def add(self, parts: List[Dict[str, np.ndarray]], final: bool) -> None:
        """Join one drain's per-op leaves (their gather leaves are kept);
        ``final``: the fetch at the stream's end, which compacts only where
        an earlier drain did come."""
        compact = not final or self.drains > 0
        parts = [{key: leaf for key, leaf in part.items() if op.tags[key] == "gather"}
                 for op, part in zip(self.ops, parts)]
        if self.blocks is None:
            self.blocks = parts
        else:
            self.blocks = [
                {key: np.concatenate([old[key], new[key]]) for key in new}
                for old, new in zip(self.blocks, parts)
            ]
        self.drains += 1
        if not compact:
            return
        for i, op in enumerate(self.ops):
            block = self.blocks[i]
            if op.compact is None or not block:
                continue
            if max(leaf.size for leaf in block.values()) > op.compact_threshold:
                self.blocks[i] = op.compact(block)
                SCAN_STATS.bump(kll_compactions=1, kll_midscan_compactions=int(not final))


def _run_scan_stream(
    stream,
    ops: Sequence[ScanOp],
    device: torch.device,
    chunk_rows: Optional[int] = None,
    encoded_ingest: Optional[bool] = None,
    scan_id: int = -1,
    device_deadline: Optional[float] = None,
    mesh: Optional[Mesh] = None,
) -> List[Dict[str, np.ndarray]]:
    """One fused pass over a StreamingTable (the reference's
    ``_run_scan_stream``): batches come off the source on a reader thread
    (:func:`_prefetch`), each is cut into chunks of ``chunk`` rows and
    packed as it comes — a batch's own packer, so a column that gains
    nulls or loses its encoding partway through the stream simply packs
    otherwise from then on, while every chunk's partials keep one flat
    layout — and each chunk's copy is issued from a staging slot
    (:class:`_StagingSlots`) before the previous chunk's step runs. The
    fold drains its gather leaves every :data:`STREAM_FOLD_CAPACITY`
    chunks (:class:`_StreamGather`, with KLL compaction there) and
    fetches the rest, and the accumulator, once at the end.

    ``chunk``: ``chunk_rows``, else the batch rows the source states, else
    the reference's rule at :data:`STREAM_CHUNK_BYTES` — capped, for a
    source that states none (a generator's), by its first batch's rows —
    and bounded by the source's row count when its metadata knows it. A
    stream that needs no
    column reads one, to keep its row count; an empty stream folds one
    empty chunk. Over ``mesh`` the chunk rounds up to a multiple of its
    members, each member's shard of a chunk is staged to its own device
    through staging slots of its own, and the fold takes the members'
    vectors on the lead (module doc). There is no fallback: on a card
    every kernel of the step runs there, or the scan raises."""
    from deequ_tpu_torch.data.streaming import empty_columns

    encode = encoded_ingest_enabled(encoded_ingest)
    schema = stream.schema
    needed = sorted({c for op in ops for c in op.columns})
    if not needed and schema.column_names:
        # a lone Size() prunes the read to no column, and a batch of no
        # column cannot carry its row count
        needed = [schema.column_names[0]]
    rule = _auto_chunk_rows({name: stream[name] for name in needed}, STREAM_CHUNK_BYTES)
    stated = chunk_rows or getattr(stream, "preferred_batch_rows", None)
    batches = _prefetch(stream.batches(columns=needed, batch_rows=stated or rule))
    first = next(batches, None)
    chunk = stated or min(rule, first.num_rows if first is not None and first.num_rows else rule)
    known_rows = getattr(getattr(stream, "source", None), "num_rows", None)
    if known_rows:
        chunk = min(chunk, known_rows)
    if mesh is not None:
        device = mesh.lead
    members = _members_of(mesh, device)
    n_dev = len(members)
    chunk = round_chunk(max(int(chunk), 1), n_dev)
    local_n = chunk // n_dev
    # a stream's chunks are never resident: its KLL ops sort
    plan = plan_scan_ops(ops, None, False, None, local_n)
    ops = plan.ops
    SCAN_STATS.bump(scan_passes=1)
    fetches_before = SCAN_STATS.device_fetches
    staging = [_StagingSlots(dev) for _, dev in members]
    host_gather = _StreamGather(ops)
    fold: Optional[_DeviceFoldPlan] = None
    staged: Optional[Tuple] = None  # the chunk copied and not yet scanned
    chunk_ids = itertools.count()
    encoded_counted = False
    hook_ids = mesh_device_ids(mesh)

    def scan_staged(entry) -> None:
        packer, shards, start, stop, op_luts, enc_luts, idx = entry

        def step() -> List[torch.Tensor]:
            nonlocal fold
            flats = []
            for i, (member, dev) in enumerate(members):
                planes, event = shards[i]
                lo, hi = shard_bounds(start, stop, local_n, i)
                with member_scope(member, dev):
                    staging[i].ready(event)
                    row_valid = torch.ones(hi - lo, dtype=torch.bool, device=dev)
                    vals = packer.unpack_vals(*planes, row_valid, op_luts[dev], enc_luts[dev],
                                              needed)
                    partials = [op.update(vals, row_valid, hi - lo, local_n) for op in ops]
                    if fold is None:
                        fold = _DeviceFoldPlan(ops, partials, STREAM_FOLD_CAPACITY, device,
                                               members=n_dev)
                    flat = fold.flatten(partials, row_valid, dev)
                flats.append(flat if dev == device else flat.to(device, non_blocking=True))
            return flats

        flats = device_call(
            step, "execute", what=f"stream chunk {idx} step", deadline=device_deadline,
            hook_ctx={"scan_id": scan_id, "attempt": 0, "chunk_index": idx,
                      "device_ids": hook_ids},
            device=device,
        )
        if fold.gather_full:
            host_gather.add(device_call(fold.drain_gathered, "fetch", what="stream fold drain",
                                        deadline=device_deadline, device=device),
                            final=False)
            SCAN_STATS.bump(fold_drains=1)
        device_call(lambda: fold.merge_members(flats), "execute",
                    what=f"stream chunk {idx} fold", deadline=device_deadline, device=device)
        SCAN_STATS.bump(chunks_processed=1, device_sort_passes=plan.sort_ops)

    def scan_batch(cols: Dict[str, Column], n: int) -> None:
        nonlocal staged, encoded_counted
        packer = _ChunkPacker(cols, encode=encode)
        if packer.enc_names and not encoded_counted:
            encoded_counted = True
            SCAN_STATS.bump(encoded_scan_passes=1)
        op_luts = _member_luts(ops, cols, members)
        enc_luts = {dev: packer.enc_luts(dev) for dev in op_luts}
        for start, stop in _chunk_bounds(n, chunk):
            check_not_abandoned()
            shards, nbytes = [], 0
            for i, slots in enumerate(staging):
                planes, size, event = slots.stage(packer, *shard_bounds(start, stop, local_n, i))
                shards.append((planes, event))
                nbytes += size
            SCAN_STATS.bump(bytes_packed=nbytes)
            SCAN_STATS.record_staged(nbytes, overlapped=staged is not None)
            previous, staged = staged, (packer, shards, start, stop, op_luts, enc_luts,
                                        next(chunk_ids))
            if previous is not None:
                scan_staged(previous)

    try:
        for batch in itertools.chain([first] if first is not None else [], batches):
            SCAN_STATS.bump(rows_scanned=batch.num_rows)
            scan_batch({name: batch[name] for name in needed}, batch.num_rows)
    finally:
        batches.close()
    if first is None:
        scan_batch({c.name: c for c in empty_columns(schema, needed)}, 0)
    scan_staged(staged)  # the last chunk has no successor to overlap

    results = device_call(fold.fetch_unflatten, "fetch", what="stream fetch",
                          deadline=device_deadline, device=device)
    host_gather.add(results, final=True)
    for result, gathered in zip(results, host_gather.blocks):
        result.update(gathered)
    SCAN_STATS.last_scan_fetches = SCAN_STATS.device_fetches - fetches_before
    return results


# -- micro-batched group scan (incremental streams) --------------------------

#: byte alignment of every batch's slot in a group's stacked buffer: a
#: batch's planes then sit at the alignment a fresh allocation has, so its
#: reductions take the same vectorised paths (and bits) as its own scan's
_SLOT_ALIGN = 512


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _SLOT_ALIGN) * _SLOT_ALIGN


class DeferredGroupScan:
    """K batches scanned from one stacked copy, fetched ONCE: ``results()``
    drains the (K, S) device tensor and returns one list of per-op leaf
    dicts a batch, each equal to that batch's own ``run_scan``."""

    def __init__(self, device_out: torch.Tensor, fold: "_DeviceFoldPlan",
                 dispatch_fetches: int, deadline: Optional[float] = None):
        self._device_out = device_out
        self._fold = fold
        self._deadline = deadline
        self._results: Optional[list] = None
        SCAN_STATS.bump(group_fetches=dispatch_fetches)

    def results(self) -> list:
        if self._results is None:
            with SCAN_STATS.tally() as own:
                (host,) = device_call(lambda: fetch(self._device_out), "fetch",
                                      what="group scan fetch", deadline=self._deadline,
                                      device=self._device_out.device)
            SCAN_STATS.bump(group_fetches=own.counts.get("device_fetches", 0))
            self._results = [self._fold.unflatten(row, 1) for row in host]
            self._device_out = None
        return self._results


def group_scannable(tables, ops, mesh: Optional[Mesh] = None):
    """The shared packer layout (truthy) when :func:`run_scan_group` can
    take these batches, else False: no mesh (a group scan runs on one
    device; over a mesh each batch takes its own sharded scan), equal
    non-zero sizes, each within one
    chunk of the serial scan's rule, none persisted or streaming, one dtype a needed
    column and one packer layout (the reference's rule,
    ``deequ_tpu/ops/scan_engine.py:group_scannable``). A bigger batch would
    scan in several chunks and merge them — another association than the
    group's, which the bit-for-bit contract forbids — and a union layout
    would pack some batch otherwise than its own scan does. The port needs
    no rule against dictionary-baked ops: an op reads each batch's own
    dictionary and lookup tables when it runs."""
    needed = sorted({c for op in ops for c in op.columns})
    if mesh is not None:
        return False
    if any(getattr(t, "is_streaming", False) for t in tables):
        return False  # a stream's batches scan through its own pipeline
    first = tables[0]
    if any(n not in first for n in needed):
        return False
    sig = [(n, first[n].dtype) for n in needed]
    n_rows = first.num_rows
    if n_rows == 0 or n_rows > _auto_chunk_rows({n: first[n] for n in needed}):
        return False
    layout0 = None
    for t in tables:
        if t.num_rows != n_rows or getattr(t, "is_persisted", False):
            return False
        if any(n not in t for n in needed) or [(n, t[n].dtype) for n in needed] != sig:
            return False
        layout = _ChunkPacker({n: t[n] for n in needed},
                              encode=encoded_ingest_enabled()).layout()
        if layout0 is None:
            layout0 = layout
        elif layout != layout0:
            return False
    return layout0


def _stack_luts(ops, tables) -> List[Tuple[str, str, np.ndarray]]:
    """Each op lookup table of each batch, padded along its last axis to
    the group's largest power of two (a gather never reaches the padding:
    a code stays below its own dictionary's size): (column, key, (K, ...,
    L) host array)."""
    from deequ_tpu_torch.ops.lut_cache import dictionary_lut

    specs = {}
    for op in ops:
        for col, key, build in op.luts:
            specs.setdefault((col, key), build)
    out = []
    for (col, key), build in specs.items():
        per_table = [np.asarray(dictionary_lut(t[col].dictionary, key, build))
                     for t in tables]
        target = 1
        while target < max(a.shape[-1] for a in per_table):
            target <<= 1
        stacked = np.zeros((len(tables),) + per_table[0].shape[:-1] + (target,),
                           dtype=per_table[0].dtype)
        for k, a in enumerate(per_table):
            stacked[k, ..., : a.shape[-1]] = a
        out.append((col, key, stacked))
    return out


class _GroupBuffer:
    """K equal-size tables packed into ONE host buffer and copied to the
    device once: per plane (then per op lookup table) K aligned slots, one
    a table, each the shape that table's own scan packs. The slots are
    views of the one device copy (:meth:`planes`, :meth:`op_luts`)."""

    def __init__(self, packers: Sequence[_ChunkPacker], n: int, ops: Sequence[ScanOp],
                 tables):
        self.K = len(packers)
        self.luts = _stack_luts(ops, tables)
        shapes = [((rows, n), np.dtype(dt))
                  for rows, dt in zip(packers[0].plane_rows(), _ChunkPacker.PLANE_DTYPES)]
        shapes += [(arr.shape[1:], arr.dtype) for _, _, arr in self.luts]
        self.shapes = shapes
        self._torch_dtypes = [torch.from_numpy(np.empty(0, dtype=dt)).dtype for _, dt in shapes]
        self.slots, total = [], 0
        for shape, dt in shapes:
            size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self.slots.append((total, _aligned(size), size))
            total += self.K * _aligned(size)
        self.host = np.empty(total, dtype=np.uint8)
        for k, packer in enumerate(packers):
            packer.pack(0, n, out=tuple(self._host_view(i, k) for i in range(4)))
        for j, (_, _, arr) in enumerate(self.luts):
            for k in range(self.K):
                self._host_view(4 + j, k)[...] = arr[k]
        self.dev: Optional[torch.Tensor] = None

    def _host_view(self, i: int, k: int) -> np.ndarray:
        base, step, size = self.slots[i]
        off = base + k * step
        shape, dt = self.shapes[i]
        return self.host[off:off + size].view(dt).reshape(shape)

    def to_device(self, device) -> None:
        """The one host->device copy."""
        with device_boundary("transfer"):
            self.dev = torch.from_numpy(self.host).to(device)

    def _dev_view(self, i: int, k: int) -> torch.Tensor:
        base, step, size = self.slots[i]
        shape = self.shapes[i][0]
        tdt = self._torch_dtypes[i]
        if size == 0:
            return torch.empty(shape, dtype=tdt, device=self.dev.device)
        off = base + k * step
        return self.dev[off:off + size].view(tdt).reshape(shape)

    def planes(self, k: int) -> List[torch.Tensor]:
        return [self._dev_view(i, k) for i in range(4)]

    def op_luts(self, k: int) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for j, (col, key, _) in enumerate(self.luts):
            out.setdefault(col, {})[key] = self._dev_view(4 + j, k)
        return out


#: a group scan resolves its tables' K1 tasks in batches holding at most
#: this many rows (at least one table): a task keeps its derived tensors
#: (predicates, where-masks, casts) on the device until it resolves, so the
#: cap bounds the group scan's device memory beyond its input buffer, while
#: a window of one-chunk batches up to this size still takes one launch
GROUP_K1_ROWS = 1 << 21


def _group_rows(buffer: _GroupBuffer, packers: Sequence[_ChunkPacker], ops: Sequence[ScanOp],
                needed, n: int, device, fold: Optional["_DeviceFoldPlan"] = None,
                caller: str = "group", k1_rows: Optional[int] = None):
    """Every table of ``buffer`` through ``ops`` on views of its slot — the
    shapes its own scan gives it — and into row k of one (K, S) tensor:
    the K tables' K1 tasks resolved in batches of at most ``k1_rows`` rows
    (None: ONE batch) and their elementwise entries merged in ONE
    ``merge_tags`` (``_DeviceFoldPlan.flatten_rows``, ``single_rows``),
    each row bit for bit its table's own one-chunk scan. ``fold``: a fold
    plan built for these ops at ``n`` rows (None: built from the first
    table's partials). Returns (out, fold)."""
    row_valid = torch.ones(n, dtype=torch.bool, device=device)
    flats, rows = [], []
    for k, packer in enumerate(packers):
        vals = packer.unpack_vals(*buffer.planes(k), row_valid, buffer.op_luts(k),
                                  packer.enc_luts(device), needed)
        rows.append([op.update(vals, row_valid, n, n) for op in ops])
        SCAN_STATS.bump(chunks_processed=1)
        if fold is None:
            fold = _DeviceFoldPlan(ops, rows[0], 1, device)
        if k1_rows is not None and len(rows) * n >= k1_rows:
            flats.append(fold.flatten_rows(rows, row_valid))
            rows = []
    if rows:
        flats.append(fold.flatten_rows(rows, row_valid))
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    return fold.single_rows(flat, caller), fold


def run_scan_group(tables, ops: Sequence[ScanOp], device, layout=None) -> DeferredGroupScan:
    """One pass over K batches that :func:`group_scannable` admitted: every
    batch's planes (and its op lookup tables) packed into ONE host buffer,
    each batch in a slot of its own, and copied to ``device`` once
    (:class:`_GroupBuffer`); each batch's ``op.update`` then runs on views
    of its slot — the shapes its own ``run_scan`` gives it — and the K
    batches' reductions resolve in one K1 batch every
    :data:`GROUP_K1_ROWS` rows and one fold merge into the rows of one
    (K, S) tensor, fetched once by ``results()`` (:func:`_group_rows`). No
    reduction runs across batches: a stacked (K, n) reduction would
    associate otherwise than the 1-D one and break the bit-for-bit
    contract."""
    device = torch.device(device)
    K = len(tables)
    n = tables[0].num_rows
    if any(t.num_rows != n for t in tables):
        raise ValueError("run_scan_group needs equal-size batches (group_scannable)")
    needed = sorted({c for op in ops for c in op.columns})
    encode = encoded_ingest_enabled()
    packers = [_ChunkPacker({name: t[name] for name in needed}, encode=encode)
               for t in tables]
    if layout is not None and packers[0].layout() != layout:
        raise ValueError("run_scan_group: the batches' layout is not the admitted one")
    plan = plan_scan_ops(ops, packers[0], False, None, n)
    ops = plan.ops
    with SCAN_STATS.tally() as own:
        buffer = _GroupBuffer(packers, n, ops, tables)
        SCAN_STATS.bump(bytes_packed=buffer.host.nbytes)
        buffer.to_device(device)
        SCAN_STATS.bump(scan_passes=1, group_scan_passes=1, rows_scanned=K * n,
                        device_sort_passes=plan.sort_ops * K,
                        encoded_scan_passes=int(bool(plan.encoded_columns)))
        deadline = default_device_deadline()
        # a device boundary under the process deadline, like a scan's step;
        # a group scan has no ladder (the reference's has none either)
        out, fold = device_call(lambda: _group_rows(buffer, packers, ops, needed, n, device,
                                                    k1_rows=GROUP_K1_ROWS),
                                "execute", what=f"group scan of {K} batches",
                                deadline=deadline, device=device)
    return DeferredGroupScan(out, fold, own.counts.get("device_fetches", 0), deadline)
