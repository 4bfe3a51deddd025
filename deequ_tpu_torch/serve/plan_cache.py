"""The plan cache — a repeat tenant builds nothing (the counterpart of
``deequ_tpu/serve/plan_cache.py``).

A small suite costs the card microseconds, but a fresh submission pays
op construction, the kernel plan, the fold's index tensors on the device
and the unflatten recipe. For many small suites those fixed costs are the
latency, so the serving layer caches everything above the dispatch:

- :class:`PlanKey` — the suite's fingerprint: the needed columns' schema,
  the de-duplicated analyzer tuple (analyzers are value objects, their
  ``where`` predicates included), the packer layout (which planes each
  column rides: it depends on the data, e.g. on which columns hold
  nulls) and the row count (a coalesced batch's members share one);
- :class:`ServePlan` — one entry: the built ops and extract plan, the
  layout, whether its members may coalesce (and why not), and its
  programs by device;
- a *program*, what the port builds for a plan on a device: the
  ``plan_scan_ops`` result (the ops in canonical order, each with its
  kernel chosen), the ``_DeviceFoldPlan`` whose index tensors live on the
  device, and with it the unflatten recipe. A hit builds none of them;
- :class:`PlanCache` — a bounded LRU of ServePlans;
- :class:`SubPlanKey` / :data:`SUBPLAN_CACHE` — programs shared below the
  exact key: two suites whose analyzer sets are permutations of one
  another have distinct plan keys (``analyzer_sig`` keeps the submission
  order, which the result path needs) but run one program, built in
  :func:`canonical_op_order`; the second adopts it with its own
  permutation and builds nothing.

``ScanStats.plan_cache_hits`` / ``plan_cache_misses`` count suites whose
batch found or built its program (``serve/executor.py`` accounts them a
batch, by member); ``programs_built`` / ``programs_reused`` count batches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class _BoundedLRU:
    """A bounded LRU over a dict (insertion order is recency), under a
    lock: a fleet reads a worker's cache from another thread to warm a
    joiner while the worker uses it."""

    def __init__(self, cap: int):
        self.cap = cap
        self._d: Dict[Any, Any] = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            val = self._d.pop(key, None)
            if val is not None:
                self._d[key] = val  # most recently used last
            return val

    def put(self, key, val) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = val
            while len(self._d) > self.cap:
                self._d.pop(next(iter(self._d)))

    def values(self) -> List[Any]:
        """The values, least recently used first."""
        with self._lock:
            return list(self._d.values())

    def items(self) -> Dict[Any, Any]:
        """A copy of the entries, least recently used first."""
        with self._lock:
            return dict(self._d)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


@dataclass(frozen=True)
class PlanKey:
    """The suite's fingerprint (module doc): ``schema_sig`` ((column,
    dtype), ...) over the needed columns sorted by name, ``analyzer_sig``
    the de-duplicated analyzers in evaluation order, ``layout_sig`` the
    packer layout, ``chunk`` the member row count."""

    schema_sig: Tuple
    analyzer_sig: Tuple
    layout_sig: Tuple
    chunk: int


@dataclass
class ServePlan:
    """One cached suite plan, built once a PlanKey (module doc)."""

    key: Optional[PlanKey]
    #: the de-duplicated analyzers in evaluation order
    analyzers: Tuple
    #: the scan analyzers whose op built, their exec ops after the KLL
    #: merge, and extract_plan[i] = (exec index, extractor or None)
    scannable: Tuple
    exec_ops: Tuple
    extract_plan: Tuple
    #: analyzers whose op failed to build {analyzer: exception}: failure
    #: metrics for every member
    op_failures: Dict
    #: analyzers whose schema preconditions failed {analyzer: exception}
    precondition_failures: Dict = field(default_factory=dict)
    #: the packer layout every member packs to
    layout: Tuple = ()
    #: the needed columns, sorted
    needed: Tuple = ()
    #: programs by device: str(device) -> program (module doc)
    programs: Dict = field(default_factory=dict)
    #: False (with the reason) when members of this plan cannot coalesce:
    #: grouping or own-pass analyzers, a table past one chunk, no op
    coalescable: bool = True
    why_not: str = ""
    #: the reason belongs to the analyzer set, not to the table it was
    #: built from: only such a verdict may be cached by analyzer set (a
    #: missing column or an empty table must not refuse other tenants)
    serial_class: bool = False

    def program_for(self, device):
        return self.programs.get(str(device))

    def put_program(self, device, program) -> None:
        self.programs[str(device)] = program


class PlanCache:
    """A bounded LRU of ServePlans."""

    def __init__(self, cap: int = 256):
        self._lru = _BoundedLRU(cap)

    def get(self, key: PlanKey) -> Optional[ServePlan]:
        return self._lru.get(key)

    def put(self, plan: ServePlan) -> None:
        self._lru.put(plan.key, plan)

    def __len__(self) -> int:
        return len(self._lru)

    def entries(self) -> List[ServePlan]:
        """The cached plans, most recently used last: the fleet's hot-plan
        feed for a joining worker."""
        return self._lru.values()

    def clear(self) -> None:
        self._lru.clear()


@dataclass(frozen=True)
class SubPlanKey:
    """A program's identity below the exact PlanKey (module doc): the exec
    ops' identities in canonical order, the schema and layout, the row
    count, the plan's kernel variants and the device."""

    ops_sig: Tuple
    schema_sig: Tuple
    layout_sig: Tuple
    chunk: int
    variant: str
    hist_variant: str
    ingest_variant: str
    device: str


class SubPlanCache:
    """A bounded LRU of programs by :class:`SubPlanKey` (the serving
    workers of a process share it; the LRU's lock covers them). A program
    is stored in canonical op order; each plan that adopts one keeps its
    own permutation beside it."""

    def __init__(self, cap: int = 128):
        self._lru = _BoundedLRU(cap)

    def get(self, key: SubPlanKey):
        return self._lru.get(key)

    def put(self, key: SubPlanKey, program) -> None:
        self._lru.put(key, program)

    def __len__(self) -> int:
        return len(self._lru)

    def clear(self) -> None:
        self._lru.clear()


#: the process-wide program cache (``serve/executor.py`` reads it on every
#: program miss of an exact plan key before it builds)
SUBPLAN_CACHE = SubPlanCache()


def op_identities(plan: ServePlan) -> Tuple[Tuple, ...]:
    """Each exec op's identity: the analyzers it serves, in suite order.
    A merged KLL op stacks its columns in that order, so the tuple names
    the op whole; a lone analyzer's op is its analyzer."""
    served: List[List] = [[] for _ in plan.exec_ops]
    for analyzer, (exec_idx, _) in zip(plan.scannable, plan.extract_plan):
        served[exec_idx].append(analyzer)
    return tuple(tuple(a) for a in served)


def canonical_op_order(plan: ServePlan) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The order shared programs run their ops in: exec indices sorted by
    the ops' identities (frozen dataclasses: their repr is a total order
    for one op set). Returns ``(canon, perm)``: ``canon[pos]`` is the exec
    index at canonical position ``pos``, ``perm[exec_idx]`` the canonical
    position of an exec op."""
    ids = op_identities(plan)
    canon = tuple(sorted(range(len(ids)), key=lambda i: repr(ids[i])))
    perm = [0] * len(canon)
    for pos, i in enumerate(canon):
        perm[i] = pos
    return canon, tuple(perm)


def subplan_key(plan: ServePlan, canon: Tuple[int, ...], device, variant: str,
                hist_variant: str, ingest_variant: str) -> SubPlanKey:
    """The :class:`SubPlanKey` of ``plan``'s program on ``device``."""
    ids = op_identities(plan)
    return SubPlanKey(
        ops_sig=tuple(ids[i] for i in canon),
        schema_sig=plan.key.schema_sig,
        layout_sig=plan.key.layout_sig,
        chunk=plan.key.chunk,
        variant=variant,
        hist_variant=hist_variant,
        ingest_variant=ingest_variant,
        device=str(device),
    )


def schema_signature(table, needed) -> Tuple:
    """((column, dtype), ...) over ``needed`` (sorted): the schema half of
    the fingerprint."""
    return tuple((n, table[n].dtype) for n in needed)


def layout_signature(layout) -> Tuple:
    """The packer layout as a key (``_ChunkPacker.layout()``: the planes'
    row names, already a tuple of tuples)."""
    return tuple(tuple(names) for names in layout)


def build_serve_plan(table, analyzers, key_hint: Optional[PlanKey] = None) -> ServePlan:
    """The ServePlan of ``analyzers`` over ``table``'s shape: the schema
    preconditions, op construction (an op that fails to build fails only
    its analyzer, the runner's rule), the KLL merge, the layout and
    whether members may coalesce. The cache's hit/miss ledger is the
    executor's (by program)."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer, find_first_failing
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner, _is_grouping_shared
    from deequ_tpu_torch.ops.scan_engine import _auto_chunk_rows, _ChunkPacker
    from deequ_tpu_torch.ops.scan_plan import encoded_ingest_enabled

    analyzers = tuple(analyzers)
    precondition_failures: Dict = {}
    passed = []
    for a in analyzers:
        exc = find_first_failing(table.schema, a.preconditions())
        if exc is None:
            passed.append(a)
        else:
            precondition_failures[a] = exc
    scanning = [a for a in passed
                if isinstance(a, ScanShareableAnalyzer) and not _is_grouping_shared(a)]
    non_scan = [a for a in passed if a not in scanning]

    coalescable, why, serial_class = True, "", False
    if non_scan:
        # grouping and own-pass analyzers need passes of their own (the
        # runner's): a suite holding any serves serially, for every table
        coalescable, serial_class = False, True
        why = f"non-scan-shareable analyzers: {[str(a) for a in non_scan]}"
    ops, scannable, op_failures = AnalysisRunner._build_scan_ops(table, scanning)
    exec_ops: Tuple = ()
    extract_plan: Tuple = ()
    layout: Tuple = ()
    needed: Tuple = ()
    if scannable:
        exec_list, plan_list = AnalysisRunner._coalesce_scan_ops(ops)
        exec_ops, extract_plan = tuple(exec_list), tuple(plan_list)
        needed = tuple(sorted({c for op in exec_ops for c in op.columns}))
        cols = {n: table[n] for n in needed}
        n_rows = int(table.num_rows)
        if n_rows == 0:
            coalescable = False
            why = why or "empty table"
        elif n_rows > _auto_chunk_rows(cols):
            # a member past one chunk would fold several chunks, another
            # association than its coalesced row (group_scannable's rule)
            coalescable = False
            why = why or "table exceeds the single-chunk coalesce bound"
        layout = layout_signature(_ChunkPacker(cols, encode=encoded_ingest_enabled()).layout())
    elif scanning:
        coalescable = False
        why = why or "no scannable ops"
    return ServePlan(
        key=key_hint, analyzers=analyzers, scannable=tuple(scannable), exec_ops=exec_ops,
        extract_plan=extract_plan, op_failures=dict(op_failures),
        precondition_failures=precondition_failures, layout=layout, needed=needed,
        coalescable=coalescable and bool(scannable), why_not=why, serial_class=serial_class,
    )
