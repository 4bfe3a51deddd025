"""SpillingFrequencyStore — bounded-RSS accumulation of grouping states.

The engine-level answer to the reference's spillable shuffle
(GroupingAnalyzers.scala:66-78 backed by Spark's ExternalSorter, with the
StorageLevel knob at AnalysisRunner.scala:493-497): frequency-state deltas
fold into an in-RAM tree (the same binary-counter fold as
StreamStateFolder) until the tail exceeds a configurable byte budget, at
which point the tail collapses, canonically sorts, and flushes to disk as
one sorted run (spill/runs.py). Finalize streams the runs back through a
bounded-fan-in k-way merge (spill/merge.py) as sorted, globally-unique
blocks — the metric layer consumes those blocks without ever holding the
full frequency table (analyzers/grouping.py), so a grouping whose distinct
count outgrows RAM degrades to disk bandwidth instead of OOM.

``SpilledFrequencies`` is the resulting State: still a member of the same
commutative monoid (``sum`` re-spills through a fresh store), still
serializable (states/serde.py tag 13), with metric math running over the
streamed blocks.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.analyzers.base import State, StreamStateFolder
from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
from deequ_tpu_torch.spill.merge import collapse_runs, merge_runs
from deequ_tpu_torch.spill.order import is_strictly_ascending, merge_add_sorted
from deequ_tpu_torch.spill.runs import Block, RunWriter

# flush the in-RAM tail at this fraction of the budget: headroom for the
# collapse's merge scratch (~2x the tail transiently) and the finalize
# merger's per-run buffers
SPILL_FRACTION = 0.5

# default in-RAM group budget when spilling is requested without a size
DEFAULT_BUDGET_BYTES = 512 << 20

_ENV_BUDGET = "DEEQU_TORCH_GROUP_MEMORY_BUDGET"


def resolve_group_budget(data=None, explicit: Optional[int] = None) -> Optional[int]:
    """Budget resolution: explicit argument > table attribute > environment
    variable (bytes). None = unbounded (the pre-spill behavior)."""
    if explicit is not None:
        return int(explicit)
    attr = getattr(data, "group_memory_budget", None)
    if attr is not None:
        return int(attr)
    from deequ_tpu_torch.envcfg import env_value

    return env_value(_ENV_BUDGET)


def budget_batch_rows(budget_bytes: int) -> int:
    """Rows per slice when a budgeted in-memory table re-dispatches
    through the streaming fold (runner grouping + own-pass branches):
    ~256B/row of grouping state keeps each batch's delta inside the spill
    threshold, floored at 64K rows (dispatch amortization) and capped at
    16M (slice cost)."""
    return int(min(max(budget_bytes // 256, 1 << 16), 1 << 24))


def state_nbytes(state: FrequenciesAndNumRows) -> int:
    n = state.counts.nbytes
    for v, m in zip(state.key_values, state.key_nulls):
        n += v.nbytes + m.nbytes
    return n


_NUMERIC_KINDS = set("iufb")


class SpillingFrequencyStore:
    """Accumulates FrequenciesAndNumRows deltas under a byte budget,
    spilling sorted runs to disk past it. ``result()`` returns a plain
    in-RAM state when nothing spilled (zero behavior change for data that
    fits) or a ``SpilledFrequencies`` otherwise."""

    def __init__(
        self,
        columns: Sequence[str],
        budget_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
    ):
        self.columns = tuple(columns)
        self.budget_bytes = int(budget_bytes or DEFAULT_BUDGET_BYTES)
        self._spill_dir = spill_dir
        self._tmpdir: Optional[str] = None
        self._finalizer = None
        self._result_taken = False
        self._folder = StreamStateFolder()
        self._tail_bytes = 0
        self._all_canonical = True
        self._run_paths: List[str] = []
        self._spilled_num_rows = 0
        self._bytes_per_group = 64.0  # refined from real flushes
        # running per-column dtype promotion (None until a typed, not
        # all-null column is seen); int ranges tracked so a later
        # promotion to float64 can refuse >2^53 keys like sum() does
        self._dtypes: List[Optional[np.dtype]] = [None] * len(self.columns)
        self._int_lo = [0] * len(self.columns)
        self._int_hi = [0] * len(self.columns)

    # -- budget accounting ---------------------------------------------------

    def _ensure_tmpdir(self) -> str:
        if self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(
                prefix="deequ_spill_", dir=self._spill_dir
            )
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, self._tmpdir, ignore_errors=True
            )
        return self._tmpdir

    def _track_dtypes(self, state: FrequenciesAndNumRows) -> None:
        for i, (v, m) in enumerate(zip(state.key_values, state.key_nulls)):
            if len(v) == 0 or bool(m.all()):
                continue  # empty/all-null columns constrain nothing
            kind = v.dtype.kind
            if kind in "iu":
                lo = int(v[~m].min()) if (~m).any() else 0
                hi = int(v[~m].max()) if (~m).any() else 0
                self._int_lo[i] = min(self._int_lo[i], lo)
                self._int_hi[i] = max(self._int_hi[i], hi)
            have = self._dtypes[i]
            if have is None:
                self._dtypes[i] = (
                    np.dtype(np.str_) if kind in "USO" else v.dtype
                )
                continue
            have_num = have.kind in _NUMERIC_KINDS
            new_num = kind in _NUMERIC_KINDS
            if have_num != new_num:
                raise ValueError(
                    f"cannot spill frequency states with mismatched "
                    f"group-key types ({have} vs {v.dtype}) for columns "
                    f"{self.columns}"
                )
            if have_num:
                common = np.promote_types(have, v.dtype)
                if common.kind == "f" and (
                    self._int_hi[i] > 2 ** 53 or self._int_lo[i] < -(2 ** 53)
                ):
                    raise ValueError(
                        "cannot merge integer group keys above 2^53 into a "
                        "float64-promoted key space: promotion would "
                        "collapse distinct keys"
                    )
                self._dtypes[i] = common

    # -- accumulation --------------------------------------------------------

    def add(self, state: Optional[State], canonical: bool = False) -> None:
        """Fold one frequency delta in; spill when the tail exceeds the
        budget's spill threshold. ``canonical=True`` asserts the delta is
        already in canonical key order (e.g. built by
        ``group_counts_state(..., canonicalize=True)``), letting flushes
        skip the re-sort."""
        if state is None:
            return
        if isinstance(state, SpilledFrequencies):
            # merging an already-spilled state in: stream its blocks
            if tuple(state.columns) != self.columns:
                raise ValueError(
                    f"cannot spill frequency states over different "
                    f"columns: {self.columns} vs {tuple(state.columns)}"
                )
            self._spilled_num_rows += state.num_rows
            for kv, kn, counts in state.blocks():
                self.add(
                    FrequenciesAndNumRows(self.columns, kv, kn, counts, 0),
                    canonical=True,
                )
            return
        if not isinstance(state, FrequenciesAndNumRows):
            raise TypeError(
                f"spill store holds frequency states, got "
                f"{type(state).__name__}"
            )
        if state.columns != self.columns:
            raise ValueError(
                f"cannot spill frequency states over different columns: "
                f"{self.columns} vs {state.columns}"
            )
        self._track_dtypes(state)
        # VERIFY canonical claims (O(G) adjacent-row compare) instead of
        # trusting provenance: a mis-claimed delta would silently corrupt
        # the k-way merge's prefix-slicing argument
        if canonical:
            canonical = is_strictly_ascending(
                state.key_values, state.key_nulls
            )
        # pre-flush: folding a delta onto a near-threshold tail would
        # overshoot the budget by up to one delta; flushing first bounds
        # the peak at max(threshold, one delta) instead
        if (
            self._tail_bytes
            and self._tail_bytes + state_nbytes(state)
            >= self.budget_bytes * SPILL_FRACTION
        ):
            self._flush()
        if not canonical:
            self._all_canonical = False
        self._folder.add(state)
        self._tail_bytes = sum(
            state_nbytes(s) for _, s in self._folder._stack
        )
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        SCAN_STATS.raise_to(peak_group_state_bytes=self._tail_bytes)
        if self._tail_bytes >= self.budget_bytes * SPILL_FRACTION:
            self._flush()

    def _collapse(self) -> Optional[FrequenciesAndNumRows]:
        merged = self._folder.result()
        self._folder = StreamStateFolder()
        self._tail_bytes = 0
        return merged

    def _run_block_groups(self) -> int:
        """Groups per run block, sized so a finalize merge of
        ``_max_fanin()`` runs buffers ~budget/4 bytes total."""
        target_bytes = max(
            1 << 20, int(self.budget_bytes / 4 / self._max_fanin())
        )
        return max(4096, int(target_bytes / max(self._bytes_per_group, 1.0)))

    def _max_fanin(self) -> int:
        return 16

    def _flush(self) -> None:
        merged = self._collapse()
        if merged is None or merged.num_groups == 0:
            if merged is not None:
                self._spilled_num_rows += merged.num_rows
            return
        kv, kn, counts = merged.key_values, merged.key_nulls, merged.counts
        # sum() emits canonical order, but a single un-merged delta keeps
        # its producer's order — sort AND dedup unless every input was
        # verified canonical (merge_add_sorted also collapses duplicate
        # keys a lone unsorted delta may carry, keeping the run's
        # unique-keys invariant)
        if not self._all_canonical:
            kv, kn, counts = merge_add_sorted([(kv, kn, counts)])
        self._bytes_per_group = max(
            1.0, state_nbytes(merged) / max(merged.num_groups, 1)
        )
        path = os.path.join(
            self._ensure_tmpdir(), f"run_{len(self._run_paths):05d}.run"
        )
        writer = RunWriter(path, len(self.columns))
        bg = self._run_block_groups()
        for start in range(0, len(counts), bg):
            end = start + bg
            writer.write_block(
                tuple(v[start:end] for v in kv),
                tuple(m[start:end] for m in kn),
                counts[start:end],
            )
        writer.close()
        self._run_paths.append(path)
        self._spilled_num_rows += merged.num_rows
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        SCAN_STATS.bump(spill_runs=1)
        SCAN_STATS.bump(spill_bytes_written=writer.bytes_written)
        # subsequent tails start empty and re-canonical
        self._all_canonical = True

    def _adopt_sorted_blocks(
        self, blocks: Iterator[Block], num_rows: int
    ) -> None:
        """Install pre-merged (globally sorted, key-unique) blocks as one
        run — used by serde decode so a persisted spilled state round-trips
        without materializing."""
        path = os.path.join(
            self._ensure_tmpdir(), f"run_{len(self._run_paths):05d}.run"
        )
        writer = RunWriter(path, len(self.columns))
        for kv, kn, counts in blocks:
            self._track_dtypes(
                FrequenciesAndNumRows(self.columns, kv, kn, counts, 0)
            )
            writer.write_block(kv, kn, counts)
        writer.close()
        self._run_paths.append(path)
        self._spilled_num_rows += num_rows

    # -- finalize ------------------------------------------------------------

    def result(self) -> Optional[State]:
        self._result_taken = True
        if not self._run_paths:
            # nothing spilled: plain state (or None). Rows folded in via
            # already-spilled INPUT states (whose blocks carry num_rows=0)
            # are tracked in _spilled_num_rows and must be re-added here.
            merged = self._collapse()
            if self._spilled_num_rows == 0:
                return merged
            if merged is None:
                return FrequenciesAndNumRows(
                    self.columns,
                    tuple(np.empty(0) for _ in self.columns),
                    tuple(np.zeros(0, dtype=bool) for _ in self.columns),
                    np.zeros(0, dtype=np.int64),
                    self._spilled_num_rows,
                )
            return FrequenciesAndNumRows(
                merged.columns, merged.key_values, merged.key_nulls,
                merged.counts, merged.num_rows + self._spilled_num_rows,
            )
        self._flush()
        return SpilledFrequencies(self)

    def blocks(self, out_groups: Optional[int] = None) -> Iterator[Block]:
        """Merged, canonically sorted, globally key-unique blocks across
        all runs. Each call re-streams from disk — but the cascade that
        collapses >fan-in runs happens ONCE (the collapsed run set
        replaces ``_run_paths``), so repeat consumers (count stats,
        Histogram top-N, MI's two passes, serde encode) pay only the
        final in-memory merge."""
        og = out_groups or self._run_block_groups()
        if len(self._run_paths) > self._max_fanin():
            self._run_paths = collapse_runs(
                self._run_paths,
                len(self.columns),
                dtypes=self._dtypes,
                out_groups=og,
                max_fanin=self._max_fanin(),
                scratch_dir=self._ensure_tmpdir(),
            )
        yield from merge_runs(
            self._run_paths,
            len(self.columns),
            dtypes=self._dtypes,
            out_groups=og,
            max_fanin=self._max_fanin(),
            scratch_dir=self._ensure_tmpdir(),
        )

    @property
    def num_rows(self) -> int:
        return self._spilled_num_rows

    def release(self) -> None:
        if self._finalizer is not None:
            self._finalizer()

    # -- context manager -----------------------------------------------------
    #
    # ``with SpillingFrequencyStore(...) as store:`` guarantees the temp
    # spill directory never outlives a FAILED run: an exception inside the
    # block releases it immediately (instead of waiting on GC finalizers,
    # which a crashing process may never run in a predictable order). A
    # normal exit keeps the directory alive only when ``result()`` was
    # taken — a SpilledFrequencies result streams its runs from that
    # directory, so the consumer (or its weakref finalizer) owns cleanup.

    def __enter__(self) -> "SpillingFrequencyStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None or not self._result_taken:
            self.release()
        return False


class SpilledFrequencies(State):
    """A frequency state whose groups live in sorted runs on disk.

    Same monoid, same metrics — but consumers iterate ``blocks()`` instead
    of touching whole-table arrays. ``count_stats()`` (one streaming pass,
    cached) covers every count-distribution analyzer; Histogram's top-N
    and MutualInformation stream their own passes
    (analyzers/grouping.py)."""

    def __init__(self, store: SpillingFrequencyStore):
        self._store = store
        self.columns = store.columns
        self.num_rows = store.num_rows
        self._stats = None

    def blocks(self, out_groups: Optional[int] = None) -> Iterator[Block]:
        return self._store.blocks(out_groups)

    # -- monoid --------------------------------------------------------------

    def sum(self, other: State) -> State:
        if isinstance(other, (FrequenciesAndNumRows, SpilledFrequencies)):
            if tuple(other.columns) != self.columns:
                raise ValueError(
                    f"cannot merge frequency states over different "
                    f"columns: {self.columns} vs {tuple(other.columns)}"
                )
            merged = SpillingFrequencyStore(
                self.columns,
                self._store.budget_bytes,
                spill_dir=self._store._spill_dir,
            )
            merged.add(self, canonical=True)
            merged.add(other, canonical=isinstance(other, SpilledFrequencies))
            return merged.result()
        return NotImplemented

    # -- streamed aggregates -------------------------------------------------

    def count_stats(self):
        """CountStats over the streamed blocks (cached single disk pass):
        integer aggregates are exact vs the in-RAM path; entropy sums
        blockwise partials (ulp-level association difference only)."""
        if self._stats is None:
            from deequ_tpu_torch.ops.segment import CountStats

            num_groups = 0
            singletons = 0
            neg_plogp = 0.0
            n = self.num_rows
            for _kv, _kn, counts in self.blocks():
                num_groups += len(counts)
                singletons += int((counts == 1).sum())
                if n > 0:
                    p = counts.astype(np.float64) / n
                    neg_plogp += float(-(p * np.log(p)).sum())
            entropy = neg_plogp if (n > 0 and num_groups > 0) else float("nan")
            self._stats = CountStats(n, num_groups, singletons, entropy)
        return self._stats

    @property
    def num_groups(self) -> int:
        return self.count_stats().num_groups

    # -- materialization (small states / tests / compatibility) --------------

    def to_frequencies(self) -> FrequenciesAndNumRows:
        """Materialize the full in-RAM state — O(#groups) host memory;
        escape hatch for consumers with no block path (MutualInformation
        marginal join, tests)."""
        kvs: List[List[np.ndarray]] = [[] for _ in self.columns]
        kns: List[List[np.ndarray]] = [[] for _ in self.columns]
        counts: List[np.ndarray] = []
        for kv, kn, c in self.blocks():
            for i in range(len(self.columns)):
                kvs[i].append(kv[i])
                kns[i].append(kn[i])
            counts.append(c)
        if not counts:
            return FrequenciesAndNumRows(
                self.columns,
                tuple(np.empty(0) for _ in self.columns),
                tuple(np.zeros(0, dtype=bool) for _ in self.columns),
                np.zeros(0, dtype=np.int64),
                self.num_rows,
            )
        return FrequenciesAndNumRows(
            self.columns,
            tuple(np.concatenate(parts) for parts in kvs),
            tuple(np.concatenate(parts) for parts in kns),
            np.concatenate(counts),
            self.num_rows,
        )

    def as_dict(self) -> Dict[tuple, int]:
        return self.to_frequencies().as_dict()

    def __eq__(self, other) -> bool:
        if isinstance(other, (SpilledFrequencies, FrequenciesAndNumRows)):
            return (
                tuple(self.columns) == tuple(other.columns)
                and self.num_rows == other.num_rows
                and self.as_dict() == other.as_dict()
            )
        return NotImplemented

    __hash__ = None  # mutable disk-backed payload

    def __repr__(self) -> str:
        return (
            f"SpilledFrequencies(columns={self.columns}, "
            f"runs={len(self._store._run_paths)}, num_rows={self.num_rows})"
        )
