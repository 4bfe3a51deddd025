"""K-way merge of sorted frequency runs — the finalize path of the spill
engine.

Classic external merge with vectorized slicing instead of a per-row heap:
each source buffers ONE block; every iteration picks the smallest
last-key among the buffers (the *boundary*), slices the ``<= boundary``
prefix off every buffer (a vectorized prefix mask — buffers are sorted),
merge-adds the prefixes (codes + lexsort + reduceat, the monoid merge),
and emits the result. Any future row of any run is strictly greater than
its buffer's last key, hence greater than the boundary, so emitted keys
are final — exactly the argument behind a loser-tree merge, paid per
block instead of per row. At least one buffer empties per iteration, so
memory stays O(sources x block_bytes) and progress is guaranteed.

Fan-in is bounded: merging more runs than the memory budget can buffer
blocks for goes through intermediate merge passes (merge fanin runs ->
one wider run on disk, repeat), the textbook external-sort cascade.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.spill.order import (
    compare_keys,
    key_at,
    leq_boundary,
    merge_add_sorted,
)
from deequ_tpu_torch.spill.runs import Block, RunReader, write_run


def _cast_column(values: np.ndarray, nulls: np.ndarray, target) -> np.ndarray:
    """Cast one key column to the store's promoted dtype. String targets
    skip casting (numpy compares unicode across widths natively); an
    all-null column of the wrong kind (a legacy placeholder) is replaced
    by zeros of the target, mirroring FrequenciesAndNumRows.sum."""
    if target is None or values.dtype == target:
        return values
    if target.kind == "U" or values.dtype.kind == "U":
        if values.dtype.kind != target.kind:
            if bool(nulls.all()):
                return np.zeros(len(values), dtype=target)
            raise ValueError(
                f"cannot merge spill blocks with mismatched key kinds "
                f"({values.dtype} vs {target})"
            )
        return values
    return values.astype(target)


class _Source:
    """One merge input: an iterator of sorted blocks + its buffer."""

    def __init__(self, blocks: Iterator[Block], dtypes):
        self._blocks = blocks
        self._dtypes = dtypes
        self.kv: Optional[Tuple[np.ndarray, ...]] = None
        self.kn: Optional[Tuple[np.ndarray, ...]] = None
        self.counts: Optional[np.ndarray] = None
        self.refill()

    def refill(self) -> bool:
        """Pull the next non-empty block; False when exhausted."""
        for kv, kn, counts in self._blocks:
            if len(counts) == 0:
                continue
            if self._dtypes is not None:
                kv = tuple(
                    _cast_column(v, m, t)
                    for v, m, t in zip(kv, kn, self._dtypes)
                )
            self.kv, self.kn, self.counts = tuple(kv), tuple(kn), counts
            return True
        self.kv = self.kn = self.counts = None
        return False

    @property
    def last_key(self):
        return key_at(self.kv, self.kn, len(self.counts) - 1)

    def take_prefix(self, boundary) -> Optional[Block]:
        """Slice off (and return) the ``<= boundary`` prefix; refills the
        buffer when fully consumed."""
        mask = leq_boundary(self.kv, self.kn, boundary)
        k = int(mask.sum())
        if k == 0:
            return None
        part = (
            tuple(v[:k] for v in self.kv),
            tuple(m[:k] for m in self.kn),
            self.counts[:k],
        )
        if k == len(self.counts):
            self.refill()
        else:
            self.kv = tuple(v[k:] for v in self.kv)
            self.kn = tuple(m[k:] for m in self.kn)
            self.counts = self.counts[k:]
        return part


def merge_block_streams(
    streams: Sequence[Iterator[Block]],
    dtypes=None,
    out_groups: int = 1 << 20,
) -> Iterator[Block]:
    """Merge canonically sorted, per-stream-unique block streams into one
    sorted, globally-unique block stream (blocks re-chunked to at most
    ``out_groups`` groups)."""
    sources = [_Source(s, dtypes) for s in streams]
    sources = [s for s in sources if s.counts is not None]
    while sources:
        if len(sources) == 1:
            # sole remaining source: its keys cannot collide with anything
            src = sources[0]
            while src.counts is not None:
                kv, kn, counts = src.kv, src.kn, src.counts
                src.refill()
                for start in range(0, len(counts), out_groups):
                    end = start + out_groups
                    yield (
                        tuple(v[start:end] for v in kv),
                        tuple(m[start:end] for m in kn),
                        counts[start:end],
                    )
            return
        boundary = sources[0].last_key
        for src in sources[1:]:
            if compare_keys(src.last_key, boundary) < 0:
                boundary = src.last_key
        parts = []
        for src in sources:
            part = src.take_prefix(boundary)
            if part is not None:
                parts.append(part)
        sources = [s for s in sources if s.counts is not None]
        if not parts:  # defensive: boundary owner always contributes
            continue
        if len(parts) == 1:
            kv, kn, counts = parts[0]
        else:
            kv, kn, counts = merge_add_sorted(parts)
        for start in range(0, len(counts), out_groups):
            end = start + out_groups
            yield (
                tuple(v[start:end] for v in kv),
                tuple(m[start:end] for m in kn),
                counts[start:end],
            )


def collapse_runs(
    paths: Sequence[str],
    n_cols: int,
    dtypes=None,
    out_groups: int = 1 << 20,
    max_fanin: int = 16,
    scratch_dir: Optional[str] = None,
) -> List[str]:
    """Cascade merge passes until at most ``max_fanin`` runs remain (the
    textbook external sort: merge fanin runs -> one wider run on disk,
    repeat). Consumed input runs are unlinked; the returned collapsed run
    set is durable, so a caller that streams the final merge repeatedly
    (count stats, Histogram top-N, MI's two passes, serde encode) pays
    the cascade's disk I/O ONCE and only the in-memory final merge per
    pass afterwards."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    paths = list(paths)
    pass_idx = 0
    while len(paths) > max_fanin:
        SCAN_STATS.bump(spill_merge_passes=1)
        next_paths: List[str] = []
        for i in range(0, len(paths), max_fanin):
            chunk = paths[i:i + max_fanin]
            if len(chunk) == 1:
                next_paths.append(chunk[0])
                continue
            base = scratch_dir or os.path.dirname(chunk[0])
            out = os.path.join(
                base, f"merge_p{pass_idx}_{i // max_fanin:04d}.run"
            )
            readers = [RunReader(p) for p in chunk]
            writer = write_run(
                out,
                merge_block_streams(
                    [r.blocks() for r in readers], dtypes, out_groups
                ),
                n_cols,
            )
            SCAN_STATS.bump(spill_bytes_written=writer.bytes_written,
                            spill_bytes_read=sum(r.bytes_read for r in readers))
            for p in chunk:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            next_paths.append(out)
        paths = next_paths
        pass_idx += 1
    return paths


def merge_runs(
    paths: Sequence[str],
    n_cols: int,
    dtypes=None,
    out_groups: int = 1 << 20,
    max_fanin: int = 16,
    scratch_dir: Optional[str] = None,
) -> Iterator[Block]:
    """Stream the merged blocks of a run set. More runs than ``max_fanin``
    first collapse through disk passes (see collapse_runs — NOTE: that
    consumes the input runs; callers that re-stream should call
    collapse_runs themselves and keep the returned set, as
    SpillingFrequencyStore.blocks does), so peak memory stays
    O(max_fanin x block_bytes) no matter how many runs spilled."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    paths = collapse_runs(
        paths, n_cols, dtypes=dtypes, out_groups=out_groups,
        max_fanin=max_fanin, scratch_dir=scratch_dir,
    )
    # the final in-memory merge is NOT counted in spill_merge_passes:
    # consumers re-stream it per pass (count stats, Histogram top-N,
    # serde), and counting those would inflate the cascade telemetry
    readers = [RunReader(p) for p in paths]
    try:
        yield from merge_block_streams(
            [r.blocks() for r in readers], dtypes, out_groups
        )
    finally:
        SCAN_STATS.bump(spill_bytes_read=sum(r.bytes_read for r in readers))
