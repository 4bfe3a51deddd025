"""Canonical key order for spill runs, and the vectorized comparisons the
k-way merger needs.

The order is fixed by what the existing monoid merge already produces
(``FrequenciesAndNumRows.sum`` lexsorts per-column ``np.unique`` codes with
the FIRST column most significant): per column, null < every value, values
ascend, and float NaN collapses to one key that sorts after every finite
value. Everything here implements that order three ways — a full sort of a
block, a vectorized row-vs-boundary comparison, and a python-level
boundary-vs-boundary comparison — which MUST stay mutually consistent; the
randomized spill-equivalence sweep in tests/test_torch_spill.py exercises all
three against each other.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# a boundary key: one cell per column; None = null. NaN cells compare equal
# to each other and greater than every non-NaN value.
Key = Tuple[object, ...]


def _code_column(values: np.ndarray, nulls: np.ndarray) -> np.ndarray:
    """Dense rank codes in canonical order (0 = null, NaN last) — the same
    factorization FrequenciesAndNumRows._code_columns performs."""
    if values.dtype.kind == "f":
        _, inv = np.unique(values, return_inverse=True, equal_nan=True)
    else:
        _, inv = np.unique(values, return_inverse=True)
    return np.where(nulls, 0, inv.reshape(values.shape) + 1)


def canonical_order(
    key_values: Sequence[np.ndarray], key_nulls: Sequence[np.ndarray]
) -> np.ndarray:
    """Permutation putting rows in canonical key order (first column most
    significant)."""
    codes = [
        _code_column(v, m) for v, m in zip(key_values, key_nulls)
    ]
    return np.lexsort(tuple(reversed(codes)))


def is_nan_cell(cell) -> bool:
    return isinstance(cell, float) and cell != cell


def key_at(
    key_values: Sequence[np.ndarray],
    key_nulls: Sequence[np.ndarray],
    i: int,
) -> Key:
    """The boundary key of row ``i`` as python cells (None = null)."""
    out = []
    for v, m in zip(key_values, key_nulls):
        if bool(m[i]):
            out.append(None)
        else:
            cell = v[i]
            out.append(cell.item() if isinstance(cell, np.generic) else cell)
    return tuple(out)


def _cell_tier(cell) -> int:
    if cell is None:
        return 0
    if is_nan_cell(cell):
        return 2
    return 1


def compare_keys(a: Key, b: Key) -> int:
    """Lexicographic canonical compare of two boundary keys: -1/0/+1."""
    for ca, cb in zip(a, b):
        ta, tb = _cell_tier(ca), _cell_tier(cb)
        if ta != tb:
            return -1 if ta < tb else 1
        if ta != 1:
            continue  # both null, or both NaN — equal at this column
        # numeric cross-kind compares (int vs float, bool vs int) follow
        # python semantics, matching dict-key equality in from_dict
        if ca == cb:
            continue
        return -1 if ca < cb else 1
    return 0


def leq_boundary(
    key_values: Sequence[np.ndarray],
    key_nulls: Sequence[np.ndarray],
    boundary: Key,
) -> np.ndarray:
    """Vectorized ``row_key <= boundary`` under the canonical order.

    Used by the merger to slice the emit-safe prefix off each run buffer;
    because buffers are canonically sorted the result is always a prefix
    mask."""
    n = len(key_values[0]) if key_values else 0
    result = np.zeros(n, dtype=np.int8)  # running trichotomy, 0 = tied
    undecided = np.ones(n, dtype=bool)
    for v, m, cell in zip(key_values, key_nulls, boundary):
        if not undecided.any():
            break
        tier_b = _cell_tier(cell)
        tier_a = np.where(m, 0, 1).astype(np.int8)
        if v.dtype.kind == "f":
            with np.errstate(invalid="ignore"):
                tier_a = np.where(~m & np.isnan(v), 2, tier_a).astype(np.int8)
        cmp = np.sign(tier_a - tier_b).astype(np.int8)
        if tier_b == 1:
            val_rows = undecided & (cmp == 0)
            if val_rows.any():
                with np.errstate(invalid="ignore"):
                    lt = v < cell
                    gt = v > cell
                cmp = np.where(val_rows & lt, -1, cmp).astype(np.int8)
                cmp = np.where(val_rows & gt, 1, cmp).astype(np.int8)
        newly = undecided & (cmp != 0)
        result[newly] = cmp[newly]
        undecided &= cmp == 0
    return result <= 0


def is_strictly_ascending(
    key_values: Sequence[np.ndarray], key_nulls: Sequence[np.ndarray]
) -> bool:
    """Vectorized check that rows are in canonical key order with NO
    duplicate keys — the invariant every spill-run block must satisfy.

    O(G) per column (adjacent-row trichotomy, same tier rules as
    ``leq_boundary``), so producers can VERIFY a canonical claim instead
    of trusting provenance: string columns carry ingest-dictionary codes
    in arbitrary dictionary order, so a delta that looks canonical by
    construction on numeric keys is not on string keys."""
    n = len(key_values[0]) if key_values else 0
    if n < 2:
        return True
    result = np.zeros(n - 1, dtype=np.int8)  # cmp(row i, row i+1)
    undecided = np.ones(n - 1, dtype=bool)
    for v, m in zip(key_values, key_nulls):
        if not undecided.any():
            break
        tier = np.where(m, 0, 1).astype(np.int8)
        if v.dtype.kind == "f":
            with np.errstate(invalid="ignore"):
                tier = np.where(~m & np.isnan(v), 2, tier).astype(np.int8)
        cmp = np.sign(tier[:-1] - tier[1:]).astype(np.int8)
        both_vals = (tier[:-1] == 1) & (tier[1:] == 1)
        if both_vals.any():
            with np.errstate(invalid="ignore"):
                lt = v[:-1] < v[1:]
                gt = v[:-1] > v[1:]
            cmp = np.where(both_vals & (cmp == 0) & lt, -1, cmp).astype(np.int8)
            cmp = np.where(both_vals & (cmp == 0) & gt, 1, cmp).astype(np.int8)
        newly = undecided & (cmp != 0)
        result[newly] = cmp[newly]
        undecided &= cmp == 0
    # any still-undecided pair is a duplicate key -> not strictly ascending
    return bool((result == -1).all()) and not bool(undecided.any())


def merge_add_sorted(parts) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...], np.ndarray]:
    """Concatenate frequency parts and merge-add duplicate keys, emitting
    canonical order — the same codes+lexsort+reduceat move as
    ``FrequenciesAndNumRows.sum``, over an arbitrary number of parts.

    The caller guarantees per-column dtypes already agree across parts
    (the store promotes at add time; the merger casts at read time)."""
    kv = tuple(
        np.concatenate([p[0][i] for p in parts])
        for i in range(len(parts[0][0]))
    )
    kn = tuple(
        np.concatenate([p[1][i] for p in parts])
        for i in range(len(parts[0][1]))
    )
    counts = np.concatenate([p[2] for p in parts])
    if len(counts) == 0:
        return kv, kn, counts
    codes = [_code_column(v, m) for v, m in zip(kv, kn)]
    order = np.lexsort(tuple(reversed(codes)))
    mat = np.stack(codes)[:, order] if codes else np.zeros((0, len(counts)))
    boundary = np.any(mat[:, 1:] != mat[:, :-1], axis=0)
    starts = np.concatenate([[0], np.nonzero(boundary)[0] + 1])
    merged_counts = np.add.reduceat(counts[order], starts).astype(np.int64)
    sel = order[starts]
    return (
        tuple(v[sel] for v in kv),
        tuple(m[sel] for m in kn),
        merged_counts,
    )
