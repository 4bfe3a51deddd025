"""Group-by count statistics via dictionary codes + a device histogram —
the count-stats half of ``deequ_tpu/ops/segment.py``.

Every column becomes per-row integer codes (0 = null, 1..K = distinct
values): strings are dictionary codes already, numeric columns get theirs
from a device sort (``_device_unique_inverse``). A group key is the
mixed-radix packing of the codes, built on the host as in the reference.

- Dense key space (at most ``DENSE_KEYSPACE_LIMIT``): one histogram of the
  packed keys over the key space — the CUDA kernel of
  ``ops/histogram_device.py`` on the card — and the count distribution's
  scalars are taken on the host from the fetched counts.
- Sparse key space: one device lexsort of the (k, n) code matrix plus run
  lengths; only four scalars come back.

At or below ``HOST_GROUP_LIMIT`` rows (2^14) both paths run on the host,
as in the reference (a round trip to the card costs more than the work):
the unique-inverse and run lengths with numpy, a dense count with
``np.bincount``, recorded in ``ScanStats.hist_host_dispatches``.

Three results come out of those counts:

- ``group_count_stats``: the count distribution's scalars (Uniqueness and
  the other count-only analyzers) — group values never decode;
- ``group_counts_state``: the columnar frequency table
  (``FrequenciesAndNumRows``; MutualInformation, Histogram with a binning
  UDF) — the dense counts' present slots decode by mixed-radix digits, the
  sparse route gathers the (k, G) representatives and run lengths on the
  card, and group values decode by gathers into the typed distinct arrays;
- ``group_top_k``: one column's top-k groups (Histogram), ranked on the
  card — only k (slot, count) pairs come back.

On a table persisted on the run's device (``ColumnarTable.persist``), a
string column's counts come from its resident codes
(:func:`_resident_string_bincount`: one K5 launch a resident chunk, summed
on the device): ``group_top_k`` ranks them there, and ``group_count_stats``
of one string column reduces them there to four scalars. Cross-set fusion
waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import device_boundary
from deequ_tpu_torch.ops.histogram_device import bincount
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, fetch

# dense count vectors are used up to this key-space size
DENSE_KEYSPACE_LIMIT = 1 << 22

# at or below this row count grouping work runs entirely on the HOST, as
# in the reference (a round trip to the card costs more than the work);
# a plain module attribute, so tests can monkeypatch it
HOST_GROUP_LIMIT = 1 << 14


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` on the device: the permutation sorting rows by the
    LAST key first, ties broken by the earlier keys — one stable sort per
    key, least significant first."""
    perm = None
    for key in keys:
        k = key if perm is None else key[perm]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def _device_unique_inverse(
    values: np.ndarray, mask: np.ndarray, device
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort-based unique on the device (reference ``_unique_inverse_kernel``):
    one lexsort puts valid values first and in order — with every NaN in
    ONE group after the numbers, which ``torch.unique`` would not do —
    adjacent compares mark group starts, a cumsum assigns dense ids, and a
    scatter maps them back to row order. Returns (uniques, codes) with
    codes 0 = null, 1..K = distinct."""
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=values.dtype), np.zeros(0, dtype=np.int64)
    if n <= HOST_GROUP_LIMIT and values.dtype != np.float64:
        vals = values[mask]
        uniques = np.unique(vals)
        codes = np.zeros(n, dtype=np.int64)
        if len(uniques):
            codes[mask] = np.searchsorted(uniques, vals) + 1
        return uniques, codes
    SCAN_STATS.device_sort_passes += 1
    with device_boundary("execute"):
        v = torch.from_numpy(np.ascontiguousarray(values)).to(device)
        m = torch.from_numpy(np.ascontiguousarray(mask)).to(device)
        is_nan = torch.isnan(v) if v.is_floating_point() else torch.zeros_like(m)
        # primary: validity (valid first), then NaN-ness, then the value
        rank = (~m).to(torch.uint8) * 2 + is_nan.to(torch.uint8)
        perm = _lexsort([v, rank])
        sv, sm, snan = v[perm], m[perm], is_nan[perm]
        neq = (sv[1:] != sv[:-1]) & ~(snan[1:] & snan[:-1])
        starts = torch.cat([torch.ones(1, dtype=torch.bool, device=device), neq]) & sm
        ids = torch.cumsum(starts.to(torch.int64), 0)
        inv = torch.empty_like(ids)
        inv[perm] = torch.where(sm, ids, 0)
        uniques, codes = fetch(sv[starts], inv)
    return uniques, codes


def column_key_codes(col: Column, device) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row integer codes (0 = null, 1..K = distinct values) + the
    distinct values in code order."""
    if col.dtype == DType.STRING:
        return col.codes.astype(np.int64) + 1, col.dictionary
    if col.dtype == DType.BOOLEAN:
        # 2-value domain: no sort needed at all
        uniques = np.unique(col.values[col.mask])
        lut = {v: i + 1 for i, v in enumerate(uniques.tolist())}
        codes = np.where(
            col.mask, np.where(col.values, lut.get(True, 0), lut.get(False, 0)), 0
        ).astype(np.int64)
        return codes, uniques
    uniques, codes = _device_unique_inverse(col.values, col.mask, device)
    return codes, uniques


def _device_bincount(keys: np.ndarray, num_segments: int, device) -> np.ndarray:
    """Count key occurrences; ``keys`` holds -1 for rows to ignore. On the
    card this is one launch of the CUDA histogram kernel."""
    n = len(keys)
    if n <= HOST_GROUP_LIMIT:
        SCAN_STATS.record_hist_dispatch("host")
        slots = np.where(keys >= 0, keys, num_segments)
        counts = np.bincount(slots, minlength=num_segments + 1)
        return counts[:num_segments].astype(np.int64)
    with device_boundary("execute"):
        seg = torch.from_numpy(keys).to(device)
        counts = bincount(seg, num_segments)
        SCAN_STATS.record_hist_dispatch(
            "kernel" if seg.device.type == "cuda" else "plain"
        )
        return fetch(counts)[0]


def _resident_string_bincount(table, column: str, include_null: bool, device):
    """Counts per code slot (slot 0: null, counted only with
    ``include_null``) from the codes resident on ``device``, one K5 launch
    a resident chunk summed on the device — a device tensor of length
    cardinality + 1; None when the table or column is not resident there.
    (The port's resident chunks hold no padding rows, so none is dropped.)"""
    cache = getattr(table, "_device_cache", None)
    if cache is None or not cache.device_chunks or not cache.matches(device, [column]):
        return None
    packer = cache.packer
    if column not in packer.string_names:
        return None
    row = packer.string_names.index(column)
    slots = len(packer.cols[column].dictionary) + 1
    counts = None
    with device_boundary("execute"):
        for planes in cache.device_chunks:
            seg = planes[2][row] + 1  # code -1 (null) lands in slot 0
            part = bincount(seg, slots)
            SCAN_STATS.record_hist_dispatch(
                "kernel" if seg.device.type == "cuda" else "plain"
            )
            counts = part if counts is None else counts + part
        if not include_null:
            counts[0] = 0
    return counts


def _stats_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """(total, groups, singletons, entropy) of a device counts vector, as
    one f64 tensor of four — the reference's ``_stats_from_counts``."""
    total = counts.sum()
    p = counts.to(torch.float64) / total.clamp(min=1)
    logp = torch.log(torch.where(p > 0, p, 1.0))
    entropy = -torch.where(counts > 0, p * logp, 0.0).sum()
    return torch.stack([
        total.to(torch.float64),
        (counts > 0).sum().to(torch.float64),
        (counts == 1).sum().to(torch.float64),
        entropy,
    ])


@dataclass(frozen=True)
class CountStats:
    """Scalar aggregates of the group-count distribution — everything the
    count-only grouping analyzers (Uniqueness, UniqueValueRatio,
    Distinctness, CountDistinct, Entropy) need."""

    num_rows: int
    num_groups: int
    singletons: int
    entropy: float


def _count_stats_from_counts(counts: np.ndarray, num_rows: int) -> CountStats:
    """Host counts vector -> CountStats (the reference's formula, so the
    dense path's entropy is the same float computation on both sides)."""
    num_groups = int(len(counts))
    singletons = int((counts == 1).sum())
    if num_rows > 0 and num_groups > 0:
        p = counts.astype(np.float64) / num_rows
        entropy = float(-(p * np.log(p)).sum())
    else:
        entropy = float("nan")
    return CountStats(num_rows, num_groups, singletons, entropy)


def _typed_values(col_dtype: DType, values) -> np.ndarray:
    """Distinct values (code order) -> a typed numpy array the columnar
    frequency state can factorize with vectorized np.unique."""
    if col_dtype == DType.STRING:
        return np.asarray(values, dtype=np.str_) if len(values) else np.empty(
            0, dtype=np.str_
        )
    if col_dtype == DType.BOOLEAN:
        return np.asarray(values, dtype=np.bool_)
    if col_dtype == DType.INTEGRAL:
        return np.asarray(values, dtype=np.int64)
    return np.asarray(values, dtype=np.float64)


@dataclass
class _GroupPrep:
    """One grouping set's key material: per-column codes, their distinct
    values as typed arrays (``with_values`` only) and radices, the rows
    with any non-null key, and (dense only) the mixed-radix packed int64
    keys with -1 marking excluded rows."""

    code_arrays: List[np.ndarray]
    value_arrays: Optional[List[np.ndarray]]
    radices: List[int]
    any_non_null: Optional[np.ndarray]
    num_rows: int
    keyspace: int
    dense: bool
    keys: Optional[np.ndarray]


def _prepare_grouping(
    table: ColumnarTable,
    columns: Sequence[str],
    device,
    require_any_non_null: bool = True,
    with_values: bool = False,
) -> _GroupPrep:
    code_arrays = []
    value_arrays: Optional[List[np.ndarray]] = [] if with_values else None
    radices = []
    for name in columns:
        col = table[name]
        codes, values = column_key_codes(col, device)
        if with_values:
            # the typed distinct array is memoized on the column: for a
            # string column it converts the whole dictionary
            typed = getattr(col, "_typed_distinct", None)
            if typed is None or len(typed) != len(values):
                typed = _typed_values(col.dtype, values)
                col._typed_distinct = typed
            value_arrays.append(typed)
        code_arrays.append(codes)
        radices.append(len(values) + 1)

    if require_any_non_null and len(columns) > 0:
        any_non_null = np.zeros(table.num_rows, dtype=bool)
        for codes in code_arrays:
            any_non_null |= codes > 0
        num_rows = int(any_non_null.sum())
    else:
        any_non_null = None
        num_rows = table.num_rows

    # Python-int product: mixed-radix packing into int64 wraps past 2^63,
    # so the key space is checked before packing
    keyspace = 1
    for radix in radices:
        keyspace *= radix

    dense = keyspace <= DENSE_KEYSPACE_LIMIT
    keys = None
    if dense:
        keys = np.zeros(table.num_rows, dtype=np.int64)
        for codes, radix in zip(code_arrays, radices):
            keys = keys * radix + codes
        if any_non_null is not None:
            keys = np.where(any_non_null, keys, -1)
    return _GroupPrep(
        code_arrays, value_arrays, radices, any_non_null, num_rows, keyspace,
        dense, keys,
    )


def _host_rle_counts(matrix: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Run lengths of the distinct valid rows of a (k, n) code matrix, on
    the host (the reference's small-input path)."""
    perm = np.lexsort(tuple(matrix) + (~valid,))
    smat = matrix[:, perm]
    sva = valid[perm]
    neq = np.any(smat[:, 1:] != smat[:, :-1], axis=0)
    starts = np.concatenate([[True], neq]) & sva
    positions = np.nonzero(starts)[0]
    return np.diff(np.append(positions, int(sva.sum()))).astype(np.int64)


def _device_rle_stats(matrix: np.ndarray, valid: np.ndarray, device):
    """Sparse group-by count aggregates on the device (reference
    ``_rle_stats_kernel``): lexsort the code matrix with valid rows first,
    mark run starts, take run lengths; (m, num_groups, singletons,
    sum(c log c)) come back in one fetch of four f64 scalars."""
    with device_boundary("execute"):
        mat = torch.from_numpy(np.ascontiguousarray(matrix)).to(device)
        va = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
        perm = _lexsort(list(mat) + [~va])
        smat, sva = mat[:, perm], va[perm]
        neq = (smat[:, 1:] != smat[:, :-1]).any(dim=0)
        starts = torch.cat([torch.ones(1, dtype=torch.bool, device=device), neq]) & sva
        m = sva.sum()
        positions = torch.nonzero(starts).squeeze(1)
        counts = torch.diff(positions, append=m.reshape(1))
        c = counts.to(torch.float64)
        clogc = (c * torch.log(c)).sum()
        scalars = torch.stack([
            m.to(torch.float64),
            starts.sum().to(torch.float64),
            (counts == 1).sum().to(torch.float64),
            clogc,
        ])
        host = fetch(scalars)[0]
    return host[0], int(host[1]), int(host[2]), host[3]


def group_count_stats(
    table: ColumnarTable,
    columns: Sequence[str],
    device,
    require_any_non_null: bool = True,
) -> CountStats:
    """Count-distribution aggregates for a grouping (reference
    ``group_count_stats``): group values never decode on the host."""
    SCAN_STATS.grouping_passes += 1
    SCAN_STATS.rows_scanned += table.num_rows

    # one resident string column: the four scalars from its resident codes
    if len(columns) == 1 and table[columns[0]].dtype == DType.STRING:
        resident = _resident_string_bincount(
            table, columns[0], not require_any_non_null, device
        )
        if resident is not None:
            total, groups, singles, entropy = fetch(_stats_from_counts(resident))[0]
            total, groups = int(total), int(groups)
            return CountStats(
                total, groups, int(singles),
                float(entropy) if total > 0 and groups > 0 else float("nan"),
            )

    prep = _prepare_grouping(table, columns, device, require_any_non_null)
    num_rows = prep.num_rows

    if prep.dense:
        counts = _device_bincount(prep.keys, prep.keyspace, device)
        return _count_stats_from_counts(counts[counts > 0], num_rows)

    matrix = np.stack(prep.code_arrays, axis=0)
    valid = (
        prep.any_non_null
        if prep.any_non_null is not None
        else np.ones(table.num_rows, dtype=bool)
    )
    if table.num_rows <= HOST_GROUP_LIMIT:
        return _count_stats_from_counts(_host_rle_counts(matrix, valid), num_rows)
    SCAN_STATS.device_sort_passes += 1
    m, num_groups, singletons, clogc = _device_rle_stats(matrix, valid, device)
    if num_rows > 0 and num_groups > 0:
        # entropy = -sum (c/N) log(c/N) = log N - (sum c*log c)/N, N = m
        entropy = float(np.log(m) - clogc / m)
    else:
        entropy = float("nan")
    return CountStats(num_rows, num_groups, singletons, entropy)


# -- the frequency table --------------------------------------------------------


def _dense_digits(
    prep: _GroupPrep, counts: np.ndarray
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Dense counts vector -> (per-column digit codes of the present
    groups, their counts) by vectorized mixed-radix decode."""
    present = np.nonzero(counts)[0]
    group_counts_vec = counts[present].astype(np.int64)
    digit_cols = []
    rest = present
    for radix in reversed(prep.radices):
        digit_cols.append(rest % radix)
        rest = rest // radix
    digit_cols.reverse()
    return digit_cols, group_counts_vec


def _freq_state_from_digits(
    columns: Sequence[str],
    digit_cols: List[np.ndarray],
    group_counts_vec: np.ndarray,
    value_arrays: List[np.ndarray],
    num_rows: int,
):
    """Digit codes + counts -> columnar ``FrequenciesAndNumRows``: each
    column's group values decode by one gather into its typed distinct
    array (digit 0 = null)."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows

    key_values = []
    key_nulls = []
    for digits, values in zip(digit_cols, value_arrays):
        if len(values):
            key_values.append(values[np.maximum(digits - 1, 0)])
        else:
            key_values.append(np.zeros(len(digits), dtype=values.dtype))
        key_nulls.append(digits == 0)
    return FrequenciesAndNumRows(
        tuple(columns), tuple(key_values), tuple(key_nulls),
        group_counts_vec, num_rows,
    )


def _device_matrix_rle(
    code_matrix: np.ndarray, valid: np.ndarray, device
) -> Tuple[np.ndarray, np.ndarray]:
    """Run-length-encode the distinct valid rows of a (k, n) code matrix
    (reference ``_device_matrix_rle``): one device lexsort with valid rows
    first and an adjacent compare mark the run starts; ``torch.nonzero``
    reads the group count G back (its one scalar round trip) and the
    (k, G) representatives and G run lengths are gathered on the card, so
    the fetch is O(k·G), never the sorted (k, n) matrix. At or below
    ``HOST_GROUP_LIMIT`` rows the same runs are taken on the host.
    Returns (groups (k, G), counts (G,))."""
    k, n = code_matrix.shape
    if n == 0:
        return code_matrix[:, :0], np.zeros(0, dtype=np.int64)
    if n <= HOST_GROUP_LIMIT:
        perm = np.lexsort(tuple(code_matrix) + (~valid,))
        smat = code_matrix[:, perm]
        sva = valid[perm]
        neq = np.any(smat[:, 1:] != smat[:, :-1], axis=0)
        starts = np.concatenate([[True], neq]) & sva
        positions = np.nonzero(starts)[0]
        counts = np.diff(np.append(positions, int(sva.sum()))).astype(np.int64)
        return smat[:, positions], counts
    SCAN_STATS.device_sort_passes += 1
    with device_boundary("execute"):
        mat = torch.from_numpy(np.ascontiguousarray(code_matrix)).to(device)
        va = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
        perm = _lexsort(list(mat) + [~va])
        smat, sva = mat[:, perm], va[perm]
        neq = (smat[:, 1:] != smat[:, :-1]).any(dim=0)
        starts = torch.cat([torch.ones(1, dtype=torch.bool, device=device), neq]) & sva
        positions = torch.nonzero(starts).squeeze(1)
        counts = torch.diff(positions, append=sva.sum().reshape(1))
        groups, counts = fetch(smat[:, positions], counts)
    return groups, counts.astype(np.int64)


def group_counts_state(
    table: ColumnarTable,
    columns: Sequence[str],
    device,
    require_any_non_null: bool = True,
):
    """The frequency table of a grouping as a columnar
    ``FrequenciesAndNumRows`` (reference ``group_counts_state`` with
    ``canonicalize=False``; GroupingAnalyzers.scala:53-79): dense key
    spaces count on the card (the CUDA histogram) and decode the present
    slots by mixed-radix digits; sparse ones take the device run-length
    route. Group values decode by vectorized gathers — no per-group
    Python loop."""
    SCAN_STATS.grouping_passes += 1
    SCAN_STATS.rows_scanned += table.num_rows

    prep = _prepare_grouping(
        table, columns, device, require_any_non_null, with_values=True
    )
    if prep.dense:
        counts = _device_bincount(prep.keys, prep.keyspace, device)
        digit_cols, group_counts_vec = _dense_digits(prep, counts)
    else:
        matrix = np.stack(prep.code_arrays, axis=0)
        valid = (
            prep.any_non_null
            if prep.any_non_null is not None
            else np.ones(table.num_rows, dtype=bool)
        )
        groups_mat, group_counts_vec = _device_matrix_rle(matrix, valid, device)
        digit_cols = list(groups_mat)
    return _freq_state_from_digits(
        columns, digit_cols, group_counts_vec, prep.value_arrays, prep.num_rows
    )


def group_counts(
    table: ColumnarTable,
    columns: Sequence[str],
    device,
    require_any_non_null: bool = True,
) -> Tuple[Dict[tuple, int], int]:
    """Dict-shaped view of ``group_counts_state``: each tuple of group
    values (None = null) -> its count, and the row count."""
    state = group_counts_state(table, columns, device, require_any_non_null)
    return state.as_dict(), state.num_rows


# -- top-k ----------------------------------------------------------------------

NULL_FIELD_REPLACEMENT = "NullValue"

_SLOT_MASK = 0xFFFFFFFF


@dataclass(frozen=True)
class TopKCounts:
    """One column's top-k groups: total rows, distinct-group count, and
    the top (group value, count) pairs, count descending, the lower slot
    first on equal counts (the reference's ``jax.lax.top_k`` order)."""

    num_rows: int
    num_groups: int
    top: Tuple[Tuple[object, int], ...]  # (value-or-None, count)


def _packed_topk(counts: torch.Tensor, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``kk`` slots of a counts vector, ranked by ONE distinct
    int64 key a slot, ``(count << 32) | (0xFFFFFFFF - slot)``: a higher
    count first, the lower slot first on equal counts — ``jax.lax.top_k``'s
    order, which ``torch.topk`` does not promise on ties. Needs counts
    below 2^31 and slots below 2^32. Returns the keys (descending) and the
    group count."""
    slots = torch.arange(counts.numel(), dtype=torch.int64, device=counts.device)
    keys = (counts << 32) | (_SLOT_MASK - slots)
    return torch.topk(keys, kk).values, (counts > 0).sum()


def _unpack_topk(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed keys -> (slots, counts)."""
    keys = keys.astype(np.int64)
    return _SLOT_MASK - (keys & _SLOT_MASK), keys >> 32


def group_top_k(table: ColumnarTable, column: str, k: int, device) -> TopKCounts:
    """Top-k most frequent values of ONE column (reference
    ``group_top_k``): counts over card + 1 slots (slot 0 = null) on the
    card — the CUDA histogram — ranked there by :func:`_packed_topk`; only
    k (slot, count) pairs come back and only those values decode. A string
    column's codes go over as int32. Nulls form their own group (value
    None); when the dictionary holds the literal "NullValue" (the label the
    Histogram metric gives nulls), the null slot merges into it before
    ranking. A string column of a table resident on ``device`` counts from
    its resident codes."""
    SCAN_STATS.grouping_passes += 1
    SCAN_STATS.rows_scanned += table.num_rows
    if table.num_rows >= 1 << 31:
        raise ValueError("group_top_k: counts must stay below 2^31 to be ranked")

    col = table[column]
    nv_code = -1
    if col.dtype == DType.STRING:
        hits = np.nonzero(col.dictionary == NULL_FIELD_REPLACEMENT)[0]
        if len(hits):
            nv_code = int(hits[0]) + 1
        resident = _resident_string_bincount(table, column, True, device)
        if resident is not None:
            kk = min(k, len(col.dictionary) + 1)
            with device_boundary("execute"):
                keys, groups = _topk_merged(resident, kk, nv_code)
                num_groups, keys = fetch(groups, keys)
            return _top_k_counts(
                table.num_rows, int(num_groups), *_unpack_topk(keys),
                lambda idx: col.dictionary[idx - 1],
            )
        codes = col.codes + np.int32(1)
        values = col.dictionary
        decode = lambda idx: values[idx - 1]  # noqa: E731
    elif col.dtype == DType.BOOLEAN:
        codes, values = column_key_codes(col, device)
        decode = lambda idx: bool(values[idx - 1])  # noqa: E731
    else:
        values, codes = _device_unique_inverse(col.values, col.mask, device)
        cast = int if col.dtype == DType.INTEGRAL else float
        decode = lambda idx: cast(values[idx - 1])  # noqa: E731
    num_segments = len(values) + 1
    kk = min(k, num_segments)

    if table.num_rows <= HOST_GROUP_LIMIT:
        SCAN_STATS.record_hist_dispatch("host")
        counts = np.bincount(codes, minlength=num_segments).astype(np.int64)
        if nv_code >= 0:
            counts[nv_code] += counts[0]
            counts[0] = 0
        num_groups = int((counts > 0).sum())
        top_idx = np.argsort(-counts, kind="stable")[:kk]
        top_counts = counts[top_idx]
    else:
        with device_boundary("execute"):
            seg = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
            counts = bincount(seg, num_segments)
            SCAN_STATS.record_hist_dispatch(
                "kernel" if seg.device.type == "cuda" else "plain"
            )
            keys, groups = _topk_merged(counts, kk, nv_code)
            num_groups, keys = fetch(groups, keys)
        top_idx, top_counts = _unpack_topk(keys)
        num_groups = int(num_groups)
    return _top_k_counts(table.num_rows, num_groups, top_idx, top_counts, decode)


def _topk_merged(counts: torch.Tensor, kk: int, nv_code: int):
    """:func:`_packed_topk` after merging the null slot into the literal
    "NullValue" slot ``nv_code`` (when >= 0), before ranking."""
    if nv_code >= 0:
        counts[nv_code] += counts[0]
        counts[0] = 0
    return _packed_topk(counts, kk)


def _top_k_counts(num_rows, num_groups, top_idx, top_counts, decode) -> TopKCounts:
    top = []
    for idx, cnt in zip(top_idx.tolist(), top_counts.tolist()):
        if cnt <= 0:
            continue
        top.append((None if idx == 0 else decode(idx), int(cnt)))
    return TopKCounts(num_rows, num_groups, tuple(top))
