"""Group-by count statistics via dictionary codes + a device histogram —
the count-stats half of ``deequ_tpu/ops/segment.py``.

Every column becomes per-row integer codes (0 = null, 1..K = distinct
values): strings are dictionary codes already, numeric columns get theirs
from a device sort (``_device_unique_inverse``). A group key is the
mixed-radix packing of the codes, built on the host as in the reference.

- Dense key space (at most ``DENSE_KEYSPACE_LIMIT``): one histogram of the
  packed keys over the key space — on the card the kernel of the variant
  the dispatch resolves (``device_policy.resolve_hist_variant`` over its
  width, as the reference resolves it: K5 for "scatter" and "pallas", K6
  for "onehot"; ``ops/histogram_device.py``), recorded in the census by
  route and by variant — and the count distribution's scalars are taken
  on the host from the fetched counts.
- Sparse key space: one device lexsort of the (k, n) code matrix plus run
  lengths; only four scalars come back.

At or below :func:`host_group_limit` rows (``DEEQU_TORCH_HOST_GROUP_LIMIT``,
else ``HOST_GROUP_LIMIT`` = 2^14) both paths run on the host, as in the
reference (a round trip to the card costs more than the work): the
unique-inverse and run lengths with numpy, a dense count with
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
(:func:`_resident_string_bincount`: one launch of the resolved variant's
kernel a resident chunk, summed on the device): ``group_top_k`` ranks
them there, and ``group_count_stats`` of one string column reduces them
there to four scalars.

Cross-set fusion (:func:`fused_group_counts`, the reference's round-19
plan optimizer): the dense sets of one run count in one launch of the
histogram kernel's multi-input entry (``histogram_device.fused_bincount``:
K7, or K6's entry where the summed width resolves "onehot") over their
summed keyspace, and each set's slice of the counts is bit for bit what
its own dispatch would have counted.

Over a mesh (the ``use_mesh`` scope, led by the device these functions
are handed: ``parallel/mesh.py``) every dense count is sharded as the
reference's ``shard_map`` wrappers shard it (:func:`_member_counts`):
the keys split into one row shard a member, each member counts its shard
with the dispatch's kernel (K5, K6 or K7) on its own device, and the
counts are copied to the lead and summed there in int64 — exact, as the
reference's psum is. The top-k and the count statistics run after the
sum, on the lead; a resident
string column counts each member's resident codes of each chunk. The
sorts (unique codes, the sparse run lengths) run on the lead over all
rows, as the reference runs them unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import DeviceException, device_boundary
from deequ_tpu_torch.ops.device_policy import check_not_abandoned, resolve_hist_variant
from deequ_tpu_torch.ops.histogram_device import bincount_variant, fused_bincount
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, _members_of, fetch, member_scope
from deequ_tpu_torch.parallel.mesh import scoped_mesh, shard_bounds

# dense count vectors are used up to this key-space size
DENSE_KEYSPACE_LIMIT = 1 << 22

# at or below this row count grouping work runs entirely on the HOST, as
# in the reference (a round trip to the card costs more than the work);
# the default of DEEQU_TORCH_HOST_GROUP_LIMIT, and a plain module
# attribute, so tests can monkeypatch it
HOST_GROUP_LIMIT = 1 << 14


def host_group_limit() -> int:
    """The row count at or below which grouping runs on the host:
    ``DEEQU_TORCH_HOST_GROUP_LIMIT`` when set, else ``HOST_GROUP_LIMIT``
    (read at each call, so a monkeypatched attribute steers it)."""
    from deequ_tpu_torch.envcfg import env_value

    value = env_value("DEEQU_TORCH_HOST_GROUP_LIMIT")
    return HOST_GROUP_LIMIT if value is None else value


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
    if n <= host_group_limit() and values.dtype != np.float64:
        vals = values[mask]
        uniques = np.unique(vals)
        codes = np.zeros(n, dtype=np.int64)
        if len(uniques):
            codes[mask] = np.searchsorted(uniques, vals) + 1
        return uniques, codes
    SCAN_STATS.bump(device_sort_passes=1)
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


def _host_bincount(keys: np.ndarray, num_segments: int) -> np.ndarray:
    """The latency regime's count: ``np.bincount`` on the host, the -1
    rows in a trailing slot that is cut off."""
    SCAN_STATS.record_hist_dispatch("host")
    slots = np.where(keys >= 0, keys, num_segments)
    counts = np.bincount(slots, minlength=num_segments + 1)
    return counts[:num_segments].astype(np.int64)


def _member_counts(arrays: Sequence[np.ndarray], count, device) -> torch.Tensor:
    """``count(tensors)`` of the host ``arrays`` (one a grouping input,
    equal lengths) as a device int64 counts tensor on ``device``. Over the
    scoped mesh (module doc) member i counts the i-th row shard of every
    array on its own device — the reference's sharding: ceil(rows / n)
    rows a member — and the members' counts sum in int64 on the lead."""
    mesh = scoped_mesh(device)
    if mesh is None:
        return count([torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays])
    total = None
    for i, (member, dev) in enumerate(mesh.members):
        with member_scope(member, dev):
            shards = []
            for a in arrays:
                lo, hi = shard_bounds(0, len(a), -(-len(a) // mesh.size), i)
                shards.append(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev))
            counts = count(shards)
        counts = counts.to(mesh.lead, non_blocking=True)
        total = counts if total is None else total + counts
    return total


def _hist_variant(width: int, rows: int, device) -> str:
    """The histogram variant of one grouping dispatch of ``width`` slots
    (the reference's: the counted bins plus its trailing slot) over
    ``rows`` rows on ``device`` (``device_policy.resolve_hist_variant``)."""
    return resolve_hist_variant((width,), rows=rows, platform=torch.device(device).type)


def _record_dispatch(variant: str, counts: torch.Tensor, n: int = 1) -> None:
    """One grouping dispatch (``n`` for a resident count's chunks) in the
    census: by route, a kernel on a card or a plain version on the CPU, and
    by the variant it resolved."""
    SCAN_STATS.record_hist_dispatch("kernel" if counts.device.type == "cuda" else "plain", n)
    SCAN_STATS.record_hist_dispatch(variant, n)


def _device_bincount(keys: np.ndarray, num_segments: int, device) -> np.ndarray:
    """Count key occurrences; ``keys`` holds -1 for rows to ignore. On the
    card this is one launch of the resolved variant's kernel (K6 or K5; one
    a member over a mesh, the counts summed on the lead)."""
    if len(keys) <= host_group_limit():
        return _host_bincount(keys, num_segments)
    variant = _hist_variant(num_segments + 1, len(keys), device)
    with device_boundary("execute"):
        counts = _member_counts(
            [keys], lambda segs: bincount_variant(variant, segs[0], num_segments), device
        )
        _record_dispatch(variant, counts)
        return fetch(counts)[0]


def _resident_cache(table, column: str, device):
    """The table's device cache when ``column`` is a string column whose
    codes are resident on ``device`` (over the scoped mesh, sharded over
    it); else None."""
    cache = getattr(table, "_device_cache", None)
    if (cache is None or not cache.device_chunks
            or not cache.matches(device, [column], scoped_mesh(device))):
        return None
    return cache if column in cache.packer.string_names else None


def _resident_string_bincount(table, column: str, include_null: bool, device):
    """Counts per code slot (slot 0: null, counted only with
    ``include_null``) from the codes resident on ``device``, one launch of
    the resolved variant's kernel a resident chunk (a member's shard of it
    over a mesh) summed on the device (the lead) — a device tensor of length cardinality + 1; None
    when the table or column is not resident there. (The port's resident
    chunks hold no padding rows, so none is dropped.)"""
    cache = _resident_cache(table, column, device)
    if cache is None:
        return None
    packer = cache.packer
    row = packer.string_names.index(column)
    slots = len(packer.cols[column].dictionary) + 1
    members = _members_of(cache.mesh, cache.device)
    variant = _hist_variant(slots + 1, table.num_rows, cache.device)
    SCAN_STATS.record_hist_dispatch(variant, len(cache.device_chunks))
    counts = None
    with device_boundary("execute"):
        for ci in range(len(cache.device_chunks)):
            for i, (member, dev) in enumerate(members):
                with member_scope(member, dev):
                    seg = cache.shard(ci, i)[2][row] + 1  # code -1 (null) lands in slot 0
                    part = bincount_variant(variant, seg, slots)
                SCAN_STATS.record_hist_dispatch(
                    "kernel" if seg.device.type == "cuda" else "plain"
                )
                part = part.to(cache.device, non_blocking=True)
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
    SCAN_STATS.bump(grouping_passes=1)
    SCAN_STATS.bump(rows_scanned=table.num_rows)

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
    if table.num_rows <= host_group_limit():
        return _count_stats_from_counts(_host_rle_counts(matrix, valid), num_rows)
    SCAN_STATS.bump(device_sort_passes=1)
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
    canonicalize: bool = False,
):
    """Digit codes + counts -> columnar ``FrequenciesAndNumRows``: each
    column's group values decode by one gather into its typed distinct
    array (digit 0 = null). ``canonicalize``: the rows come out in
    canonical key order (``spill/order.py``), checked in O(G) and sorted
    on the host only where the check fails."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows

    key_values = []
    key_nulls = []
    for digits, values in zip(digit_cols, value_arrays):
        if len(values):
            key_values.append(values[np.maximum(digits - 1, 0)])
        else:
            key_values.append(np.zeros(len(digits), dtype=values.dtype))
        key_nulls.append(digits == 0)
    if canonicalize:
        from deequ_tpu_torch.spill.order import is_strictly_ascending, merge_add_sorted

        if not is_strictly_ascending(key_values, key_nulls):
            kv, kn, group_counts_vec = merge_add_sorted(
                [(tuple(key_values), tuple(key_nulls), group_counts_vec)]
            )
            key_values, key_nulls = list(kv), list(kn)
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
    :func:`host_group_limit` rows the same runs are taken on the host.
    Returns (groups (k, G), counts (G,))."""
    k, n = code_matrix.shape
    if n == 0:
        return code_matrix[:, :0], np.zeros(0, dtype=np.int64)
    if n <= host_group_limit():
        perm = np.lexsort(tuple(code_matrix) + (~valid,))
        smat = code_matrix[:, perm]
        sva = valid[perm]
        neq = np.any(smat[:, 1:] != smat[:, :-1], axis=0)
        starts = np.concatenate([[True], neq]) & sva
        positions = np.nonzero(starts)[0]
        counts = np.diff(np.append(positions, int(sva.sum()))).astype(np.int64)
        return smat[:, positions], counts
    SCAN_STATS.bump(device_sort_passes=1)
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
    canonicalize: bool = False,
):
    """The frequency table of a grouping as a columnar
    ``FrequenciesAndNumRows`` (reference ``group_counts_state``;
    GroupingAnalyzers.scala:53-79): dense key spaces count on the card
    (the CUDA histogram) and decode the present slots by mixed-radix
    digits; sparse ones take the device run-length route. Group values
    decode by vectorized gathers — no per-group Python loop.

    ``canonicalize=True`` emits the state as a sorted delta in canonical
    key order (first column most significant, nulls first, values
    ascending, NaN last: the order ``FrequenciesAndNumRows.sum``
    produces), which the spill store folds into runs without a re-sort.
    Numeric columns come off both routes in that order already (a digit
    is a value-ascending rank); a string column's codes follow its
    dictionary, whose order is arbitrary, so the delta is checked in O(G)
    and sorted on the host only where the check fails."""
    SCAN_STATS.bump(grouping_passes=1)
    SCAN_STATS.bump(rows_scanned=table.num_rows)

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
        if canonicalize and len(digit_cols) > 1:
            # the run-length route sorts the last column most significant;
            # the digits are canonical ranks, so order them first-column
            # major on the host (O(G))
            order = np.lexsort(tuple(reversed(digit_cols)))
            digit_cols = [d[order] for d in digit_cols]
            group_counts_vec = group_counts_vec[order]
    return _freq_state_from_digits(
        columns, digit_cols, group_counts_vec, prep.value_arrays, prep.num_rows,
        canonicalize,
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


# -- cross-set grouping fusion ----------------------------------------------------


@dataclass(frozen=True)
class GroupRequest:
    """One grouping set fusion may take: its sorted columns and the shape
    its analyzers need — "freq" (the frequency table,
    ``FrequenciesAndNumRows``) or "stats" (``CountStats``, the
    ``group_count_stats`` route)."""

    columns: Tuple[str, ...]
    mode: str = "freq"


def _resident_stats_eligible(table, columns, device) -> bool:
    """True exactly where a stats-mode set would take
    ``group_count_stats``'s resident string route (four scalars from the
    codes resident on ``device``): cheaper than any fusion, so fusion
    leaves such a set to its own pass."""
    return (
        len(columns) == 1
        and table[columns[0]].dtype == DType.STRING
        and _resident_cache(table, columns[0], device) is not None
    )


def _fused_device_bincount(keys: List[np.ndarray], keyspaces, device) -> np.ndarray:
    """One dispatch counting K dense sets' keys over their summed keyspace,
    set j's slots after the keyspaces before it. At or below
    :func:`host_group_limit` rows in all, the reference's host formulation
    (offset, concatenate, ``np.bincount``); else each set's keys go to the
    device as they were prepared and ``fused_bincount`` counts them — on
    the card one launch of the multi-input entry."""
    total = sum(keyspaces)
    if sum(len(k) for k in keys) <= host_group_limit():
        offsets = np.cumsum((0,) + tuple(keyspaces[:-1]))
        combined = np.concatenate([
            np.where(k >= 0, k + np.int64(off), np.int64(-1))
            for k, off in zip(keys, offsets)
        ])
        return _host_bincount(combined, total)
    variant = _hist_variant(total + 1, sum(len(k) for k in keys), device)
    with device_boundary("execute"):
        check_not_abandoned()
        counts = _member_counts(
            keys, lambda segs: fused_bincount(segs, keyspaces, variant), device
        )
        _record_dispatch(variant, counts)
        return fetch(counts)[0]


def fused_group_counts(
    table: ColumnarTable, requests: Sequence[GroupRequest], device
) -> Dict[int, object]:
    """Cross-set grouping fusion (reference ``fused_group_counts``): the
    dense sets among ``requests`` count in ONE dispatch
    (:func:`_fused_device_bincount`: one launch of the histogram kernel's
    multi-input entry on the card, one fetch), and each set's slice of the
    counts finalizes as its own pass would. Integer counts are exact in
    any order, so every slice is bit for bit the set's own dispatch.

    Sets are packed greedily, in request order, into groups whose summed
    keyspace stays within ``DENSE_KEYSPACE_LIMIT``; a group of one counts
    in its own dispatch. Returns ``{request index: state}``
    (``FrequenciesAndNumRows`` for "freq", ``CountStats`` for "stats"),
    each counted as one grouping pass, as the per-set path counts it. A
    request absent from the result takes its own pass: a sparse keyspace,
    a resident string stats set, a failed preparation (the own pass
    raises it into the analyzers' failure metrics), a set that failed
    after the dispatch.

    Fault rung: a ``DeviceException`` of the fused dispatch demotes its
    group (a ``fusion_demote`` degradation: passes, keyspace, reason), and
    each member counts in its own dispatch from the keys it prepared —
    nothing is prepared again."""
    preps: Dict[int, _GroupPrep] = {}
    for i, req in enumerate(requests):
        if req.mode == "stats" and _resident_stats_eligible(table, req.columns, device):
            continue
        try:
            prep = _prepare_grouping(
                table, list(req.columns), device, True, with_values=req.mode == "freq"
            )
        except Exception:  # noqa: BLE001 — its own pass re-raises it as a failure metric
            continue
        if prep.dense:
            preps[i] = prep

    # greedy packing: the fused dispatch counts into one vector of the
    # summed width, which must stay dense
    groups: List[List[int]] = []
    width = 0
    for i in sorted(preps):
        if groups and width + preps[i].keyspace <= DENSE_KEYSPACE_LIMIT:
            groups[-1].append(i)
            width += preps[i].keyspace
        else:
            groups.append([i])
            width = preps[i].keyspace

    results: Dict[int, object] = {}
    for group in groups:
        sliced: Optional[List[np.ndarray]] = None
        if len(group) >= 2:
            keyspaces = [preps[i].keyspace for i in group]
            try:
                counts = _fused_device_bincount(
                    [preps[i].keys for i in group], keyspaces, device
                )
            except DeviceException as e:
                SCAN_STATS.record_degradation(
                    "fusion_demote", passes=len(group),
                    keyspace=int(sum(keyspaces)), reason=str(e),
                )
            else:
                offsets = np.cumsum([0] + keyspaces[:-1])
                sliced = [counts[o:o + k] for o, k in zip(offsets, keyspaces)]
                SCAN_STATS.record_fused_group_pass(len(group))
        for j, i in enumerate(group):
            req, prep = requests[i], preps[i]
            try:
                counts = (
                    sliced[j] if sliced is not None
                    else _device_bincount(prep.keys, prep.keyspace, device)
                )
                if req.mode == "stats":
                    state = _count_stats_from_counts(counts[counts > 0], prep.num_rows)
                else:
                    digit_cols, vec = _dense_digits(prep, counts)
                    state = _freq_state_from_digits(
                        req.columns, digit_cols, vec, prep.value_arrays, prep.num_rows
                    )
            except Exception:  # noqa: BLE001 — its own pass gives the failure metric
                continue
            SCAN_STATS.bump(grouping_passes=1)
            SCAN_STATS.bump(rows_scanned=table.num_rows)
            results[i] = state
    return results


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
    SCAN_STATS.bump(grouping_passes=1)
    SCAN_STATS.bump(rows_scanned=table.num_rows)
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

    if table.num_rows <= host_group_limit():
        SCAN_STATS.record_hist_dispatch("host")
        counts = np.bincount(codes, minlength=num_segments).astype(np.int64)
        if nv_code >= 0:
            counts[nv_code] += counts[0]
            counts[0] = 0
        num_groups = int((counts > 0).sum())
        top_idx = np.argsort(-counts, kind="stable")[:kk]
        top_counts = counts[top_idx]
    else:
        variant = _hist_variant(num_segments + 1, len(codes), device)
        with device_boundary("execute"):
            counts = _member_counts(
                [codes], lambda segs: bincount_variant(variant, segs[0], num_segments), device
            )
            _record_dispatch(variant, counts)
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
