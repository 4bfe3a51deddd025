"""The fused scan on one device — the counterpart of
``deequ_tpu/ops/scan_engine.py:run_scan`` for an in-memory table.

One pass over the table runs every scan-shareable analyzer of a run:

- the table is cut into chunks by the reference's rule (``_auto_chunk_rows``);
- ``_ChunkPacker`` packs each chunk into one f64 value plane, one
  validity-mask plane and one string-code plane, and moves each plane to
  the card in one copy;
- one step per chunk evaluates every op's ``update`` on those tensors;
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

The card has native f64, so the port computes in f64 and carries no
counterpart of the reference's (hi, lo) f32 pairs (``ops/df32.py``).
Moments are per-chunk (count, mean, M2) combined with the Chan merge by
the analyzers' states, never a raw sum of squares.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.data.table import Column, DType
from deequ_tpu_torch.exceptions import device_boundary
from deequ_tpu_torch.expr.eval import Val
from deequ_tpu_torch.ops.lut_cache import dictionary_lut_device
from deequ_tpu_torch.ops.scan_plan import plan_scan_ops

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
    fixes a partial's static width) to a dict of partial-state tensors;
    ``tags`` names each leaf's fold tag (:data:`FOLD_TAGS`).

    ``luts``: ``(column, key, build)`` host lookup tables over a string
    column's dictionary, built and moved to the device once per dictionary
    (``ops/lut_cache.py``: ``key`` names the derivation) and read in
    ``update`` as ``vals[column].lut(key)``. ``batch_hint``: ops
    with the same hint kind and parameters may be coalesced into one
    batched op by the runner (``("kll", sketch_size, column)``).

    ``sorts_chunk``: ``update`` sorts each chunk on the device (the KLL
    summary); ``select_update``: the same partials by the radix select,
    which a resident scan runs instead where the select is the faster
    (``ops/scan_plan.py``), and ``select_size`` its sketch size."""

    columns: Tuple[str, ...]
    update: Callable[[Dict[str, Val], torch.Tensor, int, int], Dict[str, torch.Tensor]]
    tags: Dict[str, str]
    luts: Tuple[Tuple[str, str, Callable], ...] = ()
    batch_hint: Optional[Tuple] = None
    sorts_chunk: bool = False
    select_update: Optional[Callable] = None
    select_size: int = 0


class ScanStats:
    """Execution-report counters (the reference's ScanStats, the subset the
    port's slice touches): fused passes, rows scanned, device->host
    fetches and their bytes, grouping passes, device sorts, and the
    histogram census by route — ``hist_kernel_dispatches`` counts
    grouping counts that ran the CUDA kernel (a resident string count:
    one a chunk), ``hist_plain_dispatches`` those that ran its plain
    version on a CPU tensor, ``hist_host_dispatches`` those of tables
    small enough for ``np.bincount`` on the host
    (``segment.HOST_GROUP_LIMIT``).

    Residency (the reference's meanings): ``resident_passes`` scans that
    walked a persisted table, ``bytes_resident`` the resident bytes they
    read (``bytes_packed`` counts only host packing),
    ``encoded_scan_passes`` scans whose layout had an int16 code plane;
    ``device_sort_passes`` chunk sorts (a sorting KLL op a chunk, plus
    the grouping sorts of ``ops/segment.py``) and
    ``device_select_passes`` KLL ops a chunk that ran the radix select
    instead."""

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
        # KLL chunk sorts: one per torch.sort of a KLL op (a batched op
        # sorts all its columns at once), and the columns they sorted
        self.kll_sort_passes = 0
        self.kll_sorted_columns = 0
        # device->host fetches of the most recent fused scan (the
        # one-fetch-per-scan contract: 1)
        self.last_scan_fetches = 0

    def record_fetch(self, nbytes: int) -> None:
        with self._lock:
            self.device_fetches += 1
            self.bytes_fetched += int(nbytes)

    def record_kll_sort(self, columns: int) -> None:
        with self._lock:
            self.kll_sort_passes += 1
            self.kll_sorted_columns += int(columns)

    def record_hist_dispatch(self, route: str) -> None:
        """``route``: "kernel", "plain" or "host"."""
        with self._lock:
            name = f"hist_{route}_dispatches"
            setattr(self, name, getattr(self, name) + 1)

    def snapshot(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}


SCAN_STATS = ScanStats()


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

    def pack(self, start: int, stop: int) -> Tuple[np.ndarray, ...]:
        n = stop - start
        values = np.empty((len(self.numeric_names), n), dtype=np.float64)
        masks = np.empty((len(self.masked_names), n), dtype=np.bool_)
        codes = np.empty((len(self.string_names), n), dtype=np.int32)
        enc = np.empty((len(self.enc_names), n), dtype=np.int16)
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


class _DeviceFoldPlan:
    """Folds per-chunk flat state vectors on the device so a scan fetches
    once (the reference's ``_DeviceFoldPlan``).

    - sum/min/max leaves live in one elementwise f64 accumulator and merge
      with plain f64 add/minimum/maximum in chunk order, starting from the
      monoid identity (0, +inf, -inf) — the same operations, in the same
      order, as the reference's fold;
    - 'gather' leaves (per-chunk Welford moments) are written into row
      ``ci`` of a (chunks, width) buffer — the device equivalent of the
      host concatenation, order preserved.

    Leaves are f64 on the device (counts are exact below 2^53); integer
    leaves come back as int64 at :meth:`unflatten_host`.
    """

    def __init__(self, ops: Sequence[ScanOp], partials, n_chunks: int, device):
        self._layout = []  # per op: [(key, tag, region_offset, size, shape, is_int)]
        elem_src, gather_src = [], []
        sum_mask, min_mask, init = [], [], []
        src = elem_off = gather_off = 0
        for op, part in zip(ops, partials):
            leaves = []
            for key, leaf in part.items():
                tag = op.tags[key]
                if tag not in FOLD_TAGS:
                    raise ValueError(f"unknown fold tag {tag!r}")
                size = leaf.numel()
                is_int = not (leaf.is_floating_point() or leaf.is_complex())
                idx = np.arange(src, src + size)
                if tag == "gather":
                    gather_src.append(idx)
                    leaves.append((key, tag, gather_off, size, tuple(leaf.shape), is_int))
                    gather_off += size
                else:
                    elem_src.append(idx)
                    sum_mask.append(np.full(size, tag == "sum"))
                    min_mask.append(np.full(size, tag == "min"))
                    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[tag]
                    init.append(np.full(size, ident))
                    leaves.append((key, tag, elem_off, size, tuple(leaf.shape), is_int))
                    elem_off += size
                src += size
            self._layout.append(leaves)

        def cat(parts, dtype):
            return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

        def dev(a):
            return torch.from_numpy(a).to(device)

        self.elem_size = elem_off
        self.gather_size = gather_off
        self.n_chunks = n_chunks
        self._elem_src = dev(cat(elem_src, np.int64))
        self._gather_src = dev(cat(gather_src, np.int64))
        self._is_sum = dev(cat(sum_mask, bool))
        self._is_min = dev(cat(min_mask, bool))
        self._acc = dev(cat(init, np.float64))
        self._gathered = torch.zeros(
            (n_chunks, self.gather_size), dtype=torch.float64, device=device
        )
        self._filled = 0

    def merge(self, flat: torch.Tensor) -> None:
        """Fold one chunk's flat vector into the accumulator."""
        if self.elem_size:
            new = flat[self._elem_src]
            acc = self._acc
            self._acc = torch.where(
                self._is_sum,
                acc + new,
                torch.where(
                    self._is_min, torch.minimum(acc, new), torch.maximum(acc, new)
                ),
            )
        if self.gather_size:
            self._gathered[self._filled] = flat[self._gather_src]
        self._filled += 1

    def fetch_unflatten(self) -> List[Dict[str, np.ndarray]]:
        """The scan's one device->host fetch, unpacked into per-op dicts of
        numpy leaves (gather leaves stacked over chunks)."""
        (host,) = fetch(
            torch.cat([self._acc, self._gathered[: self._filled].reshape(-1)])
        )
        elem = host[: self.elem_size]
        gathered = host[self.elem_size:].reshape(self._filled, self.gather_size)
        out = []
        for leaves in self._layout:
            result = {}
            for key, tag, off, size, shape, is_int in leaves:
                if tag == "gather":
                    leaf = gathered[:, off:off + size].reshape((self._filled,) + shape)
                    if not shape:
                        leaf = leaf.reshape(self._filled)
                else:
                    leaf = elem[off:off + size].reshape(shape)
                result[key] = leaf.astype(np.int64) if is_int else leaf
            out.append(result)
        return out


def _flatten(partials: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Every op's partial leaves as ONE f64 vector (order: ops, then keys)."""
    return torch.cat(
        [leaf.reshape(-1).to(torch.float64) for part in partials for leaf in part.values()]
    )


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


class DeviceTableCache:
    """A table's packed chunks resident on one device — the analogue of
    Spark's ``df.persist()`` (the reference's ``DeviceTableCache``):
    ``device_chunks`` holds one tuple of device planes
    (values, masks, codes, enc) a chunk of ``chunk`` rows, packed by
    ``packer`` from every column of the table; ``nbytes`` counts them."""

    def __init__(self, packer: _ChunkPacker, chunk: int, device_chunks, device, nbytes: int):
        self.packer = packer
        self.chunk = chunk
        self.device_chunks = device_chunks
        self.device = torch.device(device)
        self.nbytes = nbytes
        _ACTIVE_CACHES.add(self)

    def matches(self, device, needed_cols) -> bool:
        return torch.device(device) == self.device and set(needed_cols) <= set(
            self.packer.cols
        )


# the live caches, weakly held: persist() checks the combined resident
# bytes of every table persisted on its device against that device's
# budget, not the newest alone
_ACTIVE_CACHES: "weakref.WeakSet[DeviceTableCache]" = weakref.WeakSet()


def total_resident_bytes(device=None) -> int:
    """The resident bytes of every persisted table, or of those on
    ``device`` alone."""
    if device is None:
        return sum(c.nbytes for c in _ACTIVE_CACHES)
    device = torch.device(device)
    return sum(c.nbytes for c in _ACTIVE_CACHES if c.device == device)


def resident_budget(device) -> int:
    """The default cap on resident bytes: :data:`RESIDENT_FRACTION` of the
    card's memory. The CPU has none; its callers pass ``max_bytes``."""
    device = torch.device(device)
    if device.type != "cuda":
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
) -> DeviceTableCache:
    """Pack every column of ``table`` and copy it to ``device`` (resolved
    as every entry point resolves it: ``cuda`` unless the caller asks for
    the CPU) once, into chunks of the reference's resident size; attach
    the cache as ``table._device_cache``. Encoded columns stay encoded
    unless ``encode=False``. Persisting a persisted table replaces its
    chunks. Raises MemoryError, leaving the table not persisted, when the
    combined resident bytes on ``device`` would pass ``max_bytes``
    (:func:`resident_budget` by default)."""
    from deequ_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if max_bytes is None:
        max_bytes = resident_budget(device)
    _evict_device_cache(table)
    cols = {name: table[name] for name in table.column_names}
    n_rows = table.num_rows
    chunk = chunk_rows or min(
        _auto_chunk_rows(cols, RESIDENT_CHUNK_BYTES, RESIDENT_MAX_CHUNK_ROWS),
        max(n_rows, 1),
    )
    packer = _ChunkPacker(cols, encode=True if encode is None else bool(encode))
    base = total_resident_bytes(device)
    device_chunks = []
    nbytes = 0
    for start, stop in _chunk_bounds(n_rows, chunk):
        planes = packer.pack(start, stop)
        nbytes += sum(p.nbytes for p in planes)
        if base + nbytes > max_bytes:
            raise MemoryError(
                f"persist_table: the combined resident size would pass "
                f"{max_bytes} bytes; stream instead or raise max_bytes"
            )
        device_chunks.append(packer.to_device(planes, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cache = DeviceTableCache(packer, chunk, device_chunks, device, nbytes)
    table._device_cache = cache
    return cache


def _evict_device_cache(table) -> int:
    """Drop the table's resident chunks now and take them off the budget;
    returns the bytes freed."""
    cache = getattr(table, "_device_cache", None)
    if cache is None:
        return 0
    freed = cache.nbytes
    cache.device_chunks = []
    cache.nbytes = 0
    _ACTIVE_CACHES.discard(cache)
    table._device_cache = None
    return freed


def _resident_cache(table, device, needed, chunk_rows) -> Optional[DeviceTableCache]:
    """The table's resident cache when it can serve this scan: the same
    device, every needed column, and the chunk size if one was asked."""
    cache = getattr(table, "_device_cache", None)
    if cache is None or not cache.matches(device, needed):
        return None
    if chunk_rows is not None and chunk_rows != cache.chunk:
        return None
    return cache


def run_scan(
    table,
    ops: Sequence[ScanOp],
    device,
    chunk_rows: Optional[int] = None,
    select_kernel: Optional[bool] = None,
) -> List[Dict[str, np.ndarray]]:
    """Run all ops in ONE fused pass over the table on ``device``. Returns
    one dict of reduced numpy leaves per op. The whole pass performs one
    device->host fetch. A table persisted on ``device`` is read from its
    resident chunks (no packing, no copy), and its KLL summaries take the
    radix select unless ``select_kernel`` is False
    (``ops/scan_plan.py``)."""
    device = torch.device(device)
    n_rows = table.num_rows
    needed = sorted({c for op in ops for c in op.columns})
    cache = _resident_cache(table, device, needed, chunk_rows)
    if cache is not None:
        packer, chunk = cache.packer, cache.chunk
    else:
        packer = _ChunkPacker({name: table[name] for name in needed})
        chunk = chunk_rows or min(_auto_chunk_rows(packer.cols), max(n_rows, 1))
    bounds = _chunk_bounds(n_rows, chunk)
    plan = plan_scan_ops(ops, packer, cache is not None, select_kernel, chunk)
    ops = plan.ops
    n_chunks = len(bounds)
    op_luts = _device_luts(ops, packer.cols, device)
    enc_luts = packer.enc_luts(device)
    SCAN_STATS.scan_passes += 1
    SCAN_STATS.rows_scanned += n_rows
    SCAN_STATS.device_sort_passes += plan.sort_ops * n_chunks
    SCAN_STATS.device_select_passes += plan.select_ops * n_chunks
    if plan.encoded_columns:
        SCAN_STATS.encoded_scan_passes += 1
    if cache is not None:
        SCAN_STATS.resident_passes += 1
        SCAN_STATS.bytes_resident += cache.nbytes
    fetches_before = SCAN_STATS.device_fetches

    fold: Optional[_DeviceFoldPlan] = None
    for ci, (start, stop) in enumerate(bounds):
        n = stop - start
        if cache is not None:
            planes = cache.device_chunks[ci]
        else:
            host = packer.pack(start, stop)
            SCAN_STATS.bytes_packed += sum(p.nbytes for p in host)
            planes = packer.to_device(host, device)
        with device_boundary("execute"):
            row_valid = torch.ones(n, dtype=torch.bool, device=device)
            vals = packer.unpack_vals(*planes, row_valid, op_luts, enc_luts, needed)
            partials = [op.update(vals, row_valid, n, chunk) for op in ops]
            if fold is None:
                fold = _DeviceFoldPlan(ops, partials, n_chunks, device)
            fold.merge(_flatten(partials))
        SCAN_STATS.chunks_processed += 1
    results = fold.fetch_unflatten()
    SCAN_STATS.last_scan_fetches = SCAN_STATS.device_fetches - fetches_before
    return results


# -- per-chunk reductions (the f64 counterparts of ops/df32.py) -------------


def masked_count(ok: torch.Tensor) -> torch.Tensor:
    return ok.sum(dtype=torch.int64)


def masked_sum(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, x, 0.0).sum()


def masked_extremum(x: torch.Tensor, ok: torch.Tensor, mode: str) -> torch.Tensor:
    """Min/max of x where ok; the identity (+inf / -inf) when nothing is
    valid — callers guard on the separate count."""
    ident = np.inf if mode == "min" else -np.inf
    if x.numel() == 0:
        return torch.tensor(ident, dtype=torch.float64, device=x.device)
    guarded = torch.where(ok, x, ident)
    return guarded.amin() if mode == "min" else guarded.amax()


def masked_moments(x: torch.Tensor, ok: torch.Tensor):
    """(count, mean, m2) of x where ok — the chunk's Welford state, with
    m2 a centred two-pass sum (reference df32.masked_moments)."""
    cnt = masked_count(ok)
    mean = masked_sum(x, ok) / cnt.clamp(min=1)
    d = torch.where(ok, x - mean, 0.0)
    return cnt, mean, (d * d).sum()


def masked_comoments(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor):
    """(n, x_avg, y_avg, ck, x_mk, y_mk) chunk co-moment state
    (reference df32.masked_comoments, Correlation.scala:37-52)."""
    cnt = masked_count(ok)
    denom = cnt.clamp(min=1)
    ma = masked_sum(a, ok) / denom
    mb = masked_sum(b, ok) / denom
    da = torch.where(ok, a - ma, 0.0)
    db = torch.where(ok, b - mb, 0.0)
    return cnt, ma, mb, (da * db).sum(), (da * da).sum(), (db * db).sum()
