"""Versioned binary encodings of analyzer states — the port's copy of
``deequ_tpu/states/serde.py``, byte for byte the same format, so a state
file written by either package decodes in the other.

Layout: ``MAGIC(4) | VERSION(u16) | TYPE_TAG(u16) | payload``, integers
little-endian; an explicit payload codec a state type (tags 1–12), never
pickle.

Version history (every older version still decodes): v1 the original;
v2 appends the KLL compaction-RNG position (``rng_count``, 0 in v1
blobs); v3 encodes FrequenciesAndNumRows as columnar blocks (one typed
array a grouping column plus a counts vector; v1/v2 per-cell payloads
still decode); v4 appends the HLL ``hash_version`` (1 in older blobs).
Tag 13 is the disk-backed ``SpilledFrequencies`` (``spill/store.py``):
its payload streams run blocks in and out and never builds the whole
table.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, Tuple, Type

import numpy as np

from deequ_tpu_torch.analyzers.base import State

MAGIC = b"DQTS"
VERSION = 4

#: the tag of the spilled frequency state (spill/store.py)
SPILLED_FREQUENCIES_TAG = 13

_u16 = struct.Struct("<H")
_i64 = struct.Struct("<q")
_f64 = struct.Struct("<d")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _i64.pack(len(raw)) + raw


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = _i64.unpack_from(buf, off)
    off += 8
    return buf[off:off + n].decode("utf-8"), off + n


# -- v1/v2 per-group cells (decode only) ------------------------------------

_CELL_NULL, _CELL_STR, _CELL_INT, _CELL_FLOAT, _CELL_BOOL = range(5)


def _unpack_cell(buf: bytes, off: int):
    tag = buf[off]
    off += 1
    if tag == _CELL_NULL:
        return None, off
    if tag == _CELL_BOOL:
        return bool(buf[off]), off + 1
    if tag == _CELL_INT:
        (v,) = _i64.unpack_from(buf, off)
        return v, off + 8
    if tag == _CELL_FLOAT:
        (v,) = _f64.unpack_from(buf, off)
        return v, off + 8
    if tag == _CELL_STR:
        return _unpack_str(buf, off)
    raise ValueError(f"unknown group-cell tag {tag}")


# -- per-type codecs --------------------------------------------------------


def _codec_scalars(cls, fields: str):
    """Codec of a flat dataclass of i64 ('q') / f64 ('d') fields."""
    fmt = struct.Struct("<" + fields)
    names = list(cls.__dataclass_fields__)

    def enc(state) -> bytes:
        return fmt.pack(*(getattr(state, n) for n in names))

    def dec(buf: bytes, version: int):
        return cls(*fmt.unpack(buf))

    return enc, dec


def _enc_hll(state) -> bytes:
    regs = np.asarray(state.registers, dtype=np.int64)
    return (
        _i64.pack(len(regs))
        + (regs & 0xFF).astype(np.uint8).tobytes()
        # v4: which hash suite filled the registers
        + _u16.pack(state.hash_version)
    )


def _dec_hll(buf: bytes, version: int):
    from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinctState

    (n,) = _i64.unpack_from(buf, 0)
    hash_version = 1  # pre-v4 blobs were always the u64 splitmix suite
    if version >= 4:
        (hash_version,) = _u16.unpack_from(buf, 8 + n)
    return ApproxCountDistinctState(tuple(buf[8:8 + n]), hash_version)


def _enc_kll(state) -> bytes:
    sketch = state.sketch
    out = [
        _i64.pack(sketch.sketch_size),
        _f64.pack(sketch.shrinking_factor),
        _i64.pack(sketch.count),
        _f64.pack(state.global_min),
        _f64.pack(state.global_max),
        _i64.pack(len(sketch.compactors)),
    ]
    for level in sketch.compactors:
        arr = np.asarray(level, dtype="<f8")
        out.append(_i64.pack(len(arr)))
        out.append(arr.tobytes())
    # v2: the compaction-RNG position, so a loaded sketch continues the
    # same bit stream
    out.append(_i64.pack(sketch.rng_count))
    return b"".join(out)


def _dec_kll(buf: bytes, version: int):
    from deequ_tpu_torch.analyzers.sketches import KLLState
    from deequ_tpu_torch.ops.kll import KLLSketchState

    off = 0
    (sketch_size,) = _i64.unpack_from(buf, off); off += 8
    (shrinking,) = _f64.unpack_from(buf, off); off += 8
    (count,) = _i64.unpack_from(buf, off); off += 8
    (gmin,) = _f64.unpack_from(buf, off); off += 8
    (gmax,) = _f64.unpack_from(buf, off); off += 8
    (n_levels,) = _i64.unpack_from(buf, off); off += 8
    compactors = []
    for _ in range(n_levels):
        (n,) = _i64.unpack_from(buf, off); off += 8
        compactors.append(np.frombuffer(buf, dtype="<f8", count=n, offset=off).copy())
        off += 8 * n
    rng_count = 0
    if version >= 2:  # v1 blobs predate the field
        (rng_count,) = _i64.unpack_from(buf, off)
    sketch = KLLSketchState(sketch_size, shrinking, compactors, count, rng_count)
    return KLLState(sketch, gmin, gmax)


# columnar key-column kinds (v3 frequency payloads)
_KCOL_STR, _KCOL_INT, _KCOL_FLOAT, _KCOL_BOOL = range(4)


def encode_key_column(values, nulls) -> bytes:
    """One typed key column (values + null mask) -> bytes: packed null
    bits, a kind tag, then the raw array (strings as little-endian UCS4 of
    the column's width: one buffer copy each way)."""
    out = [np.packbits(np.asarray(nulls, dtype=bool)).tobytes()]
    kind = values.dtype.kind
    if kind in ("U", "S", "O"):
        svals = values.astype(np.str_)
        width = max(svals.dtype.itemsize // 4, 1)
        out.append(bytes([_KCOL_STR]))
        out.append(_i64.pack(width))
        out.append(np.ascontiguousarray(svals.astype(f"<U{width}")).tobytes())
    elif values.dtype == np.bool_:
        out.append(bytes([_KCOL_BOOL]))
        out.append(np.packbits(values).tobytes())
    elif kind in "iu":
        if kind == "u" and len(values) and int(values.max()) >= 2 ** 63:
            raise ValueError(
                "frequency state has unsigned int group keys >= 2^63; "
                "the <i8 wire format cannot represent them"
            )
        out.append(bytes([_KCOL_INT]))
        out.append(np.ascontiguousarray(values, dtype="<i8").tobytes())
    else:
        out.append(bytes([_KCOL_FLOAT]))
        out.append(np.ascontiguousarray(values, dtype="<f8").tobytes())
    return b"".join(out)


def decode_key_column(buf: bytes, off: int, G: int):
    """Inverse of :func:`encode_key_column`: (values, nulls, off)."""
    nbytes_mask = (G + 7) // 8
    nulls = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8, count=nbytes_mask, offset=off), count=G,
    ).astype(bool)
    off += nbytes_mask
    kind = buf[off]
    off += 1
    if kind == _KCOL_STR:
        (width,) = _i64.unpack_from(buf, off); off += 8
        values = (
            np.frombuffer(buf, dtype=f"<U{width}", count=G, offset=off).copy()
            if G else np.empty(0, dtype=np.str_)
        )
        off += 4 * width * G
    elif kind == _KCOL_BOOL:
        values = np.unpackbits(
            np.frombuffer(buf, dtype=np.uint8, count=nbytes_mask, offset=off), count=G,
        ).astype(bool)
        off += nbytes_mask
    elif kind == _KCOL_INT:
        values = np.frombuffer(buf, dtype="<i8", count=G, offset=off).copy()
        off += 8 * G
    elif kind == _KCOL_FLOAT:
        values = np.frombuffer(buf, dtype="<f8", count=G, offset=off).copy()
        off += 8 * G
    else:
        raise ValueError(f"unknown key-column kind {kind}")
    return values, nulls, off


def _enc_freq(state) -> bytes:
    """v3 columnar: array blobs, no loop over groups."""
    out = [_i64.pack(len(state.columns))]
    for c in state.columns:
        out.append(_pack_str(c))
    out.append(_i64.pack(state.num_rows))
    out.append(_i64.pack(state.num_groups))
    out.append(np.ascontiguousarray(state.counts, dtype="<i8").tobytes())
    for values, nulls in zip(state.key_values, state.key_nulls):
        out.append(encode_key_column(values, nulls))
    return b"".join(out)


def _dec_freq(buf: bytes, version: int):
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows

    off = 0
    (n_cols,) = _i64.unpack_from(buf, off); off += 8
    columns = []
    for _ in range(n_cols):
        c, off = _unpack_str(buf, off)
        columns.append(c)
    (num_rows,) = _i64.unpack_from(buf, off); off += 8
    (G,) = _i64.unpack_from(buf, off); off += 8
    if version < 3:  # v1/v2: interleaved per-group cells
        freqs = {}
        for _ in range(G):
            group = []
            for _ in range(n_cols):
                cell, off = _unpack_cell(buf, off)
                group.append(cell)
            (count,) = _i64.unpack_from(buf, off); off += 8
            freqs[tuple(group)] = count
        return FrequenciesAndNumRows.from_dict(columns, freqs, num_rows)
    counts = np.frombuffer(buf, dtype="<i8", count=G, offset=off).copy()
    off += 8 * G
    key_values, key_nulls = [], []
    for _ in range(n_cols):
        values, nulls, off = decode_key_column(buf, off, G)
        key_values.append(values)
        key_nulls.append(nulls)
    return FrequenciesAndNumRows(
        tuple(columns), tuple(key_values), tuple(key_nulls), counts, num_rows
    )


def _enc_spilled(state) -> bytes:
    """Tag-13 payload: a SpilledFrequencies streams out as a header
    (columns, num_rows, budget) and length-prefixed sorted blocks in the
    run-block codec, so encoding never materialises the table; a -1
    length ends the block list."""
    from deequ_tpu_torch.spill.runs import encode_block

    out = [_i64.pack(len(state.columns))]
    for c in state.columns:
        out.append(_pack_str(c))
    out.append(_i64.pack(state.num_rows))
    out.append(_i64.pack(state._store.budget_bytes))
    for kv, kn, counts in state.blocks():
        payload = encode_block(kv, kn, counts)
        out.append(_i64.pack(len(payload)))
        out.append(payload)
    out.append(_i64.pack(-1))
    return b"".join(out)


def _dec_spilled(buf: bytes, version: int):
    """A disk-backed state again: the blocks decode straight into a fresh
    store's run file (they are globally sorted and key-unique), so the
    loaded state keeps the bounded-memory contract."""
    from deequ_tpu_torch.spill.runs import decode_block
    from deequ_tpu_torch.spill.store import SpilledFrequencies, SpillingFrequencyStore

    off = 0
    (n_cols,) = _i64.unpack_from(buf, off); off += 8
    columns = []
    for _ in range(n_cols):
        c, off = _unpack_str(buf, off)
        columns.append(c)
    (num_rows,) = _i64.unpack_from(buf, off); off += 8
    (budget,) = _i64.unpack_from(buf, off); off += 8
    store = SpillingFrequencyStore(tuple(columns), budget)

    def block_iter():
        nonlocal off
        while True:
            (nbytes,) = _i64.unpack_from(buf, off)
            off += 8
            if nbytes < 0:
                return
            yield decode_block(buf[off:off + nbytes], n_cols)
            off += nbytes

    store._adopt_sorted_blocks(block_iter(), num_rows)
    return SpilledFrequencies(store)


def _registry() -> Dict[Type[State], Tuple[int, Callable, Callable]]:
    from deequ_tpu_torch.analyzers import grouping, sketches, states

    reg: Dict[Type[State], Tuple[int, Callable, Callable]] = {}

    def add(tag, cls, enc, dec):
        reg[cls] = (tag, enc, dec)

    add(1, states.NumMatches, *_codec_scalars(states.NumMatches, "q"))
    add(2, states.NumMatchesAndCount, *_codec_scalars(states.NumMatchesAndCount, "qq"))
    add(3, states.MinState, *_codec_scalars(states.MinState, "d"))
    add(4, states.MaxState, *_codec_scalars(states.MaxState, "d"))
    add(5, states.MeanState, *_codec_scalars(states.MeanState, "dq"))
    add(6, states.SumState, *_codec_scalars(states.SumState, "d"))
    add(7, states.StandardDeviationState,
        *_codec_scalars(states.StandardDeviationState, "ddd"))
    add(8, states.CorrelationState, *_codec_scalars(states.CorrelationState, "dddddd"))
    add(9, states.DataTypeHistogram, *_codec_scalars(states.DataTypeHistogram, "qqqqq"))
    add(10, sketches.ApproxCountDistinctState, _enc_hll, _dec_hll)
    add(11, sketches.KLLState, _enc_kll, _dec_kll)
    add(12, grouping.FrequenciesAndNumRows, _enc_freq, _dec_freq)
    from deequ_tpu_torch.spill.store import SpilledFrequencies

    add(SPILLED_FREQUENCIES_TAG, SpilledFrequencies, _enc_spilled, _dec_spilled)
    return reg


_REG = None
_BY_TAG = None


def _ensure_registry():
    global _REG, _BY_TAG
    if _REG is None:
        _REG = _registry()
        _BY_TAG = {tag: (cls, enc, dec) for cls, (tag, enc, dec) in _REG.items()}
    return _REG, _BY_TAG


def serialize_state(state: State) -> bytes:
    """State -> versioned bytes; TypeError for a type with no codec."""
    reg, _ = _ensure_registry()
    entry = reg.get(type(state))
    if entry is None:
        raise TypeError(
            f"no binary codec registered for state type {type(state).__name__}"
        )
    tag, enc, _dec = entry
    return MAGIC + _u16.pack(VERSION) + _u16.pack(tag) + enc(state)


def deserialize_state(data: bytes) -> State:
    """Versioned bytes -> State. Refuses a pickle file, a bad magic, a
    version newer than :data:`VERSION` and an unknown tag (ValueError)."""
    if data[:4] != MAGIC:
        if data[:1] == b"\x80":  # pickle protocol header
            raise ValueError(
                "legacy pickle state file from a pre-1.0 snapshot; "
                "recompute the state (or load it with that version) — "
                "pickle states are no longer read for safety"
            )
        raise ValueError("not a deequ_tpu state file (bad magic)")
    (version,) = _u16.unpack_from(data, 4)
    if version > VERSION:
        raise ValueError(
            f"state file version {version} is newer than supported {VERSION}"
        )
    (tag,) = _u16.unpack_from(data, 6)
    _, by_tag = _ensure_registry()
    entry = by_tag.get(tag)
    if entry is None:
        raise ValueError(f"unknown state type tag {tag}")
    _cls, _enc, dec = entry
    return dec(data[8:], version)
