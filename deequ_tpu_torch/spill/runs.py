"""Sorted-run files — the on-disk unit of the out-of-core spill engine.

A *run* is a sequence of canonically sorted, key-unique frequency blocks:
per block a counts vector plus one typed key column (values + null mask)
per grouping column, encoded with the SAME key-column codec the v3
frequency state payload uses (states/serde.py:encode_key_column), so the
two on-disk key encodings cannot drift apart. Because the frequency
monoid's merge is a sorted-merge-add, runs need no index or bloom
structures — the k-way merger (spill/merge.py) streams them back with one
block buffered per run.

Canonical key order (shared contract with spill/order.py): per column,
null sorts first, then values ascending, with float NaN collapsing to ONE
key that sorts last — exactly the order ``np.unique(equal_nan=True)``
codes induce, i.e. the order ``FrequenciesAndNumRows.sum`` already emits.

Layout: ``MAGIC(4) | VERSION(u16) | n_cols(u16)`` then repeated blocks of
``block_nbytes(i64) | crc32(u32) | G(i64) | counts(<i8 * G) | key column
blocks``; all integers little-endian, EOF terminates. The per-block crc32
is new in v2 (torn/corrupted blocks surface as a typed
CorruptStateException instead of a struct error); v1 files — no crc —
still read. File opens run under the process retry policy
(resilience/retry.py), so a transient IOError costs a backoff, not the
whole spilled grouping.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.states.serde import decode_key_column, encode_key_column

MAGIC = b"DQRN"
VERSION = 2

_u16 = struct.Struct("<H")
_u32 = struct.Struct("<I")
_i64 = struct.Struct("<q")

# A frequency block: (key_values per column, key_nulls per column, counts).
Block = Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...], np.ndarray]


def encode_block(
    key_values: Tuple[np.ndarray, ...],
    key_nulls: Tuple[np.ndarray, ...],
    counts: np.ndarray,
) -> bytes:
    G = len(counts)
    out = [_i64.pack(G), np.ascontiguousarray(counts, dtype="<i8").tobytes()]
    for values, nulls in zip(key_values, key_nulls):
        out.append(encode_key_column(values, nulls))
    return b"".join(out)


def decode_block(buf: bytes, n_cols: int) -> Block:
    (G,) = _i64.unpack_from(buf, 0)
    off = 8
    counts = np.frombuffer(buf, dtype="<i8", count=G, offset=off).copy()
    off += 8 * G
    key_values = []
    key_nulls = []
    for _ in range(n_cols):
        values, nulls, off = decode_key_column(buf, off, G)
        key_values.append(values)
        key_nulls.append(nulls)
    return tuple(key_values), tuple(key_nulls), counts


class RunWriter:
    """Appends sorted blocks to one run file. The caller guarantees blocks
    arrive in canonical key order with globally unique keys across the run
    (the store sorts + dedups before flushing)."""

    def __init__(self, path: str, n_cols: int):
        from deequ_tpu_torch.resilience.retry import retry_call

        self.path = path
        self.n_cols = n_cols
        self.groups_written = 0
        self.bytes_written = 0
        self._f = retry_call(
            lambda: open(path, "wb"), what=f"open spill run {path}"
        )
        header = MAGIC + _u16.pack(VERSION) + _u16.pack(n_cols)
        self._f.write(header)
        self.bytes_written += len(header)

    def write_block(
        self,
        key_values: Tuple[np.ndarray, ...],
        key_nulls: Tuple[np.ndarray, ...],
        counts: np.ndarray,
    ) -> None:
        if len(counts) == 0:
            return
        payload = encode_block(key_values, key_nulls, counts)
        self._f.write(_i64.pack(len(payload)))
        self._f.write(_u32.pack(zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self.groups_written += len(counts)
        self.bytes_written += 12 + len(payload)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def write_run(
    path: str, blocks: Iterator[Block], n_cols: int
) -> RunWriter:
    """Spool an iterator of sorted blocks into one run file; returns the
    closed writer (for its stats)."""
    writer = RunWriter(path, n_cols)
    try:
        for key_values, key_nulls, counts in blocks:
            writer.write_block(key_values, key_nulls, counts)
    finally:
        writer.close()
    return writer


class RunReader:
    """Streams one run's blocks back; holds ONE block in memory."""

    def __init__(self, path: str):
        from deequ_tpu_torch.resilience.retry import retry_call

        self.path = path
        self.bytes_read = 0
        with retry_call(
            lambda: open(path, "rb"), what=f"open spill run {path}"
        ) as f:
            header = f.read(8)
        if header[:4] != MAGIC:
            raise ValueError(f"{path} is not a spill run file (bad magic)")
        (self.version,) = _u16.unpack_from(header, 4)
        if self.version > VERSION:
            raise ValueError(
                f"spill run version {self.version} is newer than supported "
                f"{VERSION}"
            )
        (self.n_cols,) = _u16.unpack_from(header, 6)

    def blocks(self) -> Iterator[Block]:
        from deequ_tpu_torch.resilience.retry import retry_call

        with retry_call(
            lambda: open(self.path, "rb"), what=f"open spill run {self.path}"
        ) as f:
            f.seek(8)
            while True:
                size_raw = f.read(8)
                if len(size_raw) < 8:
                    return
                (nbytes,) = _i64.unpack(size_raw)
                crc = None
                if self.version >= 2:
                    crc_raw = f.read(4)
                    if len(crc_raw) < 4:
                        raise CorruptStateException(
                            f"spill run {self.path}", "truncated block header"
                        )
                    (crc,) = _u32.unpack(crc_raw)
                payload = f.read(nbytes)
                if len(payload) < nbytes:
                    raise CorruptStateException(
                        f"spill run {self.path}",
                        f"torn block: expected {nbytes} bytes, "
                        f"found {len(payload)}",
                    )
                if crc is not None and (
                    zlib.crc32(payload) & 0xFFFFFFFF
                ) != crc:
                    raise CorruptStateException(
                        f"spill run {self.path}", "block checksum mismatch"
                    )
                self.bytes_read += (12 if crc is not None else 8) + nbytes
                yield decode_block(payload, self.n_cols)
