"""Crash-safe persistence: write-temp-fsync-rename and a checksum
envelope — the port's copy of ``deequ_tpu/resilience/atomic.py``.

A state file that tears mid-write is never half-readable: a reader sees
the previous complete file (atomic rename) or fails typed
(``CorruptStateException``) instead of decoding garbage.

The envelope is ``DQX1 | crc32 (u32) | length (i64) | payload``, the
reference's byte for byte, so either package reads the other's files;
``has_checksum`` tells enveloped files from raw payloads, which still
load.
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from typing import Optional

from deequ_tpu_torch.exceptions import CorruptStateException

CHECKSUM_MAGIC = b"DQX1"

_u32 = struct.Struct("<I")
_i64 = struct.Struct("<q")

# process-unique temp suffixes: the pid guards against other processes,
# the counter against concurrent writers of one path in this one
_tmp_counter = itertools.count()


def wrap_checksum(payload: bytes) -> bytes:
    """payload -> checksummed envelope bytes."""
    return (
        CHECKSUM_MAGIC
        + _u32.pack(zlib.crc32(payload) & 0xFFFFFFFF)
        + _i64.pack(len(payload))
        + payload
    )


def has_checksum(data: bytes) -> bool:
    return data[:4] == CHECKSUM_MAGIC


def unwrap_checksum(data: bytes, what: str) -> bytes:
    """Envelope bytes -> payload; CorruptStateException on any damage (bad
    magic, truncation, crc mismatch)."""
    if not has_checksum(data):
        raise CorruptStateException(what, "missing checksum envelope")
    if len(data) < 16:
        raise CorruptStateException(what, "truncated envelope header")
    (crc,) = _u32.unpack_from(data, 4)
    (length,) = _i64.unpack_from(data, 8)
    payload = data[16:]
    if len(payload) != length:
        raise CorruptStateException(
            what, f"torn write: expected {length} payload bytes, found {len(payload)}"
        )
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise CorruptStateException(what, "checksum mismatch")
    return payload


def _fsync_if_possible(handle) -> None:
    """Flush and fsync ``handle`` before the commit rename; a handle with
    no file descriptor (in-memory, object stores) is only flushed — the
    rename still gives all-or-nothing visibility there. Failures
    propagate while the rename is unreached."""
    try:
        fd = handle.fileno()
    except (AttributeError, ValueError, OSError):
        flush = getattr(handle, "flush", None)
        if flush is not None:
            flush()
        return
    handle.flush()
    os.fsync(fd)


def quarantine_path(fs, path: str, suffix: str = ".corrupt") -> str:
    """The first unused quarantine name for ``path`` on ``fs``: ``path +
    suffix``, then ``.corrupt.1``, ``.corrupt.2``, ..., so a second
    recovery in one directory never overwrites the first one's evidence.
    ``fs=None`` checks the local disk with ``os`` (the request ledger)."""
    exists = os.path.exists if fs is None else fs.exists
    candidate = path + suffix
    n = 0
    while exists(candidate):
        n += 1
        candidate = f"{path}{suffix}.{n}"
    return candidate


def atomic_write_bytes(
    fs, path: str, data: bytes, retry=None, what: Optional[str] = None
) -> None:
    """Write ``data`` to ``path`` by temp file + fsync + rename on ``fs``:
    readers see the old complete file or the new one, never a prefix.
    Runs under ``retry`` (a RetryPolicy; the process default when None)."""
    from deequ_tpu_torch.resilience.retry import retry_call

    what = what or f"write {path}"
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"

    def attempt() -> None:
        with fs.open(tmp, "wb") as f:
            f.write(data)
            _fsync_if_possible(f)
        fs.rename(tmp, path)

    try:
        retry_call(attempt, retry, what=what)
    except BaseException:
        try:
            fs.delete(tmp)
        except Exception:  # noqa: BLE001 — best-effort cleanup of the temp file
            pass
        raise


def read_checksummed(fs, path: str, what: str, retry=None) -> bytes:
    """Read and validate a checksummed file; a file without the envelope
    returns its raw bytes unchanged."""
    from deequ_tpu_torch.resilience.retry import retry_call

    def attempt() -> bytes:
        with fs.open(path, "rb") as f:
            return f.read()

    data = retry_call(attempt, retry, what=f"read {path}")
    if has_checksum(data):
        return unwrap_checksum(data, what)
    return data
