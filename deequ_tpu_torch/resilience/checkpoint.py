"""Checkpoint and resume for streaming verification runs (the port's copy
of ``deequ_tpu/resilience/checkpoint.py``; its files are the reference's
byte for byte, so either package resumes the other's).

A streaming pass that dies at batch N must not restart from batch 0: the
runner's fold of each analyzer is a binary-counter stack of partial
states (``StreamStateFolder``), and that stack is the whole fold state —
persisting it and the next batch index resumes the fold with the
association an uninterrupted run uses, so resumed metrics are bit for
bit those of an uninterrupted checkpointed run.

States serialise through ``states/serde.py``; checkpoint files are
checksummed (a torn or corrupt checkpoint is skipped for the one before
it) and written atomically, so a crash while checkpointing costs at most
one checkpoint interval, never the run.

File layout of a checkpoint: ``DQCP | version(u16) | fingerprint |
batch_index(i64) | skipped list | failures | fold stacks`` inside a
checksum envelope (``resilience/atomic.py``), named
``ckpt_<batch_index>.dqck``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.resilience.atomic import atomic_write_bytes, read_checksummed

MAGIC = b"DQCP"
VERSION = 1

_u16 = struct.Struct("<H")
_i64 = struct.Struct("<q")

# a fold stack as persisted: [(level, state), ...] exactly as
# StreamStateFolder._stack holds it
FoldStack = List[Tuple[int, object]]


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _i64.pack(len(raw)) + raw


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = _i64.unpack_from(buf, off)
    off += 8
    return buf[off:off + n].decode("utf-8"), off + n


@dataclass
class StreamCheckpoint:
    """One recovered snapshot of a streaming run's fold state.

    ``failed`` maps fold keys to the failure message of analyzers that
    had already dropped out when the checkpoint was taken: a resumed run
    must keep them failed — reviving one would report a success metric
    computed over a gap of batches."""

    batch_index: int  # batches fully folded; resume reads from this index
    skipped: List[int] = field(default_factory=list)
    stacks: Dict[str, FoldStack] = field(default_factory=dict)
    failed: Dict[str, str] = field(default_factory=dict)


def _encode(fingerprint: str, ckpt: StreamCheckpoint) -> bytes:
    from deequ_tpu_torch.states.serde import serialize_state

    out = [MAGIC, _u16.pack(VERSION), _pack_str(fingerprint)]
    out.append(_i64.pack(ckpt.batch_index))
    out.append(_i64.pack(len(ckpt.skipped)))
    for i in ckpt.skipped:
        out.append(_i64.pack(i))
    out.append(_i64.pack(len(ckpt.failed)))
    for key in sorted(ckpt.failed):
        out.append(_pack_str(key))
        out.append(_pack_str(ckpt.failed[key]))
    out.append(_i64.pack(len(ckpt.stacks)))
    for key in sorted(ckpt.stacks):
        out.append(_pack_str(key))
        stack = ckpt.stacks[key]
        out.append(_i64.pack(len(stack)))
        for level, state in stack:
            blob = serialize_state(state)
            out.append(_i64.pack(level))
            out.append(_i64.pack(len(blob)))
            out.append(blob)
    return b"".join(out)


def _decode(payload: bytes, what: str) -> Tuple[str, StreamCheckpoint]:
    from deequ_tpu_torch.states.serde import deserialize_state

    if payload[:4] != MAGIC:
        raise CorruptStateException(what, "bad checkpoint magic")
    (version,) = _u16.unpack_from(payload, 4)
    if version > VERSION:
        raise CorruptStateException(
            what, f"checkpoint version {version} newer than supported {VERSION}"
        )
    off = 6
    fingerprint, off = _unpack_str(payload, off)
    (batch_index,) = _i64.unpack_from(payload, off); off += 8
    (n_skipped,) = _i64.unpack_from(payload, off); off += 8
    skipped = []
    for _ in range(n_skipped):
        (i,) = _i64.unpack_from(payload, off); off += 8
        skipped.append(i)
    (n_failed,) = _i64.unpack_from(payload, off); off += 8
    failed: Dict[str, str] = {}
    for _ in range(n_failed):
        key, off = _unpack_str(payload, off)
        msg, off = _unpack_str(payload, off)
        failed[key] = msg
    (n_entries,) = _i64.unpack_from(payload, off); off += 8
    stacks: Dict[str, FoldStack] = {}
    for _ in range(n_entries):
        key, off = _unpack_str(payload, off)
        (n_stack,) = _i64.unpack_from(payload, off); off += 8
        stack: FoldStack = []
        for _ in range(n_stack):
            (level,) = _i64.unpack_from(payload, off); off += 8
            (blob_len,) = _i64.unpack_from(payload, off); off += 8
            stack.append(
                (level, deserialize_state(payload[off:off + blob_len]))
            )
            off += blob_len
        stacks[key] = stack
    return fingerprint, StreamCheckpoint(batch_index, skipped, stacks, failed)


class StreamCheckpointer:
    """Owns one checkpoint directory for one logical streaming run.

    ``fingerprint`` ties checkpoints to the run's configuration (analyzer
    set + batch geometry): a checkpoint written under a different
    fingerprint is ignored on resume rather than folded into the wrong
    run. The last ``keep`` checkpoints are retained so a checkpoint torn
    by a crash falls back to its predecessor.
    """

    def __init__(
        self,
        directory: str,
        every_batches: int = 8,
        keep: int = 2,
        retry=None,
    ):
        from deequ_tpu_torch.data.fs import filesystem_for, strip_scheme
        from deequ_tpu_torch.resilience.retry import RetryingFileSystem

        if every_batches < 1:
            raise ValueError("every_batches must be >= 1")
        self.directory = strip_scheme(directory)
        self.every_batches = int(every_batches)
        self.keep = int(keep)
        self._fs = RetryingFileSystem(filesystem_for(directory), retry)
        self._retry = retry
        # how many saves happened and how many failed
        self.saves = 0
        self.save_failures = 0

    def due(self, n_done: int) -> bool:
        """True when a checkpoint is due after ``n_done`` folded batches —
        ALSO the point where the runner's deferred device-folded scans
        must drain: the persisted fold stacks have to cover every batch
        up to ``n_done``, so device->host fetches happen exactly at
        checkpoint boundaries instead of once per batch."""
        return n_done % self.every_batches == 0

    def _path(self, batch_index: int) -> str:
        return self._fs.join(self.directory, f"ckpt_{batch_index:010d}.dqck")

    def _list(self) -> List[str]:
        if not self._fs.exists(self.directory):
            return []
        return [
            n
            for n in self._fs.listdir(self.directory)
            if n.startswith("ckpt_") and n.endswith(".dqck")
        ]

    def save(self, fingerprint: str, ckpt: StreamCheckpoint) -> bool:
        """Persist one checkpoint (atomic + checksummed). Returns False —
        and keeps the run alive — when storage refuses past retries OR a
        fold state has no registered codec (a user-defined State type): a
        failed checkpoint degrades resumability, not correctness."""
        from deequ_tpu_torch.resilience.atomic import wrap_checksum

        try:
            payload = wrap_checksum(_encode(fingerprint, ckpt))
            self._fs.makedirs(self.directory)
            atomic_write_bytes(
                self._fs, self._path(ckpt.batch_index), payload,
                retry=self._retry,
                what=f"checkpoint at batch {ckpt.batch_index}",
            )
        except Exception:  # noqa: BLE001 — checkpointing is best-effort
            self.save_failures += 1
            return False
        self.saves += 1
        self._prune()
        return True

    def _prune(self) -> None:
        try:
            names = sorted(self._list())
        except Exception:  # noqa: BLE001 — pruning is housekeeping only
            return
        for stale in names[: max(len(names) - self.keep, 0)]:
            try:
                self._fs.delete(self._fs.join(self.directory, stale))
            except Exception:  # noqa: BLE001 — stale files are harmless
                pass

    def load_latest(self, fingerprint: str) -> Optional[StreamCheckpoint]:
        """Newest valid checkpoint matching ``fingerprint`` — corrupt or
        mismatched files are skipped (falling back to older ones), never
        fatal: worst case the run restarts from batch 0. A checkpoint
        store that cannot even be LISTED degrades the same way."""
        try:
            names = sorted(self._list(), reverse=True)
        except Exception:  # noqa: BLE001 — unreachable store: start fresh
            return None
        for name in names:
            path = self._fs.join(self.directory, name)
            try:
                payload = read_checksummed(
                    self._fs, path, f"checkpoint {name}", retry=self._retry
                )
                found_fp, ckpt = _decode(payload, f"checkpoint {name}")
            except Exception:  # noqa: BLE001 — damaged checkpoint: fall back
                continue
            if found_fp != fingerprint:
                continue
            return ckpt
        return None

    def clear(self) -> None:
        """Drop all checkpoints (called after a run completes so the next
        run of this directory starts fresh)."""
        try:
            names = self._list()
        except Exception:  # noqa: BLE001 — unreachable store: nothing kept
            return
        for name in names:
            try:
                self._fs.delete(self._fs.join(self.directory, name))
            except Exception:  # noqa: BLE001
                pass


def run_fingerprint(keys, batch_rows) -> str:
    """Stable identity of a streaming run's fold configuration: the sorted
    fold keys plus the batch geometry (batch boundaries must match for a
    resumed fold to be meaningful)."""
    import hashlib

    basis = repr((sorted(keys), batch_rows)).encode()
    return hashlib.sha1(basis).hexdigest()
