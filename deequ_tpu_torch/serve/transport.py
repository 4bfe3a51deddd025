"""The frame transport — length-prefixed checksummed messages over sockets
or an in-process loopback (the counterpart of
``deequ_tpu/serve/transport.py``).

A frame is the checksummed envelope the resilience tier persists with
(``resilience/atomic.py``): ``DQX1 | crc32 (u32 LE) | length (i64 LE) |
payload``. One format serves the wire and the durable request ledger
(``serve/ledger.py``): a frame read off a socket and a frame replayed off
disk validate through the same ``unwrap_checksum``, and a torn read on
either raises the same typed ``CorruptStateException``. The bytes are the
reference's, so a message dict encodes to the same frame in both packages.

Payloads are JSON objects, so the control fields (ids, tenants, SLO
class, ``retry_after_s``, queue depths) read plainly on the wire and in
the ledger. Python values JSON cannot carry — tables, checks, analyzers,
results, typed exceptions, quarantine snapshots — ride as ``blob`` fields:
base64 text over pickle. That is a trust decision scoped to this
transport's deployment: both ends are the same code on the same machine
under one user, as with multiprocessing's own pickled pipes, and no frame
is accepted from a network listener.

Transports are injectable: :class:`SocketTransport` wraps a connected
socket (a ``socketpair`` end shared with a worker process);
:class:`LoopbackTransport` a pair of in-process queues, so the same
protocol runs in a thread with the same encoding.
"""

from __future__ import annotations

import base64
import io
import json
import pickle
import queue
import select
import socket
import struct
import threading
from typing import Any, Optional

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.resilience.atomic import CHECKSUM_MAGIC, unwrap_checksum, wrap_checksum

#: the envelope header: magic (4) + crc32 (4) + length (8)
FRAME_HEADER_BYTES = 16

_i64 = struct.Struct("<q")

#: a frame declaring a larger payload is refused typed: a damaged length
#: field must not become a multi-GB allocation
MAX_FRAME_BYTES = 1 << 30


# -- blob fields ---------------------------------------------------------------


try:
    # a check's constraints hold closures: stdlib pickle cannot carry a
    # Check, cloudpickle can (it serialises the code; the bytes still load
    # with plain ``pickle.loads``). Without cloudpickle, picklable payloads
    # (tables, analyzers, results, exceptions, quarantine snapshots) still
    # travel, and a check holding a lambda fails with a PicklingError at
    # submit
    import cloudpickle as _blob_pickler
except ImportError:  # pragma: no cover - depends on the installation
    _blob_pickler = pickle


def dump_blob(obj: Any) -> str:
    """A Python object as base64 text for a JSON ``blob`` field."""
    return base64.b64encode(
        _blob_pickler.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)).decode("ascii")


def load_blob(text: str, what: str = "transport blob") -> Any:
    """A ``blob`` field back to its object; undecodable bytes raise a typed
    CorruptStateException (damage is a state fault, not a code fault)."""
    try:
        return pickle.loads(base64.b64decode(text.encode("ascii")))
    except (ValueError, pickle.UnpicklingError, EOFError, AttributeError, ImportError) as e:
        raise CorruptStateException(what, f"undecodable blob: {e}") from e


# -- the frame codec ------------------------------------------------------------


def encode_frame(msg: dict) -> bytes:
    """A message dict as one checksummed wire or ledger frame."""
    return wrap_checksum(
        json.dumps(msg, sort_keys=True, separators=(",", ":")).encode("utf-8"))


def decode_frame(frame: bytes, what: str = "transport frame") -> dict:
    """One whole frame back to its message dict; typed on any damage."""
    payload = unwrap_checksum(frame, what)
    try:
        msg = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise CorruptStateException(
            what, f"checksum passed but payload is not JSON: {e}") from e
    if not isinstance(msg, dict):
        raise CorruptStateException(what, f"frame payload is {type(msg).__name__}, not an object")
    return msg


def _check_header(header: bytes, what: str) -> int:
    """The payload length a whole header declares; typed on a bad magic
    or an implausible length."""
    if header[:4] != CHECKSUM_MAGIC:
        raise CorruptStateException(what, "bad frame magic")
    (length,) = _i64.unpack_from(header, 8)
    if not 0 <= length <= MAX_FRAME_BYTES:
        raise CorruptStateException(what, f"implausible frame length {length}")
    return length


def _read_framed(read_exact, what: str) -> Optional[dict]:
    """One frame through ``read_exact(n)`` (None on EOF before the first
    byte, short bytes on EOF inside): None on a clean EOF at a frame
    boundary, a typed CorruptStateException on a torn frame."""
    header = read_exact(FRAME_HEADER_BYTES)
    if header is None:
        return None
    if len(header) < FRAME_HEADER_BYTES:
        raise CorruptStateException(what, f"torn frame: EOF after {len(header)} header bytes")
    length = _check_header(header, what)
    body = read_exact(length) if length else b""
    if body is None or len(body) < length:
        got = 0 if body is None else len(body)
        raise CorruptStateException(
            what, f"torn frame: EOF after {got} of {length} payload bytes")
    return decode_frame(header + body, what)


def _read_exact(read, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes from ``read``; None on EOF at once, short bytes
    on EOF inside (the caller tells a torn frame from a clean end)."""
    chunks = []
    got = 0
    while got < n:
        chunk = read(n - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    if not chunks:
        return None
    return b"".join(chunks)


def read_frame(stream: io.RawIOBase, what: str = "transport frame") -> Optional[dict]:
    """One frame off a blocking byte stream: None on a clean EOF at a frame
    boundary; a typed CorruptStateException on a torn frame (EOF inside
    the header or the payload, a bad magic or length, a crc mismatch)."""
    return _read_framed(lambda n: _read_exact(stream.read, n), what)


# -- transports -------------------------------------------------------------------


class TransportClosedError(ConnectionError):
    """The peer end is gone (closed, or its process died). A
    ConnectionError on purpose: a receiver treats it as a lost worker, not
    as corrupt state."""


class Transport:
    """One end of a two-way frame channel. ``send`` is thread-safe (a
    worker's service thread resolves results while its protocol thread
    acknowledges submissions); ``recv`` has one consumer."""

    def send(self, msg: dict) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """The next message, or None when ``timeout`` passes with nothing
        to read. Raises TransportClosedError once the peer is gone and
        everything received was read."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class SocketTransport(Transport):
    """Frames over a connected stream socket (a ``socketpair`` whose other
    end a worker process inherited). A killed peer surfaces as EOF or
    ECONNRESET, raised as TransportClosedError."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sock.setblocking(True)
        self._send_lock = threading.Lock()
        self._closed = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def send(self, msg: dict) -> None:
        frame = encode_frame(msg)
        with self._send_lock:
            if self._closed:
                raise TransportClosedError("transport is closed")
            try:
                self._sock.sendall(frame)
            except OSError as e:
                raise TransportClosedError(f"peer gone during send: {e}") from e

    def _recv(self, n: int) -> bytes:
        try:
            return self._sock.recv(n)
        except OSError as e:
            raise TransportClosedError(f"peer gone: {e}") from e

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        if self._closed:
            raise TransportClosedError("transport is closed")
        # the timeout gates a frame's arrival only: once its first byte is
        # in, the read blocks to the frame's end, so a poll never tears one
        if timeout is not None:
            try:
                ready, _, _ = select.select([self._sock], [], [], timeout)
            except OSError as e:
                raise TransportClosedError(f"peer gone: {e}") from e
            if not ready:
                return None
        msg = _read_framed(lambda n: _read_exact(self._recv, n), "socket frame")
        if msg is None:
            raise TransportClosedError("peer closed the channel")
        return msg

    def close(self) -> None:
        with self._send_lock:
            self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class LoopbackTransport(Transport):
    """An in-process frame channel: a pair of queues carrying encoded
    frames (encoding and decoding run for real, so a table that cannot
    pickle fails here as on a socket)."""

    def __init__(self, inbox: "queue.Queue", outbox: "queue.Queue"):
        self._inbox = inbox
        self._outbox = outbox
        self._closed = threading.Event()
        self._peer_closed = threading.Event()
        self._peer: Optional["LoopbackTransport"] = None

    @staticmethod
    def pair() -> "tuple[LoopbackTransport, LoopbackTransport]":
        a_to_b: "queue.Queue" = queue.Queue()
        b_to_a: "queue.Queue" = queue.Queue()
        a = LoopbackTransport(inbox=b_to_a, outbox=a_to_b)
        b = LoopbackTransport(inbox=a_to_b, outbox=b_to_a)
        a._peer, b._peer = b, a
        return a, b

    def send(self, msg: dict) -> None:
        if self._closed.is_set() or self._peer_closed.is_set():
            raise TransportClosedError("loopback peer is closed")
        self._outbox.put(encode_frame(msg))

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        if self._closed.is_set():
            raise TransportClosedError("transport is closed")
        try:
            frame = self._inbox.get(timeout=timeout)
        except queue.Empty:
            if self._peer_closed.is_set():
                raise TransportClosedError("peer closed the channel") from None
            return None
        if frame is None:  # the peer's close sentinel
            self._peer_closed.set()
            raise TransportClosedError("peer closed the channel")
        return decode_frame(frame, "loopback frame")

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        if self._peer is not None:
            self._peer._peer_closed.set()
        self._outbox.put(None)
