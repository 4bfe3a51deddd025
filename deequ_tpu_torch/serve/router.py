"""Consistent-hash tenant placement — plan-cache locality that survives a
worker's join or leave (the counterpart of ``deequ_tpu/serve/router.py``).

A fleet is fast when a tenant keeps landing on the worker that already
holds its plan (``serve/plan_cache.py``): a repeat suite there builds
nothing. A modulo router would move every tenant whenever the membership
changes, and every worker would build plans again at the worst moment (a
worker just died). Consistent hashing bounds the move: each worker owns
``VNODES`` pseudo-random arcs of a ring, a key maps to the first vnode
clockwise, and removing a worker moves only the keys that worker owned.

The routing key (:func:`route_digest`) is the admission-free part of the
plan fingerprint — (schema, analyzer set, row count) — computed before any
op is built, so placement costs one SHA1 over a repr. It is coarser than
:class:`~deequ_tpu_torch.serve.plan_cache.PlanKey` (no layout: the layout
depends on the data); two suites that share a digest but split into two
plan keys land on one worker, where each warms its own entry.

Hashes are ``hashlib`` digests, not Python's ``hash()``: placement must be
the same across processes and runs (``PYTHONHASHSEED`` randomises
``hash()``), and the same as the reference's for the same submission —
analyzers and dtypes render alike in both packages.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Any, List, Optional, Sequence, Tuple

#: ring arcs a worker: enough that 4-16 workers split keys within a few
#: percent of even, few enough that membership changes stay cheap
VNODES = 64


def _hash64(text: str) -> int:
    return int.from_bytes(hashlib.sha1(text.encode()).digest()[:8], "little")


def route_digest(data, analyzers: Sequence) -> str:
    """The fleet's routing key of one submission: a digest of (column
    schema, analyzer set, row count). Analyzers contribute their ``str``
    (parameters included); a source without a row count contributes 0 and
    still routes consistently (it serves on the serial route)."""
    try:
        schema = tuple(sorted((name, str(data[name].dtype)) for name in data.column_names))
    except (AttributeError, TypeError):
        schema = ()
    try:
        rows = int(data.num_rows or 0)
    except (AttributeError, TypeError):
        rows = 0
    payload = repr((schema, tuple(str(a) for a in analyzers), rows))
    return hashlib.sha1(payload.encode()).hexdigest()


class ConsistentHashRouter:
    """The fleet's placement function (module doc), under a lock: the
    membership monitor changes the ring while callers submit."""

    def __init__(self, vnodes: int = VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self._points: List[int] = []  # sorted vnode positions
        self._owner: dict = {}  # position -> worker id

    def add_worker(self, worker_id: Any) -> None:
        with self._lock:
            for v in range(self.vnodes):
                pos = _hash64(f"{worker_id}#{v}")
                # a collision keeps the earlier owner: deterministic, and the
                # later worker still owns its other vnodes
                if pos in self._owner:
                    continue
                self._owner[pos] = worker_id
                bisect.insort(self._points, pos)

    def remove_worker(self, worker_id: Any) -> None:
        with self._lock:
            dead = [p for p, w in self._owner.items() if w == worker_id]
            for pos in dead:
                del self._owner[pos]
            if dead:
                gone = set(dead)
                self._points = [p for p in self._points if p not in gone]

    def workers(self) -> Tuple[Any, ...]:
        with self._lock:
            return tuple(sorted(set(self._owner.values()), key=repr))

    def place(self, digest: str) -> Optional[Any]:
        """The worker owning ``digest``'s ring position (the first vnode
        clockwise, wrapping); None when the ring is empty."""
        point = _hash64(digest)
        with self._lock:
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, point)
            if i == len(self._points):
                i = 0
            return self._owner[self._points[i]]

    def walk(self, digest: str) -> List[Any]:
        """Every distinct worker in clockwise ring order from ``digest``'s
        position (``walk(d)[0] == place(d)``): the fleet's overload spill
        order. When the placed worker refuses admission typed, the next
        clockwise is the worker a failed-over key would move to anyway, so
        a spilled repeat tenant lands where its plans would migrate. Empty
        when the ring is."""
        point = _hash64(digest)
        with self._lock:
            if not self._points:
                return []
            i = bisect.bisect_right(self._points, point)
            out: List[Any] = []
            seen = set()
            for k in range(len(self._points)):
                owner = self._owner[self._points[(i + k) % len(self._points)]]
                if owner not in seen:
                    seen.add(owner)
                    out.append(owner)
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(set(self._owner.values()))
