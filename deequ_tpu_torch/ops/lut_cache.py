"""Per-dictionary lookup-table memo — the port's counterpart of
``deequ_tpu/ops/lut_cache.py``.

String columns are dictionary-encoded; device string work gathers a host
LUT over the dictionary (hashes, regex hits, lengths, type classes) by
code. Building one is O(cardinality) host work (3.3 M xxHash64s for a
10^7-row column of n/3 distinct strings), so each LUT is built once per
dictionary and kind and kept:

- :func:`dictionary_lut` keeps the host array, keyed on the dictionary's
  identity (guarded by a weakref, so a recycled id cannot alias) and a
  kind string naming the derivation;
- :func:`dictionary_lut_device` keeps the array on a device, keyed also by
  the device, so a second ``run()`` over the same table builds nothing and
  copies nothing. An empty dictionary's LUT gets one zero entry: null rows
  gather index 0 and are masked out. The device in the key is the
  reference's mesh value key: a scan over a mesh places each LUT on every
  member's device, one copy a distinct device (a virtual mesh's members
  share theirs).

``BUILDS`` counts the LUTs built and kept (``chip_smoke.py`` reads it
around a second run). The memos and the count are shared by threads (a
fleet's workers): a lookup and a store take the lock, a build runs outside
it, and when two threads built one key at once the first stored is kept
and counted, the other discarded.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from deequ_tpu_torch.ops import counters

_MAX_ENTRIES = 64
# (id(dictionary), kind) -> (weakref to dictionary, lut); insertion order
# doubles as LRU recency
_MEMO: Dict[Tuple[int, str], Tuple[weakref.ref, np.ndarray]] = {}
# the same keying plus the device, for device tensors
_DEVICE_MEMO: Dict[Tuple[int, str, str], Tuple[weakref.ref, torch.Tensor]] = {}

#: LUTs built and kept since the last reset
BUILDS = 0
_LOCK = threading.Lock()


def _lookup(memo: dict, key, dictionary):
    entry = memo.pop(key, None)
    if entry is not None and entry[0]() is dictionary:
        memo[key] = entry  # re-insert: most recently used
        return entry[1]
    return None


def _store(memo: dict, key, dictionary, value):
    """Keep ``value`` unless a thread stored the key meanwhile; returns
    the value kept. Caller holds ``_LOCK``."""
    held = _lookup(memo, key, dictionary)
    if held is not None:
        return held
    if memo is _MEMO:
        counters.inc(globals(), "BUILDS")
    try:
        ref = weakref.ref(dictionary)
    except TypeError:  # plain lists: no identity guard possible, no memo
        return value
    memo[key] = (ref, value)
    while len(memo) > _MAX_ENTRIES:
        memo.pop(next(iter(memo)))
    return value


def dictionary_lut(
    dictionary, kind: str, builder: Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    """``builder(dictionary)``, memoized per (dictionary identity, kind)."""
    key = (id(dictionary), kind)
    with _LOCK:
        lut = _lookup(_MEMO, key, dictionary)
    if lut is None:
        lut = np.asarray(builder(dictionary))
        with _LOCK:
            lut = _store(_MEMO, key, dictionary, lut)
    return lut


def dictionary_lut_device(
    dictionary, kind: str, builder: Callable[[np.ndarray], np.ndarray], device
) -> torch.Tensor:
    """The LUT as a tensor on ``device``, memoized per (dictionary
    identity, kind, device): built and copied once."""
    device = torch.device(device)
    key = (id(dictionary), kind, str(device))
    with _LOCK:
        lut = _lookup(_DEVICE_MEMO, key, dictionary)
    if lut is None:
        host = np.ascontiguousarray(dictionary_lut(dictionary, kind, builder))
        if host.shape[-1] == 0:
            host = np.zeros(host.shape[:-1] + (1,), dtype=host.dtype)
        lut = torch.from_numpy(host).to(device)
        with _LOCK:
            lut = _store(_DEVICE_MEMO, key, dictionary, lut)
    return lut

