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
  gather index 0 and are masked out.

``BUILDS`` counts builder calls (``chip_smoke.py`` reads it around a
second run).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_MAX_ENTRIES = 64
# (id(dictionary), kind) -> (weakref to dictionary, lut); insertion order
# doubles as LRU recency
_MEMO: Dict[Tuple[int, str], Tuple[weakref.ref, np.ndarray]] = {}
# the same keying plus the device, for device tensors
_DEVICE_MEMO: Dict[Tuple[int, str, str], Tuple[weakref.ref, torch.Tensor]] = {}

#: builder calls since the last reset
BUILDS = 0


def _lookup(memo: dict, key, dictionary):
    entry = memo.pop(key, None)
    if entry is not None and entry[0]() is dictionary:
        memo[key] = entry  # re-insert: most recently used
        return entry[1]
    return None


def _store(memo: dict, key, dictionary, value) -> None:
    try:
        ref = weakref.ref(dictionary)
    except TypeError:  # plain lists: no identity guard possible, no memo
        return
    memo[key] = (ref, value)
    while len(memo) > _MAX_ENTRIES:
        memo.pop(next(iter(memo)))


def dictionary_lut(
    dictionary, kind: str, builder: Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    """``builder(dictionary)``, memoized per (dictionary identity, kind)."""
    global BUILDS
    key = (id(dictionary), kind)
    lut = _lookup(_MEMO, key, dictionary)
    if lut is None:
        BUILDS += 1
        lut = np.asarray(builder(dictionary))
        _store(_MEMO, key, dictionary, lut)
    return lut


def dictionary_lut_device(
    dictionary, kind: str, builder: Callable[[np.ndarray], np.ndarray], device
) -> torch.Tensor:
    """The LUT as a tensor on ``device``, memoized per (dictionary
    identity, kind, device): built and copied once."""
    device = torch.device(device)
    key = (id(dictionary), kind, str(device))
    lut = _lookup(_DEVICE_MEMO, key, dictionary)
    if lut is None:
        host = np.ascontiguousarray(dictionary_lut(dictionary, kind, builder))
        if host.shape[-1] == 0:
            host = np.zeros(host.shape[:-1] + (1,), dtype=host.dtype)
        lut = torch.from_numpy(host).to(device)
        _store(_DEVICE_MEMO, key, dictionary, lut)
    return lut
