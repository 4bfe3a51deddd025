"""Native host kernels (C++, ctypes-bound) — the port's copy of
``deequ_tpu/native``.

The device path is PyTorch; this module runs the host-side loops that feed
it over a string dictionary, once per distinct value: xxHash64 (the HLL
string LUT), DataType classification and lengths in code points
(Min/MaxLength). ``kernels.cpp`` is compiled with ``g++`` at first use into
``build/deequ_tpu_torch/libnative_<hash>.so`` (the hash is the source's,
so an edited source builds anew, as ``ops/cuda_build.py`` keys the CUDA
kernels) and loaded with ``ctypes``. A failed build raises: there is no
quiet Python fallback. The pure-Python versions stay beside the callers
(``ops/hll.py:hash_strings_plain``, ``analyzers/scan.py:_classify_string``,
``len``) as what the tests hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from deequ_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "kernels.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused ``kernels.cpp``."""


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_{digest}.so"


def build() -> Path:
    """Compile ``kernels.cpp`` unless the library for this source's hash
    exists; returns its path. Raises :class:`NativeBuildError`."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ could not run on {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(
            f"g++ failed ({proc.returncode}) building {SOURCE.name}:\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.xxhash64_batch.argtypes = [
                u8p, i64p, ctypes.c_int64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.xxhash64_batch.restype = None
            lib.classify_batch.argtypes = [
                u8p, i64p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.classify_batch.restype = None
            lib.utf8_lengths.argtypes = [u8p, i64p, ctypes.c_int64, i64p]
            lib.utf8_lengths.restype = None
            _LIB = lib
        return _LIB


def pack(values: Sequence) -> tuple:
    """Strings (``str(v)`` of each value) as one contiguous utf-8 buffer
    and int64 offsets[n + 1]. The batch is joined with NUL separators and
    encoded in one call; the separators (the only 0 bytes utf-8 makes)
    give the offsets and are then dropped. A batch whose values hold a NUL
    themselves is encoded value by value."""
    items = values.tolist() if isinstance(values, np.ndarray) else list(values)
    n = len(items)
    offsets = np.zeros(n + 1, dtype=np.int64)
    try:
        joined = "\x00".join(items)
    except TypeError:  # not every value is a str
        items = [str(v) for v in items]
        joined = "\x00".join(items)
    data = (joined + "\x00").encode("utf-8")
    seps = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 0)
    if len(seps) == n:
        offsets[1:] = seps - np.arange(n)
        buffer = np.frombuffer(data.replace(b"\x00", b""), dtype=np.uint8)
    else:
        encoded = [s.encode("utf-8") for s in items]
        np.cumsum(np.fromiter(map(len, encoded), np.int64, n), out=offsets[1:])
        buffer = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    if len(buffer) == 0:
        buffer = np.zeros(1, dtype=np.uint8)
    return buffer, offsets


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hash_strings(values: Sequence, seed: int) -> np.ndarray:
    """xxHash64 of each value's utf-8 bytes (uint64)."""
    lib = _library()
    buffer, offsets = pack(values)
    out = np.empty(len(offsets) - 1, dtype=np.uint64)
    lib.xxhash64_batch(
        _ptr(buffer, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        len(out), ctypes.c_uint64(seed), _ptr(out, ctypes.c_uint64),
    )
    return out


def classify_strings(values: Sequence) -> np.ndarray:
    """DataType class of each value (int32: 1 fractional, 2 integral,
    3 boolean, 4 string)."""
    lib = _library()
    buffer, offsets = pack(values)
    out = np.empty(len(offsets) - 1, dtype=np.int32)
    lib.classify_batch(
        _ptr(buffer, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        len(out), _ptr(out, ctypes.c_int32),
    )
    return out


def utf8_lengths(values: Sequence) -> np.ndarray:
    """Length of each value in code points (int64), as Python's ``len``."""
    lib = _library()
    buffer, offsets = pack(values)
    out = np.empty(len(offsets) - 1, dtype=np.int64)
    lib.utf8_lengths(
        _ptr(buffer, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        len(out), _ptr(out, ctypes.c_int64),
    )
    return out
