"""HyperLogLog register file — the port's counterpart of
``deequ_tpu/ops/hll.py``.

Two halves:

- the host half, copied from the reference: the string hash (xxHash64
  over utf-8 bytes, once per distinct dictionary value, in the native C++
  batch of ``deequ_tpu_torch/native``, with the pure-Python version beside
  it as its plain version), the v1 (idx, rank) derivation from a 64-bit
  hash, the packed i32 (idx, rank) LUT of a string dictionary, and Ertl's
  estimator;
- the device half: per row, the canonical split of the f64 value into an
  f32 pair (hi, lo), two murmur ``fmix32`` rounds over the pair's u32 bits
  giving (idx, rank), and the register max. On a CUDA tensor
  :func:`registers` launches the hand-written kernel of
  ``deequ_tpu_torch/csrc/hll.cu`` (one pass: hash and fold), or raises; on
  a CPU tensor it runs :func:`registers_plain`, the kernel's plain PyTorch
  version, which is also what tests and ``chip_smoke.py`` hold the kernel
  against.

The canonical split is numpy's (the reference's packer,
``df32.split_pair_np``): -0.0 folds into +0.0; ``hi = f32(x)`` rounded to
nearest with f32 subnormals kept and magnitudes past the f32 range going
to inf; ``lo = f32(x - hi)``; a NaN narrows with its sign and the top 23
bits of its payload kept and the quiet bit set; ``lo`` of any non-finite
``hi`` is the bits of ``np.float32(np.nan)``. The plain version takes the
NaN bits from the f64 bits and not from the device's conversion, as the
kernel does, so the two agree on every card. torch has no ``uint32``
shifts on the CPU, so the plain version does its u32 arithmetic in int64
masked to 32 bits.

Default precision mirrors the reference's RELATIVE_SD = 0.05: p = 9,
m = 512 registers, ranks in [1, 56].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from deequ_tpu_torch import native
from deequ_tpu_torch.exceptions import launch_error
from deequ_tpu_torch.ops import counters, cuda_build

DEFAULT_RELATIVE_SD = 0.05
XXHASH_SEED = 42

#: the hash suite of numeric and boolean registers (u32 fmix32 over the
#: f32 pair); string registers keep suite 1 (host xxHash64, v1 derivation)
HASH_VERSION = 2
STRING_HASH_VERSION = 1

_PRIME64_1 = 0x9E3779B185EBCA87
_PRIME64_2 = 0xC2B2AE3D27D4EB4F
_PRIME64_3 = 0x165667B19E3779F9
_PRIME64_4 = 0x85EBCA77C2B2AE63
_PRIME64_5 = 0x27D4EB2F165667C5
_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_NAN32 = 0x7FC00000  # the bits of np.float32(np.nan)

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around the main path)
LAUNCHES = 0

#: the kernel's input modes, in the source's numbering
_MODES = {"f64": 0, "bool": 1, "lut": 2}
_MAX_P = 12  # the kernel's shared-memory register file holds 2^p i32


def precision_from_relative_sd(relative_sd: float = DEFAULT_RELATIVE_SD) -> int:
    """p such that 1.04/sqrt(2^p) <= relative_sd (reference derivation)."""
    return max(4, math.ceil(2.0 * math.log(1.106 / relative_sd) / math.log(2.0)))


# -- host half: strings and the estimator (copied from the reference) -------


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def xxhash64_bytes(data: bytes, seed: int = XXHASH_SEED) -> int:
    """Pure-python xxHash64 (public algorithm) for host-side string hashing."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _PRIME64_1 + _PRIME64_2) & _MASK64
        v2 = (seed + _PRIME64_2) & _MASK64
        v3 = seed & _MASK64
        v4 = (seed - _PRIME64_1) & _MASK64
        while i <= n - 32:
            for vi, off in ((0, 0), (1, 8), (2, 16), (3, 24)):
                lane = int.from_bytes(data[i + off:i + off + 8], "little")
                v = (v1, v2, v3, v4)[vi]
                v = (v + lane * _PRIME64_2) & _MASK64
                v = (_rotl(v, 31) * _PRIME64_1) & _MASK64
                if vi == 0:
                    v1 = v
                elif vi == 1:
                    v2 = v
                elif vi == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _MASK64
        for v in (v1, v2, v3, v4):
            v = (v * _PRIME64_2) & _MASK64
            v = (_rotl(v, 31) * _PRIME64_1) & _MASK64
            h ^= v
            h = (h * _PRIME64_1 + _PRIME64_4) & _MASK64
    else:
        h = (seed + _PRIME64_5) & _MASK64
    h = (h + n) & _MASK64
    while i <= n - 8:
        lane = int.from_bytes(data[i:i + 8], "little")
        k = (_rotl((lane * _PRIME64_2) & _MASK64, 31) * _PRIME64_1) & _MASK64
        h ^= k
        h = (_rotl(h, 27) * _PRIME64_1 + _PRIME64_4) & _MASK64
        i += 8
    if i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h ^= (lane * _PRIME64_1) & _MASK64
        h = (_rotl(h, 23) * _PRIME64_2 + _PRIME64_3) & _MASK64
        i += 4
    while i < n:
        h ^= (data[i] * _PRIME64_5) & _MASK64
        h = (_rotl(h, 11) * _PRIME64_1) & _MASK64
        i += 1
    h ^= h >> 33
    h = (h * _PRIME64_2) & _MASK64
    h ^= h >> 29
    h = (h * _PRIME64_3) & _MASK64
    h ^= h >> 32
    return h


def hash_strings(values, seed: int = XXHASH_SEED) -> np.ndarray:
    """xxhash64 per distinct string (host, O(cardinality)), in the native
    batch of ``deequ_tpu_torch/native`` (C++)."""
    return native.hash_strings(values, seed)


def hash_strings_plain(values, seed: int = XXHASH_SEED) -> np.ndarray:
    """:func:`hash_strings` in pure Python: what the native batch is held
    against."""
    return np.array(
        [xxhash64_bytes(str(v).encode("utf-8"), seed) for v in values],
        dtype=np.uint64,
    )


def _clz64_np(x: np.ndarray) -> np.ndarray:
    """Branchless count-leading-zeros for uint64 arrays."""
    n = np.full(x.shape, 64, dtype=np.int32)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> np.uint64(s)
        hit = y != 0
        x = np.where(hit, y, x)
        n = n - np.where(hit, np.int32(s), np.int32(0))
    return n - (x != 0).astype(np.int32)


def idx_rank_from_hash64(hashes: np.ndarray, p: int):
    """(idx, rank) from 64-bit hashes — the v1 derivation, used for string
    columns, whose LUT is computed on the host."""
    idx = (hashes >> np.uint64(64 - p)).astype(np.int32)
    rest = hashes << np.uint64(p)
    rank = (_clz64_np(rest) + 1).astype(np.int32)
    return idx, np.minimum(rank, 64 - p + 1)


def pack_idx_rank(idx, rank):
    """Host LUT packing: one i32 per distinct value (rank <= 57 fits in
    6 bits). The device unpacks with i32 shifts and masks."""
    return (idx.astype(np.int32) << np.int32(6)) | rank.astype(np.int32)


def string_idx_rank_lut(values, p: int, seed: int = XXHASH_SEED) -> np.ndarray:
    """Packed (idx, rank) LUT for a string dictionary: xxhash64 per
    distinct value on the host, v1 idx/rank derivation, i32 out."""
    hashes = hash_strings(values, seed)
    idx, rank = idx_rank_from_hash64(hashes, p)
    packed = pack_idx_rank(idx, rank)
    return packed if len(packed) else np.zeros(1, dtype=np.int32)


def _sigma(x: float) -> float:
    """Ertl's sigma: sum for the zero-register (small-range) correction."""
    if x == 1.0:
        return float("inf")
    y = 1.0
    z = x
    while True:
        x = x * x
        z_prev = z
        z = z + x * y
        y = y + y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    """Ertl's tau: sum for the saturated-register (large-range) correction."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    z = 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y = 0.5 * y
        z = z - (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def estimate_cardinality(registers: np.ndarray) -> float:
    """Cardinality from an HLL register file via Ertl's improved estimator
    ("New cardinality estimation algorithms for HyperLogLog sketches",
    2017): one closed-form estimate from the register-value histogram with
    sigma/tau corrections for the zero- and saturated-register tails,
    rounded like the reference (Java Math.round: floor(x + 0.5))."""
    registers = np.asarray(registers)
    m = len(registers)
    p = int(round(math.log2(m)))
    q = 64 - p  # ranks are capped at q + 1
    counts = np.bincount(
        registers.astype(np.int64), minlength=q + 2
    ).astype(np.float64)
    alpha_inf = 1.0 / (2.0 * math.log(2.0))
    # sum_{k=1..q} C[k] * 2^{-k}, accumulated small-to-large for accuracy
    z = m * _tau(1.0 - counts[q + 1] / m)
    for k in range(q, 0, -1):
        z = 0.5 * (z + counts[k])
    z = z + m * _sigma(counts[0] / m)
    return float(math.floor(alpha_inf * m * m / z + 0.5))


# -- device half: the plain version (int64 holding u32) ----------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in two 16-bit halves of c so no
    int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit avalanche finalizer (public constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count-leading-zeros of u32 values held in int64 (32 for 0)."""
    n = torch.full_like(x, 32)
    for s in (16, 8, 4, 2, 1):
        y = x >> s
        hit = y != 0
        x = torch.where(hit, y, x)
        n = n - torch.where(hit, s, 0)
    return n - (x != 0).to(torch.int64)


def idx_rank_u32(hi_bits: torch.Tensor, lo_bits: torch.Tensor, p: int,
                 seed: int = XXHASH_SEED):
    """(idx, rank) from two u32 lanes (int64 tensors): a = fmix32(fmix32(hi ^
    seed) ^ lo) gives idx (top p bits) and the first 32-p rank bits; b mixes
    the lanes the other way with another seed and extends the rank to
    64-p bits, so rank lies in [1, 64-p+1] (reference ``idx_rank_u32``)."""
    s = seed & _M32
    a = fmix32(fmix32(hi_bits ^ s) ^ lo_bits)
    b = fmix32(fmix32(lo_bits ^ s ^ 0x9E3779B9) ^ hi_bits)
    idx = a >> (32 - p)
    w1 = (a << p) & _M32
    rank = torch.where(w1 != 0, clz32(w1) + 1, (32 - p) + clz32(b) + 1)
    return idx, torch.clamp(rank, max=64 - p + 1)


def split_bits(x: torch.Tensor):
    """The u32 bits (int64 tensors) of the canonical (hi, lo) f32 split of
    f64 values (module doc)."""
    bits = x.view(torch.int64)
    c = torch.where(x == 0, 0.0, x)  # fold -0.0 into +0.0
    hi = c.to(torch.float32)
    hi_bits = hi.view(torch.int32).to(torch.int64) & _M32
    diff = c - hi.to(torch.float64)
    lo = torch.where(torch.isfinite(diff), diff, 0.0).to(torch.float32)
    lo_bits = torch.where(
        torch.isfinite(hi), lo.view(torch.int32).to(torch.int64) & _M32, _NAN32
    )
    # a NaN narrows as numpy narrows it: sign, quiet bit, top payload bits
    nan_bits = (((bits >> 63) & 1) << 31) | _NAN32 | ((bits >> 29) & 0x7FFFFF)
    return torch.where(torch.isnan(x), nan_bits, hi_bits), lo_bits


def idx_rank(x: torch.Tensor, p: int, lut: Optional[torch.Tensor] = None):
    """(idx, rank, ok) per row in the mode :func:`registers` infers from
    ``x`` (its doc); ``ok`` is False where the mode itself drops the row
    (a null or out-of-range string code), else None."""
    if x.dtype == torch.float64:
        return (*idx_rank_u32(*split_bits(x), p), None)
    if x.dtype in (torch.bool, torch.uint8):
        bits = (x != 0).to(torch.int64)
        return (*idx_rank_u32(bits, torch.zeros_like(bits), p), None)
    ok = (x >= 0) & (x < lut.numel())
    packed = lut[torch.clamp(x, 0, lut.numel() - 1).to(torch.int64)].to(torch.int64)
    return packed >> 6, packed & 0x3F, ok


def registers_from_idx_rank(idx, rank, valid, p: int) -> torch.Tensor:
    """Fold (idx, rank) rows into the 2^p registers: register[i] is the
    largest rank of a valid row at idx i, 0 where none is (a scatter-max)."""
    if valid is not None:
        rank = torch.where(valid, rank, 0)
        idx = torch.where(valid, idx, 0)
    regs = torch.zeros(1 << p, dtype=torch.int64, device=idx.device)
    regs.scatter_reduce_(0, idx, rank, "amax")
    return regs.to(torch.int32)


def _check_args(x, valid, p, lut) -> str:
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError("hll: values must be a 1-D tensor")
    if x.dtype == torch.float64:
        mode = "f64"
    elif x.dtype in (torch.bool, torch.uint8):
        mode = "bool"
    elif x.dtype == torch.int32:
        mode = "lut"
        if not isinstance(lut, torch.Tensor) or lut.dim() != 1 or lut.dtype != torch.int32:
            raise ValueError("hll: int32 string codes need an int32 1-D lut")
        if lut.numel() == 0 or lut.device != x.device:
            raise ValueError("hll: the lut must be non-empty and on the codes' device")
    else:
        raise TypeError(f"hll: values must be float64, bool or int32 codes, got {x.dtype}")
    if mode != "lut" and lut is not None:
        raise ValueError("hll: a lut goes with int32 string codes only")
    if valid is not None and (
        not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool
        or valid.shape != x.shape or valid.device != x.device
    ):
        raise ValueError("hll: valid must be a bool tensor shaped like values, on its device")
    if not 4 <= int(p) <= _MAX_P:
        raise ValueError(f"hll: precision p must lie in [4, {_MAX_P}], got {p}")
    return mode


def registers_plain(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                    p: int = 9, lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version (:func:`registers`' contract)."""
    _check_args(x, valid, p, lut)
    idx, rank, ok = idx_rank(x, p, lut)
    if ok is not None:
        valid = ok if valid is None else valid & ok
    return registers_from_idx_rank(idx, rank, valid, p)


def registers(x: torch.Tensor, valid: Optional[torch.Tensor] = None,
              p: int = 9, lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 2^p int32 HLL registers of the rows of ``x`` where ``valid``
    (None: every row). ``x`` is one of:

    - float64 values (hashed through their canonical f32 split, suite 2);
    - bool values (hashed as the u32 bits 0/1 with lo = 0, suite 2);
    - int32 string codes with ``lut``, the packed (idx, rank) table of the
      dictionary (``string_idx_rank_lut``; suite 1): idx = packed >> 6,
      rank = packed & 0x3F; a code < 0 (null) or past the table is dropped.

    A CUDA tensor runs the CUDA kernel; a CPU tensor runs the plain version."""
    _check_args(x, valid, p, lut)
    if x.device.type == "cpu":
        return registers_plain(x, valid, p, lut)
    if x.device.type != "cuda":
        raise ValueError(f"hll: unsupported device {x.device}")
    if not x.is_contiguous() or (valid is not None and not valid.is_contiguous()) or (
        lut is not None and not lut.is_contiguous()
    ):
        raise ValueError("hll: values, valid and lut must be contiguous")
    out = torch.zeros(1 << int(p), dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    _launch(x, valid, int(p), lut, out)
    counters.inc(globals(), "LAUNCHES")
    return out


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_hll_registers.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.deequ_hll_registers.restype = ctypes.c_int


def _launch(x, valid, p: int, lut, out) -> None:
    """Enqueue the kernel on the current stream, max-folding into ``out``
    (2^p int32, zeroed by the caller), with no allocation: :func:`registers`
    calls it once; ``chip_smoke.py`` times it alone. Raises if the launch
    was refused."""
    mode = _check_args(x, valid, p, lut)
    lib = cuda_build.library("hll", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.deequ_hll_registers(
            _MODES[mode], x.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if lut is None else lut.data_ptr(),
            0 if lut is None else lut.numel(),
            x.numel(), p, out.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"hll kernel launch failed (n={x.numel()}, mode={mode}, p={p})", rc
        )
