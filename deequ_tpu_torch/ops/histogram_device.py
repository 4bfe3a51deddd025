"""Histogram of segment ids — the port's counterpart of
``deequ_tpu/ops/histogram_device.py``.

The reference routes histograms through a tier of variants (scatter,
one-hot MXU matmul, and ``bincount_pallas``, its one Pallas kernel). The
port has one formulation per device:

- on a CUDA tensor, :func:`bincount` launches the hand-written kernel of
  ``deequ_tpu_torch/csrc/bincount.cu`` in the regime its width calls for
  (:func:`regime`: a shared-memory histogram a block while one fits a
  block's shared memory, a partition by bucket then a shared-memory
  histogram a bucket up to 2^25 bins, L2 atomics past that; the source
  says why), or raises;
- on a CPU tensor it runs :func:`bincount_plain`, the kernel's plain
  PyTorch version, which is also what tests and ``chip_smoke.py`` hold
  the kernel against.

:func:`fused_bincount` is the counterpart of the reference's cross-set
grouping fusion (``deequ_tpu/ops/segment.py:1035`` ``fused_group_counts``,
K7): K int64 key vectors counted by one call of the kernel's multi-input
entry over their summed keyspace, each set's ids shifted by the keyspaces
before it where the kernel loads them, so the host neither offsets nor
concatenates. Past a block's shared histogram the entry makes two
launches: one grid reads every set once (the wide sets partitioned by
bucket, the narrow ones counted in shared memory beside them), then a
cluster of blocks a bucket adds the wide sets' counts. On a CPU tensor it
runs :func:`fused_bincount_plain`, the reference's formulation (offset,
concatenate, count).

Contract (the reference's, shared by every variant): counts over
``[0, num_segments)``; ids outside that range — negative sentinels,
padding — are dropped; optional int32 weights replace the 1; results are
exact integers. Weighted, each bin's total is taken mod 2^32 and read as
an int32, as the reference's int32 accumulation gives it: that is the
exact total whenever it lies in int32, whatever the partial sums on the
way, and kernel and plain version agree on every input.

The kernel is compiled from the source in the checkout at first use and
bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from deequ_tpu_torch.exceptions import DeviceException, launch_error
from deequ_tpu_torch.ops import cuda_build

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around the main path)
LAUNCHES = 0

#: launches of the multi-input entry (:func:`fused_bincount`), counted
#: apart from :data:`LAUNCHES`: one a call that launches on a card
FUSED_LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_bincount.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_bincount.restype = ctypes.c_int
    lib.deequ_bincount_regime.argtypes = [ctypes.c_longlong]
    lib.deequ_bincount_regime.restype = ctypes.c_int
    lib.deequ_bincount_widest.argtypes = [ctypes.c_int]
    lib.deequ_bincount_widest.restype = ctypes.c_longlong
    lib.deequ_bincount_scratch_bytes.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.deequ_bincount_scratch_bytes.restype = ctypes.c_longlong
    multi = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int]
    lib.deequ_bincount_multi_scratch_bytes.argtypes = multi
    lib.deequ_bincount_multi_scratch_bytes.restype = ctypes.c_longlong
    lib.deequ_bincount_multi.argtypes = multi + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_bincount_multi.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return cuda_build.library("bincount", _bind)


#: the kernel's regimes, narrowest first, in the source's numbering
REGIMES = ("shared", "partition", "global")


def regime(num_segments: int) -> str:
    """The regime the kernel takes at this width on the current card (the
    rule lives in ``bincount.cu``: the narrowest regime whose width covers
    it)."""
    code = _library().deequ_bincount_regime(int(num_segments))
    if code < 0:
        raise DeviceException(f"bincount: no CUDA device (CUDA error {-code})")
    return REGIMES[code]


def regime_widths() -> dict:
    """The widest width each regime takes on the current card (None: no
    limit); the rule gives a width the narrowest regime that covers it."""
    lib = _library()
    widths = {}
    for i, name in enumerate(REGIMES):
        widest = lib.deequ_bincount_widest(i)
        if widest == -2:
            raise DeviceException("bincount: no CUDA device")
        widths[name] = None if widest < 0 else int(widest)
    return widths


def _check_args(seg, num_segments, weights) -> None:
    if not isinstance(seg, torch.Tensor) or seg.dim() != 1:
        raise ValueError("bincount: seg must be a 1-D tensor")
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"bincount: seg must be int32 or int64, got {seg.dtype}")
    if int(num_segments) < 0:
        raise ValueError(f"bincount: num_segments must be >= 0, got {num_segments}")
    if weights is not None:
        if not isinstance(weights, torch.Tensor) or weights.shape != seg.shape:
            raise ValueError("bincount: weights must be a tensor shaped like seg")
        if weights.dtype != torch.int32:
            raise TypeError(f"bincount: weights must be int32, got {weights.dtype}")
        if weights.device != seg.device:
            raise ValueError("bincount: weights and seg lie on different devices")


def bincount_plain(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """The kernel's plain PyTorch version: out-of-range ids map to a
    trailing slot, one ``index_add_`` counts every slot, the trailing slot
    is cut off."""
    _check_args(seg, num_segments, weights)
    num_segments = int(num_segments)
    slots = torch.where(
        (seg >= 0) & (seg < num_segments), seg, num_segments
    ).to(torch.int64)
    add = (
        torch.ones_like(slots)
        if weights is None
        else weights.to(torch.int64)
    )
    counts = torch.zeros(num_segments + 1, dtype=torch.int64, device=seg.device)
    counts.index_add_(0, slots, add)
    counts = counts[:num_segments]
    if weights is not None:
        # the weighted domain (module doc): the total mod 2^32, as an int32
        counts = counts.to(torch.int32).to(torch.int64)
    return counts.to(dtype)


def bincount(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """Histogram of ``seg`` over ``[0, num_segments)`` (module doc). A CUDA
    tensor runs the CUDA kernel; a CPU tensor runs the plain version.
    Unweighted counts are exact; with int32 ``weights`` each bin holds its
    total mod 2^32 read as an int32 — the exact total wherever that lies in
    int32, as the reference accumulates."""
    global LAUNCHES
    _check_args(seg, num_segments, weights)
    if seg.device.type == "cpu":
        return bincount_plain(seg, num_segments, weights, dtype)
    if seg.device.type != "cuda":
        raise ValueError(f"bincount: unsupported device {seg.device}")
    if not seg.is_contiguous() or (
        weights is not None and not weights.is_contiguous()
    ):
        raise ValueError("bincount: seg and weights must be contiguous")
    num_segments = int(num_segments)
    if seg.numel() == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=dtype, device=seg.device)
    with torch.cuda.device(seg.device):
        name = regime(num_segments)
    bufs = _buffers(seg, num_segments, weights, name)
    _launch(seg, num_segments, weights, *bufs, regime_name=name)
    LAUNCHES += 1
    out = bufs[-1]
    return out if dtype == torch.int64 else out.to(dtype)


def _buffers(seg, num_segments: int, weights=None, regime_name=None) -> tuple:
    """What one launch writes, as the wrapper allocates it: the scratch the
    regime needs (bytes) and the zeroed int64 output."""
    lib = _library()
    with torch.cuda.device(seg.device):
        name = regime_name or regime(num_segments)
        nbytes = lib.deequ_bincount_scratch_bytes(
            REGIMES.index(name), seg.numel(), num_segments,
            0 if weights is None else 1,
        )
    if nbytes < 0:
        raise ValueError(
            f"bincount: the {name} regime cannot take {num_segments} segments"
        )
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=seg.device)
    out = torch.zeros(num_segments, dtype=torch.int64, device=seg.device)
    return scratch, out


def _launch(seg, num_segments: int, weights, scratch, out, regime_name=None) -> None:
    """Enqueue the kernel on the current stream into ``out`` with the
    buffers of :func:`_buffers`, with no checks and no allocation:
    :func:`bincount` calls it once in the regime of :func:`regime`;
    ``chip_smoke.py`` times it alone, and in each regime that can take the
    width. Raises if the launch was refused."""
    n = seg.numel()
    lib = _library()
    with torch.cuda.device(seg.device):
        name = regime_name or regime(num_segments)
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        rc = lib.deequ_bincount(
            REGIMES.index(name), seg.data_ptr(),
            1 if seg.dtype == torch.int64 else 0,
            None if weights is None else weights.data_ptr(),
            n, num_segments, scratch.data_ptr() if scratch.numel() else None,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"bincount kernel launch failed (n={n}, num_segments={num_segments}, "
            f"regime={name})", rc,
        )


# -- the multi-input entry: K7's fused group counts ---------------------------


def _check_fused_args(keys, keyspaces) -> None:
    if len(keys) == 0 or len(keys) != len(keyspaces):
        raise ValueError(
            "fused_bincount: one keyspace for each of at least one key tensor"
        )
    device = keys[0].device if isinstance(keys[0], torch.Tensor) else None
    for key in keys:
        if not isinstance(key, torch.Tensor) or key.dim() != 1:
            raise ValueError("fused_bincount: every key vector must be a 1-D tensor")
        if key.dtype != torch.int64:
            raise TypeError(f"fused_bincount: keys must be int64, got {key.dtype}")
        if key.device != device:
            raise ValueError("fused_bincount: the key vectors lie on different devices")
    if any(int(k) < 0 for k in keyspaces):
        raise ValueError(f"fused_bincount: keyspaces must be >= 0, got {keyspaces}")


def fused_bincount_plain(keys, keyspaces) -> torch.Tensor:
    """:func:`fused_bincount`'s plain version, the reference's formulation:
    each set's ids >= 0 shifted by its offset (the rest -1), the vectors
    concatenated, one :func:`bincount_plain` over the summed keyspace."""
    keys = list(keys)
    _check_fused_args(keys, keyspaces)
    shifted, offset = [], 0
    for key, k in zip(keys, keyspaces):
        shifted.append(torch.where(key >= 0, key + offset, -1))
        offset += int(k)
    return bincount_plain(torch.cat(shifted), offset)


def fused_bincount(keys, keyspaces) -> torch.Tensor:
    """Counts of K int64 key vectors over ``sum(keyspaces)`` bins, set j's
    ids in ``[0, keyspaces[j])`` landing after the keyspaces before it,
    ids < 0 dropped (module doc). On CUDA tensors one call of the kernel's
    multi-input entry (shared or partition regime: the summed keyspace must
    be at most the partition regime's width, 2^25; in the partition regime
    a set of at most 16,384 bins of its own is counted in shared memory,
    into its own bins, while the wider ones are partitioned, in the same
    grid), counted once in :data:`FUSED_LAUNCHES`; on CPU tensors
    :func:`fused_bincount_plain`. Exact int64 counts."""
    global FUSED_LAUNCHES
    keys = list(keys)
    _check_fused_args(keys, keyspaces)
    device = keys[0].device
    if device.type == "cpu":
        return fused_bincount_plain(keys, keyspaces)
    if device.type != "cuda":
        raise ValueError(f"fused_bincount: unsupported device {device}")
    if not all(key.is_contiguous() for key in keys):
        raise ValueError("fused_bincount: every key vector must be contiguous")
    total = sum(int(k) for k in keyspaces)
    if total == 0 or all(key.numel() == 0 for key in keys):
        return torch.zeros(total, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        name = regime(total)
    scratch, out = _fused_buffers(keys, keyspaces, name)
    _fused_launch(keys, keyspaces, scratch, out, name)
    FUSED_LAUNCHES += 1
    return out


def _fused_args(keys, keyspaces) -> tuple:
    """The multi-input entry's inputs: pointers, rows, keyspaces, count."""
    k = len(keys)
    return (
        (ctypes.c_void_p * k)(*[key.data_ptr() for key in keys]),
        (ctypes.c_longlong * k)(*[key.numel() for key in keys]),
        (ctypes.c_longlong * k)(*[int(x) for x in keyspaces]),
        k,
    )


def _fused_buffers(keys, keyspaces, regime_name: str) -> tuple:
    """What one multi-input call writes, as :func:`fused_bincount`
    allocates it: the regime's scratch and the zeroed int64 output (every
    launch of the entry adds into it)."""
    device = keys[0].device
    total = sum(int(x) for x in keyspaces)
    with torch.cuda.device(device):
        nbytes = _library().deequ_bincount_multi_scratch_bytes(
            REGIMES.index(regime_name), *_fused_args(keys, keyspaces)
        )
    if nbytes < 0:
        raise ValueError(
            f"fused_bincount: the {regime_name} regime cannot take {total} "
            "bins (the multi-input entry takes the shared and partition regimes)"
        )
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.zeros(total, dtype=torch.int64, device=device)
    return scratch, out


def _fused_launch(keys, keyspaces, scratch, out, regime_name: str) -> None:
    """Enqueue the multi-input entry on the current stream into ``out``
    with the buffers of :func:`_fused_buffers`, with no checks and no
    allocation (``chip_smoke.py`` times it alone). Raises if the launch
    was refused."""
    device = keys[0].device
    args = _fused_args(keys, keyspaces)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _library().deequ_bincount_multi(
            REGIMES.index(regime_name), *args,
            scratch.data_ptr() if scratch.numel() else None, out.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"fused bincount kernel launch failed ({len(keys)} inputs, "
            f"{sum(key.numel() for key in keys)} rows, {out.numel()} bins, "
            f"regime={regime_name})", rc,
        )
