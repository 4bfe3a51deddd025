"""Histogram of segment ids — the port's counterpart of
``deequ_tpu/ops/histogram_device.py``, the histogram kernel-variant tier.

The reference routes every histogram through one of three variants
(:data:`HIST_VARIANTS`), resolved per dispatch or per plan by
``ops/device_policy.resolve_hist_variant``. The port keeps the names and
the policy; what each runs:

- ``"onehot"`` — the reference's factored blocked one-hot matmul
  (``bincount_onehot``): an id splits into (hi, lo) digits and the counts
  are ``one_hot(hi)^T @ one_hot(lo)``. On a CUDA tensor
  :func:`bincount_onehot` launches K6, the hand-written tensor-core kernel
  of ``deequ_tpu_torch/csrc/onehot.cu`` (integer MMA fed from registers
  for a keyspace of one tile, rows partitioned by tile first past it; the
  source says why), or raises; on a CPU tensor it runs
  :func:`bincount_onehot_plain`, the reference's formulation in torch (f32
  one-hot planes a row block of :func:`_onehot_geometry`, ``torch.matmul``,
  an integer fold a block);
- ``"scatter"`` and ``"pallas"`` — on a CUDA tensor both launch K5, the
  hand-written kernel of ``deequ_tpu_torch/csrc/bincount.cu`` in the regime
  its width calls for (:func:`regime`: a shared-memory histogram a block
  while one fits, a partition by bucket then a shared-memory histogram a
  bucket up to 2^25 bins, L2 atomics past that), or raise. K5 is the port
  of ``bincount_pallas``, and the port has no second hand-written scatter,
  so the two names launch one kernel; the census
  (``ScanStats.hist_<variant>_dispatches``) still counts each by the name
  that was resolved. On a CPU tensor both run :func:`bincount_plain`
  (``index_add_``), the scatter form.

:func:`bincount` reads the ambient variant (:func:`current_hist_variant`,
"scatter" unless a caller bound one with :func:`active_hist_variant`, as
the planner does around a resident select's passes);
:func:`bincount_variant` takes it explicitly, as the grouping dispatches
do.

:func:`fused_bincount` is the counterpart of the reference's cross-set
grouping fusion (``deequ_tpu/ops/segment.py:1035`` ``fused_group_counts``,
K7): K int64 key vectors counted by one call over their summed keyspace,
each set's ids shifted by the keyspaces before it where the kernel loads
them, so the host neither offsets nor concatenates. A group whose summed
width resolves to ``"onehot"`` runs K6's multi-input entry; any other
runs K7, the multi-input entry of K5's kernel (past a block's shared
histogram two launches: one grid reads every set once, the wide sets
partitioned by bucket and the narrow ones counted in shared memory beside
them, then a cluster of blocks a bucket adds the wide sets' counts). On a
CPU tensor it runs :func:`fused_bincount_plain`, the reference's
formulation (offset, concatenate, count), counted by the variant's plain
version.

Contract (the reference's, shared by every variant): counts over
``[0, num_segments)``; ids outside that range — negative sentinels,
padding, int64 ids past 2^31 — are dropped; optional int32 weights replace
the 1; results are exact integers. Weighted, each bin's total is taken mod
2^32 and read as an int32, as the reference's int32 accumulation gives it:
that is the exact total whenever it lies in int32, whatever the partial
sums on the way, and kernels and plain versions agree on every input.

The kernels are compiled from the sources in the checkout at first use and
bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import contextvars
import ctypes
from contextlib import contextmanager

import torch

from deequ_tpu_torch.exceptions import DeviceException, launch_error
from deequ_tpu_torch.ops import counters, cuda_build

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around the main path)
LAUNCHES = 0

#: launches of the multi-input entry (:func:`fused_bincount`), counted
#: apart from :data:`LAUNCHES`: one a call that launches on a card
FUSED_LAUNCHES = 0

#: K6 launches (:func:`bincount_onehot` and the one-hot route of
#: :func:`fused_bincount`): one a call that launches on a card
ONEHOT_LAUNCHES = 0

#: the variants a histogram dispatch can resolve to (the reference's)
HIST_VARIANTS = ("scatter", "onehot", "pallas")

#: the reference's one-hot geometry (``histogram_device.py:71-79``): the
#: lo radix, and the row block's budget of plane elements and its bounds
_ONEHOT_LANES = 128
_ONEHOT_PLANE_BUDGET = 1 << 25
_ONEHOT_MAX_BLOCK = 1 << 18
_ONEHOT_MIN_BLOCK = 1 << 12

# -- the ambient variant ----------------------------------------------------------

#: the variant ambient :func:`bincount` calls take; a ContextVar, so a
#: binding made for one scan never leaks into another thread's
_ACTIVE_VARIANT: contextvars.ContextVar = contextvars.ContextVar(
    "deequ_torch_hist_variant", default="scatter"
)


def _check_variant(variant: str) -> None:
    if variant not in HIST_VARIANTS:
        raise ValueError(f"hist variant must be one of {HIST_VARIANTS}, got {variant!r}")


def current_hist_variant() -> str:
    """The variant ambient histogram calls take ("scatter" unless a caller
    bound one with :func:`active_hist_variant`)."""
    return _ACTIVE_VARIANT.get()


@contextmanager
def active_hist_variant(variant: str):
    """Bind the ambient histogram variant for the block (the planner binds
    a plan's ``hist_variant`` around its select updates)."""
    _check_variant(variant)
    token = _ACTIVE_VARIANT.set(variant)
    try:
        yield
    finally:
        _ACTIVE_VARIANT.reset(token)


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
    """K5's plain PyTorch version, the scatter form: out-of-range ids map to a
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


def bincount_scatter(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """The ``"scatter"`` and ``"pallas"`` variants: a CUDA tensor launches
    K5 (``csrc/bincount.cu``) in the regime of :func:`regime`, counted in
    :data:`LAUNCHES`; a CPU tensor runs :func:`bincount_plain`. Unweighted
    counts are exact; with int32 ``weights`` each bin holds its total mod
    2^32 read as an int32 (module doc)."""
    _check_args(seg, num_segments, weights)
    if seg.device.type == "cpu":
        return bincount_plain(seg, num_segments, weights, dtype)
    _check_cuda(seg, weights, "bincount")
    num_segments = int(num_segments)
    if seg.numel() == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=dtype, device=seg.device)
    with torch.cuda.device(seg.device):
        name = regime(num_segments)
    bufs = _buffers(seg, num_segments, weights, name)
    _launch(seg, num_segments, weights, *bufs, regime_name=name)
    counters.inc(globals(), "LAUNCHES")
    out = bufs[-1]
    return out if dtype == torch.int64 else out.to(dtype)


def _check_cuda(seg, weights, what: str) -> None:
    if seg.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {seg.device}")
    if not seg.is_contiguous() or (
        weights is not None and not weights.is_contiguous()
    ):
        raise ValueError(f"{what}: seg and weights must be contiguous")


def bincount_variant(
    variant: str, seg: torch.Tensor, num_segments: int, weights=None,
    dtype=torch.int64,
) -> torch.Tensor:
    """Histogram of ``seg`` over ``[0, num_segments)`` under an explicit
    variant (module doc): ``"onehot"`` is :func:`bincount_onehot` (K6 on a
    card), ``"scatter"`` and ``"pallas"`` :func:`bincount_scatter` (K5 on a
    card); a CPU tensor runs the variant's plain version."""
    _check_variant(variant)
    if variant == "onehot":
        return bincount_onehot(seg, num_segments, weights, dtype)
    return bincount_scatter(seg, num_segments, weights, dtype)


def bincount(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """:func:`bincount_variant` under the ambient variant
    (:func:`current_hist_variant`: "scatter" unless a caller bound one)."""
    return bincount_variant(current_hist_variant(), seg, num_segments, weights, dtype)


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


# -- the one-hot variant: K6 ------------------------------------------------------


def _onehot_geometry(num_segments: int):
    """(A, B, block): the reference's hi/lo radix split and row block for
    one keyspace (``histogram_device.py:131``)."""
    B = min(_ONEHOT_LANES, max(8, int(num_segments)))
    A = (int(num_segments) + B - 1) // B
    block = max(_ONEHOT_MIN_BLOCK, min(_ONEHOT_MAX_BLOCK, _ONEHOT_PLANE_BUDGET // (A + B)))
    return A, B, block


def bincount_onehot_plain(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """K6's plain version, the reference's ``bincount_onehot`` in torch: for
    each row block of :func:`_onehot_geometry`, the one-hot planes of the
    hi and lo digits (an id's row of a plane is 1 where the digit equals the
    column, so a negative id or one past A·B matches no column and is
    dropped), their product by ``torch.matmul``, folded into int64. The
    planes ride f32 (each block's counts stay below 2^24, exact); weighted,
    the lo plane times the weight rides f64 (a block's |total| stays below
    2^31 · 2^18, exact), and each bin's total is read mod 2^32 as an int32."""
    _check_args(seg, num_segments, weights)
    m = int(num_segments)
    if m == 0:
        return torch.zeros(0, dtype=dtype, device=seg.device)
    A, B, block = _onehot_geometry(m)
    plane = torch.float32 if weights is None else torch.float64
    hi_ids = torch.arange(A, dtype=torch.int64, device=seg.device)
    lo_ids = torch.arange(B, dtype=torch.int64, device=seg.device)
    counts = torch.zeros((A, B), dtype=torch.int64, device=seg.device)
    seg = seg.to(torch.int64)
    for s in range(0, seg.numel(), block):
        sb = seg[s:s + block]
        hi = torch.div(sb, B, rounding_mode="floor")
        lo = sb - hi * B
        oh = (hi.unsqueeze(1) == hi_ids).to(plane)
        ol = (lo.unsqueeze(1) == lo_ids).to(plane)
        if weights is not None:
            ol = ol * weights[s:s + block].to(plane).unsqueeze(1)
        counts += torch.matmul(oh.T, ol).to(torch.int64)
    counts = counts.reshape(-1)[:m]
    if weights is not None:
        counts = counts.to(torch.int32).to(torch.int64)
    return counts.to(dtype)


def _bind_onehot(lib: ctypes.CDLL) -> None:
    lib.deequ_onehot.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_onehot.restype = ctypes.c_int
    lib.deequ_onehot_multi.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_onehot_multi.restype = ctypes.c_int
    lib.deequ_onehot_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.deequ_onehot_plan.restype = ctypes.c_int
    lib.deequ_onehot_scratch_bytes.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.deequ_onehot_scratch_bytes.restype = ctypes.c_longlong
    lib.deequ_onehot_widest.argtypes = [ctypes.c_int]
    lib.deequ_onehot_widest.restype = ctypes.c_longlong


def _onehot_library() -> ctypes.CDLL:
    return cuda_build.library("onehot", _bind_onehot)


#: the fields of :func:`onehot_plan`, in the kernel's order
ONEHOT_PLAN_FIELDS = ("wide", "log2_b", "tiles", "tile_bins", "narrow_widest", "blocks",
                      "partition_blocks", "count_copies", "chunk_rows", "round_rows",
                      "scratch_bytes")


def onehot_widest(weighted: bool = False) -> int:
    """The widest ``num_segments`` K6 takes (2^22; weighted 2^20)."""
    return int(_onehot_library().deequ_onehot_widest(1 if weighted else 0))


def onehot_plan(num_segments: int, n: int, weighted: bool = False) -> dict:
    """K6's geometry for ``num_segments`` bins over ``n`` rows on the
    current card (:data:`ONEHOT_PLAN_FIELDS`: the route, 1 when the keyspace
    is partitioned by tile first; the lo radix and the tiles of 16·B bins;
    the narrow route's widest keyspace; the grids; the partition's chunk
    rows; the rows of one round; the scratch bytes) — what ``chip_smoke.py``
    reads to test both sides of each boundary and to count the kernel's
    bytes and operations."""
    out = (ctypes.c_longlong * len(ONEHOT_PLAN_FIELDS))()
    rc = _onehot_library().deequ_onehot_plan(
        int(num_segments), int(n), 1 if weighted else 0, ctypes.addressof(out)
    )
    if rc != 0:
        raise ValueError(
            f"onehot: no plan for {num_segments} bins over {n} rows (CUDA error {rc})"
        )
    return dict(zip(ONEHOT_PLAN_FIELDS, (int(v) for v in out)))


def bincount_onehot(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """The ``"onehot"`` variant: a CUDA tensor launches K6
    (``csrc/onehot.cu``), counted in :data:`ONEHOT_LAUNCHES`, or raises
    (ValueError past :func:`onehot_widest`); a CPU tensor runs
    :func:`bincount_onehot_plain`. The tier's contract (module doc)."""
    _check_args(seg, num_segments, weights)
    if seg.device.type == "cpu":
        return bincount_onehot_plain(seg, num_segments, weights, dtype)
    _check_cuda(seg, weights, "bincount_onehot")
    num_segments = int(num_segments)
    if seg.numel() == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=dtype, device=seg.device)
    with torch.cuda.device(seg.device):
        widest = onehot_widest(weights is not None)
    if num_segments > widest:
        raise ValueError(
            f"bincount_onehot: K6 takes at most {widest} segments, got {num_segments}"
        )
    scratch, out = _onehot_buffers(seg.numel(), num_segments, weights is not None,
                                   seg.device)
    _onehot_launch(seg, num_segments, weights, scratch, out)
    counters.inc(globals(), "ONEHOT_LAUNCHES")
    return out if dtype == torch.int64 else out.to(dtype)


def _onehot_buffers(rows: int, num_segments: int, weighted: bool, device) -> tuple:
    """What one K6 call over ``rows`` rows in all writes: the scratch the
    kernel asks for (empty on the narrow route) and the zeroed int64
    output."""
    with torch.cuda.device(device):
        nbytes = _onehot_library().deequ_onehot_scratch_bytes(
            int(num_segments), int(rows), 1 if weighted else 0
        )
    if nbytes < 0:
        raise ValueError(f"onehot: no scratch for {num_segments} bins over {rows} rows")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.zeros(num_segments, dtype=torch.int64, device=device)
    return scratch, out


def _onehot_launch(seg, num_segments: int, weights, scratch, out) -> None:
    """Enqueue K6 on the current stream, adding into ``out`` (zeroed int64
    of ``num_segments``) with the buffers of :func:`_onehot_buffers`, with
    no checks and no allocation (``chip_smoke.py`` times it alone). Raises
    if the launch was refused."""
    n = seg.numel()
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        rc = _onehot_library().deequ_onehot(
            seg.data_ptr(), 1 if seg.dtype == torch.int64 else 0,
            None if weights is None else weights.data_ptr(), n, int(num_segments),
            scratch.data_ptr() if scratch.numel() else None, out.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"onehot kernel launch failed (n={n}, num_segments={num_segments}, "
            f"weighted={weights is not None})", rc,
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


def fused_bincount_plain(keys, keyspaces, variant: str = "scatter") -> torch.Tensor:
    """:func:`fused_bincount`'s plain version, the reference's formulation:
    each set's ids >= 0 shifted by its offset (the rest -1), the vectors
    concatenated, one count over the summed keyspace by the variant's plain
    version (:func:`bincount_onehot_plain` for "onehot", else
    :func:`bincount_plain`)."""
    keys = list(keys)
    _check_fused_args(keys, keyspaces)
    _check_variant(variant)
    shifted, offset = [], 0
    for key, k in zip(keys, keyspaces):
        shifted.append(torch.where(key >= 0, key + offset, -1))
        offset += int(k)
    plain = bincount_onehot_plain if variant == "onehot" else bincount_plain
    return plain(torch.cat(shifted), offset)


def fused_bincount(keys, keyspaces, variant: str = "scatter") -> torch.Tensor:
    """Counts of K int64 key vectors over ``sum(keyspaces)`` bins, set j's
    ids in ``[0, keyspaces[j])`` landing after the keyspaces before it,
    ids < 0 dropped (module doc). On CUDA tensors one call: under
    ``"onehot"`` K6's multi-input entry (at most 2^22 bins in all), counted
    once in :data:`ONEHOT_LAUNCHES`; under the other variants K7, the
    multi-input entry of K5's kernel (shared or partition regime: the
    summed keyspace must be at most the partition regime's width, 2^25; in
    the partition regime a set of at most 16,384 bins of its own is counted
    in shared memory, into its own bins, while the wider ones are
    partitioned, in the same grid), counted once in :data:`FUSED_LAUNCHES`.
    On CPU tensors :func:`fused_bincount_plain`. Exact int64 counts."""
    keys = list(keys)
    _check_fused_args(keys, keyspaces)
    _check_variant(variant)
    device = keys[0].device
    if device.type == "cpu":
        return fused_bincount_plain(keys, keyspaces, variant)
    if device.type != "cuda":
        raise ValueError(f"fused_bincount: unsupported device {device}")
    if not all(key.is_contiguous() for key in keys):
        raise ValueError("fused_bincount: every key vector must be contiguous")
    total = sum(int(k) for k in keyspaces)
    if total == 0 or all(key.numel() == 0 for key in keys):
        return torch.zeros(total, dtype=torch.int64, device=device)
    if variant == "onehot":
        with torch.cuda.device(device):
            widest = onehot_widest()
        if total > widest:
            raise ValueError(
                f"fused_bincount: K6 takes at most {widest} bins in all, got {total}"
            )
        scratch, out = _onehot_buffers(sum(key.numel() for key in keys), total, False,
                                       device)
        _onehot_multi_launch(keys, keyspaces, scratch, out)
        counters.inc(globals(), "ONEHOT_LAUNCHES")
        return out
    with torch.cuda.device(device):
        name = regime(total)
    scratch, out = _fused_buffers(keys, keyspaces, name)
    _fused_launch(keys, keyspaces, scratch, out, name)
    counters.inc(globals(), "FUSED_LAUNCHES")
    return out


def _onehot_multi_launch(keys, keyspaces, scratch, out) -> None:
    """Enqueue K6's multi-input entry on the current stream, adding into
    ``out`` (zeroed int64 of the summed keyspace) with the buffers of
    :func:`_onehot_buffers` over every key's rows, with no checks and no
    allocation (``chip_smoke.py`` times it alone). Raises if the launch
    was refused."""
    device = keys[0].device
    args = _fused_args(keys, keyspaces)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _onehot_library().deequ_onehot_multi(
            *args, scratch.data_ptr() if scratch.numel() else None, out.data_ptr(), stream)
    if rc != 0:
        raise launch_error(
            f"onehot multi-input launch failed ({len(keys)} inputs, "
            f"{sum(key.numel() for key in keys)} rows, {out.numel()} bins)", rc,
        )


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
