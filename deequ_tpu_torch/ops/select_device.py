"""K4: the batched multi-rank radix select — the port's counterpart of
``deequ_tpu/ops/select_device.py``.

A KLL chunk summary (``ops/kll_device.py``) reads only k + 2 rank
positions of a sorted column: the k strata midpoints and the two ends of
the exact remainder. This module finds the values at those ranks without
sorting: it narrows every target rank of every column at once with
histogram passes over the bytes of an order-preserving key. Its output is
K3's, bit for bit: {items, weights, count, min, max} with the same strata
and remainder layout and the same static width
``W = strata_capacity(capacity, k)``; only the remainder's order differs
(row order here, sorted there), which ``fold_summaries`` undoes by sorting
each level.

One formulation per device, as ``histogram_device`` has:

- on a CUDA tensor, :func:`chunk_summary_select_batched` and
  :func:`select_ranks` launch the hand-written kernel of
  ``deequ_tpu_torch/csrc/select.cu`` (its passes, their resolution, the
  remainder and the tied strata all on the card, no full-size tensor, no
  host sync), or raise;
- on a CPU tensor they run :func:`chunk_summary_select_batched_plain` /
  :func:`select_ranks_plain`, the kernel's plain PyTorch version in the
  kernel's digit plan, which is also what the tests and ``chip_smoke.py``
  hold the kernel against (pass by pass, through ``trace``).

The key. The reference keys on the 32 bits of its f32 hi plane and keeps
wide-f64 columns on the sort. Every numeric column of the port is f64, so
the port keys on the **order-preserving 64-bit key of the canonical f64**,
in the order K3 sorts (``kll_device._sorted_values``): -0.0 and +0.0 share
one key, every NaN takes one key above +inf, invalid rows take the +inf
key (K3 pads them with +inf). As a signed int64 (torch has no unsigned
64-bit arithmetic on the CPU) the key is the f64's bits, with every bit
but the sign flipped for negative values; the passes read it unsigned
(the sign bit flipped), most significant byte first.

The passes. Eight, one byte each. Pass p counts, for every element whose
top 8p bits equal the prefix resolved so far by some target, its next
byte, in the row of that target interval: the intervals are the distinct
prefixes of the column's targets, ascending (the targets' ranks sorted,
so their prefixes are), and an element finds its interval by search. Each
target then takes the byte whose cumulative count passes its rank inside
the interval. After pass 8 each target knows its key and its rank inside
the key's tie group. The plain version counts each pass with one
``bincount`` over every column of a batch (bins offset by column; K5 on
the card, its plain version on the CPU), a batch holding at most
``MAX_BINS`` bins.

Bits. A key other than the zero key and the NaN key is one f64 bit
pattern, so its value is the key inverted. A target on the zero key
(-0.0 against +0.0) or the NaN key (payloads) takes the row that K3's
stable sort puts there: the (tie rank)-th row of that key in row order.
The remainder is the reference's: every row between the keys at ranks r0
and m - 1, ties at either end split by row order, in row order. Count,
min and max are K3's: min and max over the valid rows, NaN if one is NaN
(the kernel returns the canonical NaN; ±0 compare equal).

Bound: one read of the (K, n) values and their validity, 9 bytes a row.
The kernel reads them once a pass and twice for the remainder.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from deequ_tpu_torch.exceptions import DeviceException
from deequ_tpu_torch.ops import cuda_build
from deequ_tpu_torch.ops.histogram_device import bincount
from deequ_tpu_torch.ops.kll_device import strata_capacity, strata_weight

#: the largest sketch size the select takes: its per-pass histograms are
#: (k + 2)·256 bins a column; a larger k keeps the sort (the reference's cap)
MAX_SELECT_SKETCH_SIZE = 1 << 14

#: the most bins one bincount of a plain pass counts (the columns of a
#: batch are split to stay at or below it)
MAX_BINS = 1 << 25

#: kernel launches since the last reset: one per call of the CUDA kernel's
#: pipeline (its passes, resolution and remainder), and nowhere else
#: (chip_smoke.py reads it around the main path)
LAUNCHES = 0

#: the passes, one byte of the key each
PASSES = 8
_B = 256
_SIGN_REST = 0x7FFFFFFFFFFFFFFF
_SIGN = -(1 << 63)
#: the key of every NaN (above +inf's) and of both zeros
NAN_KEY = _SIGN_REST
ZERO_KEY = 0

#: the kernel's stages, in the order ``deequ_select_summary`` times them
STAGES = ("init", "pass1", "targets", "resolve1",
          *(f"{kind}{p}" for p in range(2, PASSES + 1) for kind in ("pass", "resolve")),
          "remainder_count", "tile_scan", "remainder_write", "tie_rows", "assemble")


def monotone_i64(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving int64 key of f64 ``x`` (module doc): signed
    int64 order of the keys is K3's order of the values, -0.0 keys as +0.0
    and every NaN as :data:`NAN_KEY`."""
    canon = torch.where(x == 0, 0.0, x)
    bits = canon.view(torch.int64)
    key = torch.where(bits < 0, bits ^ _SIGN_REST, bits)
    return torch.where(torch.isnan(x), NAN_KEY, key)


def inverse_monotone_i64(key: torch.Tensor) -> torch.Tensor:
    """The f64 of a key (the canonical value: +0.0 for the zero key)."""
    bits = torch.where(key < 0, key ^ _SIGN_REST, key)
    return bits.view(torch.float64)


def _bucket_of_rank(tcum: torch.Tensor, rank_rem: torch.Tensor):
    """Per target: the first bucket whose cumulative count passes the
    target's rank inside its interval, and the count below that bucket.
    ``tcum`` is (K, R, B), ``rank_rem`` (K, R)."""
    bucket = (tcum <= rank_rem.unsqueeze(2)).sum(2).clamp(max=tcum.shape[2] - 1)
    below = tcum.gather(2, (bucket - 1).clamp(min=0).unsqueeze(2)).squeeze(2)
    return bucket, torch.where(bucket > 0, below, 0)


def _intervals(prefix: torch.Tensor):
    """The distinct prefixes of each row of ``prefix`` ((K, R), each below
    2^56), ascending and padded with int64's maximum, and each target's
    index among them."""
    K, R = prefix.shape
    srt = prefix.sort(dim=1).values
    head = torch.ones_like(srt, dtype=torch.bool)
    head[:, 1:] = srt[:, 1:] != srt[:, :-1]
    at = torch.where(head, head.cumsum(1) - 1, R)
    table = torch.full((K, R + 1), _SIGN_REST, dtype=torch.int64, device=prefix.device)
    table.scatter_(1, at, srt)  # the non-heads all land in the cut column
    table = table[:, :R].contiguous()
    return table, torch.searchsorted(table, prefix)


def _select_batch(key: torch.Tensor, ranks: torch.Tensor, trace: Optional[list] = None):
    """Resolve ``ranks`` ((K, R) int64, each in [0, n)) against the
    ascending order of each row of ``key`` ((K, n) int64): returns the key
    at each rank and the target's rank inside that key's tie group, both
    (K, R). Eight histogram passes, no sort of the data. With ``trace``,
    appends each pass's (prefix, rank left), the prefix read unsigned."""
    K, n = key.shape
    R = ranks.shape[1]
    dev = key.device
    col = torch.arange(K, dtype=torch.int64, device=dev).unsqueeze(1)
    ukey = key ^ _SIGN  # the key's bits with the sign flipped: unsigned order
    prefix = torch.zeros((K, R), dtype=torch.int64, device=dev)
    row = torch.zeros((K, R), dtype=torch.int64, device=dev)
    rank_rem = ranks.clone()
    table = None
    c = R * _B
    for p in range(PASSES):
        shift = 56 - 8 * p
        digit = (ukey >> shift) & (_B - 1)
        if p == 0:
            cell = col * c + digit
        else:  # the element's top 8p bits, unsigned; its interval, if any
            top = (ukey >> (shift + 8)) & ((1 << (8 * p)) - 1)
            at = torch.searchsorted(table, top).clamp(max=R - 1)
            inside = table.gather(1, at) == top
            cell = torch.where(inside, col * c + at * _B + digit, K * c)
        hist = bincount(cell.reshape(-1), K * c).view(K, R, _B)
        tcum = hist.cumsum(2).gather(1, row.unsqueeze(2).expand(K, R, _B))
        bucket, below = _bucket_of_rank(tcum, rank_rem)
        rank_rem = rank_rem - below
        prefix = (prefix << 8) | bucket  # after the last pass: the unsigned key's bits
        if trace is not None:
            trace.append((prefix.clone(), rank_rem.clone()))
        if p < PASSES - 1:
            table, row = _intervals(prefix)
    return prefix ^ _SIGN, rank_rem


def _as_key(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    return monotone_i64(torch.where(M, X, math.inf))


def select_ranks_plain(X: torch.Tensor, M: torch.Tensor, ranks: torch.Tensor,
                       trace: bool = False):
    """The key (:func:`monotone_i64` of the value, +inf's key for an
    invalid row) at each of ``ranks`` ((K, R) int64, clipped into [0, n))
    of the ascending order of each row of (K, n) values ``X`` with
    validity ``M``, and the rank inside that key's ties: (keys, tie), both
    (K, R). With ``trace``, also (prefix, rank left) of every pass, each
    (K, 8, R). :func:`_select_batch` over column batches of at most
    :data:`MAX_BINS` bins a pass."""
    key = _as_key(X, M)
    K, n = key.shape
    ranks = ranks.clamp(0, n - 1)
    per = max(1, MAX_BINS // (ranks.shape[1] * _B))
    parts = []
    for i in range(0, K, per):
        steps = [] if trace else None
        keys, tie = _select_batch(key[i:i + per], ranks[i:i + per], steps)
        parts.append((keys, tie, steps))
    keys = torch.cat([p[0] for p in parts])
    tie = torch.cat([p[1] for p in parts])
    if not trace:
        return keys, tie
    pfx = torch.cat([torch.stack([s[0] for s in p[2]], 1) for p in parts])
    rem = torch.cat([torch.stack([s[1] for s in p[2]], 1) for p in parts])
    return keys, tie, (pfx, rem)


def _tie_rows(key: torch.Tensor, tie_key: int, tie_rank: torch.Tensor) -> torch.Tensor:
    """Per target: the row holding the (``tie_rank``)-th occurrence of
    ``tie_key`` in its column, in row order (clipped to the last row where
    a target does not sit on ``tie_key``)."""
    seen = (key == tie_key).cumsum(1, dtype=torch.int32)
    rows = torch.searchsorted(seen, (tie_rank + 1).to(torch.int32))
    return rows.clamp(max=key.shape[1] - 1)


def _targets(m: torch.Tensor, k: int):
    """The ranks of the summary's targets ((K, k + 2): the k strata
    midpoints, then the remainder's first and last rank, all clipped into
    [0, m); a padding target's weight is 0), and (w, n_strata)."""
    w, n_strata = strata_weight(m, k)
    hi_rank = (m - 1).clamp(min=0).unsqueeze(1)
    r0 = (n_strata * w).unsqueeze(1)
    sidx = torch.arange(k, device=m.device) * w.unsqueeze(1) + (w // 2).unsqueeze(1)
    ranks = torch.cat([torch.minimum(sidx, hi_rank), torch.minimum(r0, hi_rank), hi_rank], 1)
    return ranks, w, n_strata


def _padded(X: torch.Tensor, M: torch.Tensor):
    """An empty chunk summarises as one invalid row, as K3 pads it."""
    if X.shape[-1] == 0:
        X = torch.zeros(X.shape[:-1] + (1,), dtype=torch.float64, device=X.device)
        M = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    return X, M


def chunk_summary_select_batched_plain(
    X: torch.Tensor, M: torch.Tensor, sketch_size: int, capacity: int
) -> dict:
    """The kernel's plain version: K columns at once, (K, n) f64 values
    and (K, n) validity -> one summary per column, exactly
    ``kll_device.chunk_summary_batched``'s (module doc), by the radix
    select."""
    k = sketch_size
    W = strata_capacity(capacity, k)
    X, M = _padded(X, M)
    K, n = X.shape
    dev = X.device
    m = M.sum(dim=-1)
    xf = torch.where(M, X, math.inf)
    key = monotone_i64(xf)
    ranks, w, n_strata = _targets(m, k)
    keys, tie = select_ranks_plain(X, M, ranks)

    # strata items: the value of each key, or, on the zero and NaN keys,
    # the row K3's stable sort puts at that rank
    ks, ts = keys[:, :k], tie[:, :k]
    items_s = inverse_monotone_i64(ks)
    for tie_key in (ZERO_KEY, NAN_KEY):
        tied = xf.gather(1, _tie_rows(key, tie_key, ts))
        items_s = torch.where(ks == tie_key, tied, items_s)
    ar_k = torch.arange(k, device=dev)
    weights_s = torch.where(ar_k < n_strata.unsqueeze(1), w.unsqueeze(1), 0)

    # the exact remainder: rows between the keys at ranks r0 and m - 1,
    # ties at either end split by row order, in row order
    r0 = (n_strata * w).unsqueeze(1)
    v_b, v_t = keys[:, k:k + 1], keys[:, k + 1:k + 2]
    j0, j1 = tie[:, k:k + 1], tie[:, k + 1:k + 2]
    tie_b, tie_t = key == v_b, key == v_t
    above = (key > v_b) | (tie_b & (tie_b.cumsum(1, dtype=torch.int32) > j0))
    below = (key < v_t) | (tie_t & (tie_t.cumsum(1, dtype=torch.int32) <= j1 + 1))
    rem = above & below & (r0 < m.unsqueeze(1))
    slot = rem.cumsum(1) - 1
    # rows outside the remainder write into 1,024 spare slots past W,
    # spread so their stores do not all meet on one address
    spare = W + (torch.arange(n, device=dev) & 1023)
    slot = torch.where(rem, slot, spare)
    items_r = torch.zeros((K, W + 1024), dtype=torch.float64, device=dev)
    items_r = items_r.scatter_(1, slot, xf)[:, :W]
    n_rem = torch.where(r0 < m.unsqueeze(1), m.unsqueeze(1) - r0, 0)
    weights_r = (torch.arange(W, device=dev) < n_rem).to(torch.int64)

    items = torch.cat([items_s, items_r], 1)
    weights = torch.cat([weights_s, weights_r], 1)
    return {
        "items": torch.where(weights > 0, items, 0.0),
        "weights": weights.to(torch.float64),
        "count": m,
        "min": torch.where(M, X, math.inf).amin(dim=-1),
        "max": torch.where(M, X, -math.inf).amax(dim=-1),
    }


# -- the CUDA kernel --------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.deequ_select_scratch_bytes.argtypes = [i64, i64, i32]
    lib.deequ_select_scratch_bytes.restype = i64
    lib.deequ_select_summary.argtypes = [p, p, i64, i64, i32, i64, p, p, p, p, p, p, p, p]
    lib.deequ_select_summary.restype = i32
    lib.deequ_select_ranks.argtypes = [p, p, i64, i64, p, i32, p, p, p, p, p, p]
    lib.deequ_select_ranks.restype = i32


def _library() -> ctypes.CDLL:
    return cuda_build.library("select", _bind)


def _check_args(X, M) -> None:
    if not isinstance(X, torch.Tensor) or X.dim() != 2 or X.dtype != torch.float64:
        raise ValueError("select: X must be a (K, n) float64 tensor")
    if not isinstance(M, torch.Tensor) or M.shape != X.shape or M.dtype != torch.bool:
        raise ValueError("select: M must be a bool tensor shaped like X")
    if M.device != X.device:
        raise ValueError("select: X and M lie on different devices")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"select: unsupported device {X.device}")


def _on_card(X, M) -> None:
    if not X.is_contiguous() or not M.is_contiguous():
        raise ValueError("select: X and M must be contiguous")
    if X.shape[1] >= 1 << 31 or X.shape[0] > 65535:
        raise ValueError(f"select: the kernel takes at most 65,535 columns of fewer "
                         f"than 2^31 rows, got {tuple(X.shape)}")


def _scratch(K: int, n: int, R: int, device) -> torch.Tensor:
    nbytes = _library().deequ_select_scratch_bytes(K, n, R)
    if nbytes < 0:
        raise ValueError(f"select: the kernel cannot take K={K}, n={n}, R={R}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def summary_buffers(X: torch.Tensor, sketch_size: int, capacity: int) -> dict:
    """What one launch of the summary writes, as the wrapper allocates
    it: the outputs and the scratch."""
    K, n = X.shape
    k = sketch_size
    W = strata_capacity(capacity, k)
    dev = X.device
    return {
        "items": torch.empty((K, k + W), dtype=torch.float64, device=dev),
        "weights": torch.empty((K, k + W), dtype=torch.float64, device=dev),
        "count": torch.empty(K, dtype=torch.int64, device=dev),
        "min": torch.empty(K, dtype=torch.float64, device=dev),
        "max": torch.empty(K, dtype=torch.float64, device=dev),
        "scratch": _scratch(K, n, k + 2, dev) if K else None,
    }


def launch_summary(X: torch.Tensor, M: torch.Tensor, sketch_size: int, bufs: dict,
                   stage_ms: bool = False):
    """Enqueue the summary kernel on the current stream into ``bufs``
    (:func:`summary_buffers`) with no checks and no allocation:
    :func:`chunk_summary_select_batched` calls it once; ``chip_smoke.py``
    times it alone. With ``stage_ms``, waits for the stream and returns
    {stage: ms} (:data:`STAGES`). Raises if a launch was refused."""
    K, n = X.shape
    k = sketch_size
    W = bufs["items"].shape[1] - k
    times = (ctypes.c_float * len(STAGES))() if stage_ms else None
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = _library().deequ_select_summary(
            X.data_ptr(), M.data_ptr(), K, n, k, W,
            *(bufs[name].data_ptr() for name in ("items", "weights", "count", "min", "max",
                                                  "scratch")),
            stream, ctypes.cast(times, ctypes.c_void_p) if stage_ms else None,
        )
    if rc != 0:
        raise DeviceException(f"select kernel launch failed: CUDA error {rc} "
                              f"(K={K}, n={n}, k={k}, W={W})")
    return dict(zip(STAGES, times)) if stage_ms else None


def chunk_summary_select_batched(
    X: torch.Tensor, M: torch.Tensor, sketch_size: int, capacity: int
) -> dict:
    """K columns at once: (K, n) f64 values and (K, n) validity -> one
    summary per column, exactly ``kll_device.chunk_summary_batched``'s
    (module doc). A CUDA tensor runs the CUDA kernel; a CPU tensor runs
    the plain version."""
    global LAUNCHES
    _check_args(X, M)
    if X.device.type == "cpu":
        return chunk_summary_select_batched_plain(X, M, sketch_size, capacity)
    _on_card(X, M)
    X, M = _padded(X, M)
    bufs = summary_buffers(X, sketch_size, capacity)
    if X.shape[0]:
        launch_summary(X, M, sketch_size, bufs)
        LAUNCHES += 1
    return {name: bufs[name] for name in ("items", "weights", "count", "min", "max")}


def select_ranks(X: torch.Tensor, M: torch.Tensor, ranks: torch.Tensor, trace: bool = False):
    """:func:`select_ranks_plain`'s function: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global LAUNCHES
    _check_args(X, M)
    if ranks.shape[0] != X.shape[0] or ranks.dtype != torch.int64 or ranks.device != X.device:
        raise ValueError("select: ranks must be (K, R) int64 on X's device")
    if X.device.type == "cpu":
        return select_ranks_plain(X, M, ranks, trace)
    _on_card(X, M)
    ranks = ranks.contiguous()
    K, n = X.shape
    R = ranks.shape[1]
    keys = torch.empty((K, R), dtype=torch.int64, device=X.device)
    tie = torch.empty((K, R), dtype=torch.int64, device=X.device)
    steps = (torch.empty((K, PASSES, R), dtype=torch.int64, device=X.device),
             torch.empty((K, PASSES, R), dtype=torch.int64, device=X.device)) if trace else None
    if K and R and n:
        scratch = _scratch(K, n, R, X.device)
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = _library().deequ_select_ranks(
                X.data_ptr(), M.data_ptr(), K, n, ranks.data_ptr(), R, keys.data_ptr(),
                tie.data_ptr(), *((s.data_ptr() for s in steps) if trace else (None, None)),
                scratch.data_ptr(), stream,
            )
        if rc != 0:
            raise DeviceException(f"select kernel launch failed: CUDA error {rc} "
                                  f"(K={K}, n={n}, R={R})")
        LAUNCHES += 1
    return (keys, tie, steps) if trace else (keys, tie)


def chunk_summary_select(x: torch.Tensor, valid: torch.Tensor, sketch_size: int,
                         capacity: int) -> dict:
    """One column of one chunk (:func:`chunk_summary_select_batched` with
    K = 1)."""
    out = chunk_summary_select_batched(
        x.unsqueeze(0), valid.unsqueeze(0), sketch_size, capacity
    )
    return {key: leaf[0] for key, leaf in out.items()}
