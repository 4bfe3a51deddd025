"""K4: the batched multi-rank radix select — the port's counterpart of
``deequ_tpu/ops/select_device.py``.

A KLL chunk summary (``ops/kll_device.py``) reads only k + 2 rank
positions of a sorted column: the k strata midpoints and the two ends of
the exact remainder. This module finds the values at those ranks without
sorting: it narrows every target rank of every column at once with
histogram passes over radix digits of an order-preserving key, and each
pass is one launch of the bincount kernel (``ops/histogram_device.py``,
K5). Its output is K3's, bit for bit: {items, weights, count, min, max}
with the same strata and remainder layout and the same static width
``W = strata_capacity(capacity, k)``; only the remainder's order differs
(row order here, sorted there), which ``fold_summaries`` undoes by
sorting each level.

The key. The reference keys on the 32 bits of its f32 hi plane and keeps
wide-f64 columns on the sort. Every numeric column of the port is f64, so
the port keys on the **order-preserving 64-bit key of the canonical f64**,
in the order K3 sorts (``kll_device._sorted_values``): -0.0 and +0.0 share
one key, every NaN takes one key above +inf, invalid rows take the +inf
key (K3 pads them with +inf). As a signed int64 (torch has no unsigned
64-bit arithmetic on the CPU) the key is the f64's bits, with every bit
but the sign flipped for negative values.

The passes. 16 bits, then six 8-bit digits: seven K5 launches a batch.
Pass 1 counts 65,536 bins a column; each later pass counts R·256 bins a
column (R = k + 2 targets): an element's histogram row is the target
interval its digits so far fall in (a dense cell→row table scattered from
the targets, the reference's LUT), its bin its next digit. Every column of
a batch goes into one launch, bins offset by column, and a batch holds at
most ``MAX_BINS`` bins (2^25: K5's partition regime), so a large k splits
the columns. After pass 7 each target knows its key and its rank inside
the key's tie group.

Bits. A key other than the zero key and the NaN key is one f64 bit
pattern, so its value is the key inverted. A target on the zero key
(-0.0 against +0.0) or the NaN key (payloads) takes the row that K3's
stable sort puts there: the (tie rank)-th row of that key in row order,
found with one cumulative sum a column and a search. The remainder is the
reference's: every row between the keys at ranks r0 and m - 1, ties at
either end split by row order, scattered into W slots in row order.

Bound: one read of the (K, n) values and their validity. The passes read
the (K, n) keys and cell ids seven times over as torch tensor ops, and
the gathers between passes are (K, R·256), so K4 is bound by those bytes,
not by K5's counting.
"""

from __future__ import annotations

import math

import torch

from deequ_tpu_torch.ops.histogram_device import bincount
from deequ_tpu_torch.ops.kll_device import strata_capacity, strata_weight

#: the largest sketch size the select takes: its per-pass histograms are
#: (k + 2)·256 bins a column; a larger k keeps the sort (the reference's cap)
MAX_SELECT_SKETCH_SIZE = 1 << 14

#: the most bins one K5 launch of a pass counts (the columns of a batch
#: are split to stay at or below it)
MAX_BINS = 1 << 25

_PASS1_BITS = 16
_B = 256
#: the right shifts of the six 8-bit digits after the first pass
_SHIFTS = (40, 32, 24, 16, 8, 0)
_SIGN_REST = 0x7FFFFFFFFFFFFFFF
#: the key of every NaN (above +inf's) and of both zeros
NAN_KEY = _SIGN_REST
ZERO_KEY = 0


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


def _segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One histogram pass: K5 on the card, its plain version on the CPU."""
    return bincount(seg.reshape(-1), num_segments)


def _bucket_of_rank(tcum: torch.Tensor, rank_rem: torch.Tensor):
    """Per target: the first bucket whose cumulative count passes the
    target's rank inside its interval, and the count below that bucket.
    ``tcum`` is (K, R, B), ``rank_rem`` (K, R)."""
    bucket = (tcum <= rank_rem.unsqueeze(2)).sum(2).clamp(max=tcum.shape[2] - 1)
    below = tcum.gather(2, (bucket - 1).clamp(min=0).unsqueeze(2)).squeeze(2)
    return bucket, torch.where(bucket > 0, below, 0)


def _select_batch(key: torch.Tensor, ranks: torch.Tensor):
    """Resolve ``ranks`` ((K, R) int64, each in [0, n)) against the
    ascending order of each row of ``key`` ((K, n) int64): returns the key
    at each rank and the target's rank inside that key's tie group, both
    (K, R). Seven histogram passes, no sort."""
    K, n = key.shape
    R = ranks.shape[1]
    dev = key.device
    col = torch.arange(K, dtype=torch.int32, device=dev).unsqueeze(1)
    targets = torch.arange(R, dtype=torch.int32, device=dev).expand(K, R).reshape(-1)

    # pass 1: the top 16 bits, one interval a column
    c_prev = 1 << _PASS1_BITS
    cell = ((key >> 48) + (1 << 15)).to(torch.int32) + col * c_prev
    cum = _segment_count(cell, K * c_prev).view(K, c_prev).cumsum(1)
    pfx = torch.searchsorted(cum, ranks, right=True)
    below = cum.gather(1, (pfx - 1).clamp(min=0))
    rank_rem = ranks - torch.where(pfx > 0, below, 0)
    target_cell = pfx + col.long() * c_prev
    digits = [pfx]

    key_bytes = key.view(torch.uint8).view(K, n, 8)  # little-endian bytes
    c = R * _B
    for shift in _SHIFTS:
        # each target interval's row: the least target index sharing it;
        # an element outside every target interval gathers R
        lut = torch.full((K * c_prev + 1,), R, dtype=torch.int32, device=dev)
        lut.scatter_reduce_(0, target_cell.reshape(-1), targets, reduce="amin")
        row = lut.index_select(0, cell.reshape(-1)).view(K, n)
        digit = key_bytes[:, :, shift // 8].to(torch.int32)
        cell = torch.where(row < R, col * c + row * _B + digit, K * c)
        hist = _segment_count(cell, K * c).view(K, R, _B)
        trow = lut[target_cell].long()
        tcum = hist.cumsum(2).gather(1, trow.unsqueeze(2).expand(K, R, _B))
        bucket, below = _bucket_of_rank(tcum, rank_rem)
        rank_rem = rank_rem - below
        target_cell = col.long() * c + trow * _B + bucket
        digits.append(bucket)
        c_prev = c

    keys = (digits[0] - (1 << 15)) * (1 << 48)
    for shift, bucket in zip(_SHIFTS, digits[1:]):
        keys = keys + bucket * (1 << shift)
    return keys, rank_rem


def select_ranks(key: torch.Tensor, ranks: torch.Tensor):
    """:func:`_select_batch` over column batches of at most
    :data:`MAX_BINS` bins a pass."""
    K = key.shape[0]
    width = max(1 << _PASS1_BITS, ranks.shape[1] * _B)
    per = max(1, MAX_BINS // width)
    if K <= per:
        return _select_batch(key, ranks)
    parts = [_select_batch(key[i:i + per], ranks[i:i + per]) for i in range(0, K, per)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _tie_rows(key: torch.Tensor, tie_key: int, tie_rank: torch.Tensor) -> torch.Tensor:
    """Per target: the row holding the (``tie_rank``)-th occurrence of
    ``tie_key`` in its column, in row order (clipped to the last row where
    a target does not sit on ``tie_key``)."""
    seen = (key == tie_key).cumsum(1, dtype=torch.int32)
    rows = torch.searchsorted(seen, (tie_rank + 1).to(torch.int32))
    return rows.clamp(max=key.shape[1] - 1)


def chunk_summary_select_batched(
    X: torch.Tensor, M: torch.Tensor, sketch_size: int, capacity: int
) -> dict:
    """K columns at once: (K, n) f64 values and (K, n) validity -> one
    summary per column, exactly ``kll_device.chunk_summary_batched``'s
    (module doc), by the radix select."""
    k = sketch_size
    W = strata_capacity(capacity, k)
    if X.shape[-1] == 0:  # an empty chunk: one invalid row, as K3 pads it
        X = torch.zeros(X.shape[:-1] + (1,), dtype=torch.float64, device=X.device)
        M = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    K, n = X.shape
    dev = X.device
    m = M.sum(dim=-1)
    w, n_strata = strata_weight(m, k)
    xf = torch.where(M, X, math.inf)
    key = monotone_i64(xf)

    # targets: k strata midpoints, then the remainder's first and last
    # rank, all clipped into [0, m) (a padding target's weight is 0)
    hi_rank = (m - 1).clamp(min=0).unsqueeze(1)
    r0 = (n_strata * w).unsqueeze(1)
    sidx = torch.arange(k, device=dev) * w.unsqueeze(1) + (w // 2).unsqueeze(1)
    ranks = torch.cat([torch.minimum(sidx, hi_rank), torch.minimum(r0, hi_rank), hi_rank], 1)
    keys, tie = select_ranks(key, ranks)

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


def chunk_summary_select(x: torch.Tensor, valid: torch.Tensor, sketch_size: int,
                         capacity: int) -> dict:
    """One column of one chunk (:func:`chunk_summary_select_batched` with
    K = 1)."""
    out = chunk_summary_select_batched(
        x.unsqueeze(0), valid.unsqueeze(0), sketch_size, capacity
    )
    return {key: leaf[0] for key, leaf in out.items()}
