"""Device-side quantile sketching: per-chunk sort + deterministic strata
compaction, folded into the standard KLL merge algebra — the port's
counterpart of ``deequ_tpu/ops/kll_device.py``.

1. On the device, sort the chunk's values (``torch.sort``: CUB's radix
   sort on the card; one batched sort over a (K, n) stack for K columns).
2. Compact deterministically: with m valid rows, w = 2^ceil(log2(ceil(m/k)))
   and the chunk reduces to at most k strata items of weight w (each its
   stratum's midpoint) plus < w exact remainder items of weight 1. Total
   weight is exactly m.
3. Fetch only the summary (k + W items) and fold it on the host into a
   ``KLLSketchState`` (:func:`fold_summaries`).

The port sorts f64 as the reference's wide path does, and orders ties as
its stable sort does (-0.0 equal to +0.0 and every NaN equal, each in row
order; NaN after +inf, the +inf padding of invalid rows before the NaNs),
so its summaries are bit-identical to the reference's under
``DEEQU_TPU_COMPUTE=f64``.

Widths are static per scan: W = strata_capacity(capacity, k) from the
scan's chunk capacity, never from the chunk's own rows — the last chunk
is shorter, and every chunk's summary must have the same width for the
device fold.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from deequ_tpu_torch.ops.kll import KLLSketchState


def strata_capacity(local_n: int, sketch_size: int) -> int:
    """Static bound W on the remainder size: w = 2^ceil(log2(ceil(m/k)))
    <= W for every m <= local_n."""
    ratio = max((local_n + sketch_size - 1) // sketch_size, 1)
    return 1 << max(math.ceil(math.log2(ratio)), 0)


def strata_weight(m: torch.Tensor, k: int):
    """(w, n_strata) for m valid rows (an int64 tensor) and sketch size k —
    w = 2^L with L = ceil(log2(ceil(m/k))), the smallest power of two
    reducing m items to <= k strata. An integer shift, with the
    reference's guard: float log2/exp2 are not exact at integer points
    (a float w once dropped ~10% of rows in the reference), so the epsilon
    keeps log2 from landing just above an integer and the where() doubles
    w if it still came out one step short."""
    ratio = torch.clamp((m + k - 1) // k, min=1)
    log2r = torch.ceil(torch.log2(ratio.to(torch.float64)) - 1e-9).to(torch.int64)
    w = torch.ones_like(m) << log2r
    w = torch.where(w * k < m, w * 2, w)
    return w, m // w


def _sorted_values(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Values along the last axis in the reference's stable sort order
    (module doc), invalid rows as +inf. The keys canonicalise -0.0 and
    NaN; the values keep their own bits."""
    xf = torch.where(valid, x, math.inf)
    key = torch.where(xf == 0, 0.0, xf)
    key = torch.where(torch.isnan(key), math.nan, key)
    order = torch.sort(key, dim=-1, stable=True).indices
    return torch.gather(xf, -1, order)


def _summary(sx: torch.Tensor, m: torch.Tensor, k: int, W: int):
    """Strata midpoints and the exact remainder of sorted rows ``sx``
    (last axis) with ``m`` valid rows each: items and weights (..., k+W)."""
    n = sx.shape[-1]
    w, n_strata = strata_weight(m, k)
    w, n_strata, mm = w.unsqueeze(-1), n_strata.unsqueeze(-1), m.unsqueeze(-1)
    ar_k = torch.arange(k, device=sx.device)
    ar_w = torch.arange(W, device=sx.device)
    # strata midpoints: item i represents rows [i*w, (i+1)*w)
    sidx = ar_k * w + w // 2
    s_on = ar_k < n_strata
    # exact remainder (< w items) at level 0, preserving total weight == m
    ridx = n_strata * w + ar_w
    r_on = ridx < mm
    idx = torch.cat([sidx, ridx], dim=-1).clamp(0, n - 1)
    items = torch.gather(sx, -1, idx)
    weights = torch.cat(
        [torch.where(s_on, w, 0), torch.where(r_on, 1, 0)], dim=-1
    )
    # zero the padding values so gathered buffers are deterministic
    items = torch.where(weights > 0, items, 0.0)
    return items, weights.to(torch.float64)


def chunk_summary_batched(X: torch.Tensor, M: torch.Tensor, sketch_size: int,
                          capacity: int) -> dict:
    """K columns at once: (K, n) f64 values and (K, n) validity -> one
    summary per column {items (K, k+W), weights (K, k+W), count (K,),
    min (K,), max (K,)}, from ONE batched sort. Padding slots carry
    weight 0; k = sketch_size, W = strata_capacity(capacity, k)."""
    k = sketch_size
    W = strata_capacity(capacity, k)
    if X.shape[-1] == 0:  # an empty chunk: one invalid row, as padding
        X = torch.zeros(X.shape[:-1] + (1,), dtype=torch.float64, device=X.device)
        M = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    m = M.sum(dim=-1)
    items, weights = _summary(_sorted_values(X, M), m, k, W)
    return {
        "items": items,
        "weights": weights,
        "count": m,
        "min": torch.where(M, X, math.inf).amin(dim=-1),
        "max": torch.where(M, X, -math.inf).amax(dim=-1),
    }


def chunk_summary(x: torch.Tensor, valid: torch.Tensor, sketch_size: int,
                  capacity: int) -> dict:
    """One column of one chunk -> {items (k+W,), weights (k+W,), count,
    min, max} (:func:`chunk_summary_batched` with K = 1)."""
    out = chunk_summary_batched(x.unsqueeze(0), valid.unsqueeze(0), sketch_size, capacity)
    return {key: leaf[0] for key, leaf in out.items()}


def fold_summaries(
    items: np.ndarray,
    weights: np.ndarray,
    sketch_size: int,
    shrinking_factor: float,
) -> Optional[KLLSketchState]:
    """Host-side: gathered per-chunk summaries -> one KLLSketchState.

    Weights are exact powers of two; items of weight 2^l become level-l
    compactor entries, then one standard compaction bounds the size. The
    result obeys the normal KLL merge algebra."""
    items = np.asarray(items, dtype=np.float64).ravel()
    weights = np.asarray(weights, dtype=np.float64).ravel()
    on = weights > 0
    if not on.any():
        return None
    items = items[on]
    levels = np.log2(weights[on]).astype(np.int64)
    max_level = int(levels.max())
    compactors = [
        np.sort(items[levels == l]) for l in range(max_level + 1)
    ]
    count = int(weights[on].sum())
    sketch = KLLSketchState(sketch_size, shrinking_factor, compactors, count)
    sketch._compress()
    return sketch
