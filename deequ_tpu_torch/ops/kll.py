"""KLL quantile sketch (mergeable, serializable) — host numpy, a copy of
``deequ_tpu/ops/kll.py`` kept bit for bit: the same compaction, the same
seeded bit sequence (``_next_bit``, ``rng_count``), so a state of the port
and one of the reference built from the same items are identical.

Re-implementation of the KLL algorithm (Karnin–Lang–Liberty, FOCS'16 —
public algorithm) with the reference's parameterization: ``sketch_size``
(k, default 2048) and ``shrinking_factor`` (c, default 0.64), compactor
capacity ``2 * (ceil(k * c^depth / 2) + 1)`` where depth counts down from
the top compactor (reference analyzers/QuantileNonSample.scala:78-80,
defaults at analyzers/KLLSketch.scala:172-176).

Vectorized batch updates: a whole chunk of values is appended at once and
levels compact with one numpy sort per overflow — the amortized analogue of
the reference's per-row update loop (KLLRunner.scala:167-174), ~C-speed on
host. Chunk summaries come from the device scan (ops/kll_device.py);
sketches merge with the levelwise concatenate-and-compact rule, which is
also how incremental (carried-over) states merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_SKETCH_SIZE = 2048
DEFAULT_SHRINKING_FACTOR = 0.64


class KLLSketchState:
    """One KLL sketch: a hierarchy of compactors; items at level h have
    weight 2^h. Not thread-safe; treated as a value by the engine."""

    def __init__(
        self,
        sketch_size: int = DEFAULT_SKETCH_SIZE,
        shrinking_factor: float = DEFAULT_SHRINKING_FACTOR,
        compactors: Optional[List[np.ndarray]] = None,
        count: int = 0,
        rng_count: int = 0,
    ):
        self.sketch_size = int(sketch_size)
        self.shrinking_factor = float(shrinking_factor)
        self.compactors: List[np.ndarray] = (
            [np.empty(0, dtype=np.float64)] if compactors is None else compactors
        )
        self.count = int(count)  # total items represented (by weight)
        # compaction-randomness position: bits are drawn by hashing this
        # counter (see _next_bit), so persisting it round-trips the random
        # promote/retain choices exactly across save/load/update cycles
        # (a resumed sketch continues the SAME bit stream instead of
        # replaying it from the seed)
        self.rng_count = int(rng_count)

    def _next_bit(self) -> int:
        """Deterministic, serializable bit source: splitmix64 finalizer of
        the draw index. Machine-independent and position-restorable —
        unlike a numpy Generator, whose internal state did not survive the
        binary state codec (states/serde.py)."""
        m = (1 << 64) - 1
        z = (self.rng_count * 0x9E3779B97F4A7C15 + 0xDEE0DEE0) & m
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4B9B1) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        self.rng_count += 1
        return int((z ^ (z >> 31)) & 1)

    # -- capacities ---------------------------------------------------------

    def _capacity(self, level: int) -> int:
        depth = len(self.compactors) - 1 - level
        k = self.sketch_size * (self.shrinking_factor ** depth)
        return 2 * (math.ceil(k / 2) + 1)

    # -- updates ------------------------------------------------------------

    def update_batch(self, values: np.ndarray) -> None:
        """Insert a batch of values (no NaNs/nulls — caller filters)."""
        if len(values) == 0:
            return
        self.compactors[0] = np.concatenate(
            [self.compactors[0], np.asarray(values, dtype=np.float64)]
        )
        self.count += len(values)
        self._compress()

    def _compress(self) -> None:
        level = 0
        while level < len(self.compactors):
            buf = self.compactors[level]
            if len(buf) <= self._capacity(level):
                level += 1
                continue
            if level + 1 == len(self.compactors):
                self.compactors.append(np.empty(0, dtype=np.float64))
                # appending a level shrinks the depth-based capacities of
                # every lower level — restart the walk from 0 so all buffers
                # end within capacity (QuantileNonSample capacity invariant)
                level = 0
                continue
            buf = np.sort(buf)
            # an odd-length buffer keeps one leftover item at this level so
            # total weight is preserved exactly; the even remainder compacts
            if len(buf) % 2 == 1:
                keep_last = self._next_bit()
                if keep_last:
                    retained, to_compact = buf[-1:], buf[:-1]
                else:
                    retained, to_compact = buf[:1], buf[1:]
            else:
                retained = np.empty(0, dtype=np.float64)
                to_compact = buf
            offset = self._next_bit()
            promoted = to_compact[offset::2]
            self.compactors[level] = retained
            self.compactors[level + 1] = np.concatenate(
                [self.compactors[level + 1], promoted]
            )
            level += 1

    # -- merge --------------------------------------------------------------

    def merge(self, other: "KLLSketchState") -> "KLLSketchState":
        """Levelwise concatenation followed by compaction."""
        if (self.sketch_size, self.shrinking_factor) != (
            other.sketch_size, other.shrinking_factor,
        ):
            raise ValueError("cannot merge KLL sketches with different parameters")
        levels = max(len(self.compactors), len(other.compactors))
        merged = []
        for i in range(levels):
            a = self.compactors[i] if i < len(self.compactors) else np.empty(0)
            b = other.compactors[i] if i < len(other.compactors) else np.empty(0)
            merged.append(np.concatenate([a, b]).astype(np.float64))
        out = KLLSketchState(
            self.sketch_size, self.shrinking_factor, merged,
            self.count + other.count, self.rng_count + other.rng_count,
        )
        out._compress()
        return out

    # -- queries ------------------------------------------------------------

    def _weighted_items(self) -> Tuple[np.ndarray, np.ndarray]:
        items = []
        weights = []
        for level, buf in enumerate(self.compactors):
            if len(buf):
                items.append(buf)
                weights.append(np.full(len(buf), 2 ** level, dtype=np.int64))
        if not items:
            return np.empty(0), np.empty(0, dtype=np.int64)
        items = np.concatenate(items)
        weights = np.concatenate(weights)
        order = np.argsort(items, kind="stable")
        return items[order], weights[order]

    def rank(self, value: float) -> int:
        """Estimated number of items <= value."""
        items, weights = self._weighted_items()
        return int(weights[items <= value].sum())

    def rank_exclusive(self, value: float) -> int:
        """Estimated number of items < value."""
        items, weights = self._weighted_items()
        return int(weights[items < value].sum())

    def cdf(self, values: Sequence[float]) -> List[float]:
        total = max(self.count, 1)
        return [self.rank(v) / total for v in values]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile, q in [0, 1]."""
        items, weights = self._weighted_items()
        if len(items) == 0:
            return float("nan")
        cum = np.cumsum(weights)
        target = q * cum[-1]
        idx = int(np.searchsorted(cum, target, side="left"))
        return float(items[min(idx, len(items) - 1)])

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    # -- serde (analogue of KLLSketchSerializer.scala:26-121) ---------------

    def serialize(self) -> tuple:
        return (
            self.sketch_size,
            self.shrinking_factor,
            self.count,
            tuple(tuple(float(x) for x in buf) for buf in self.compactors),
            self.rng_count,
        )

    @staticmethod
    def deserialize(data: tuple) -> "KLLSketchState":
        sketch_size, shrinking_factor, count, buffers = data[:4]
        rng_count = data[4] if len(data) > 4 else 0
        compactors = [np.array(buf, dtype=np.float64) for buf in buffers]
        if not compactors:
            compactors = [np.empty(0, dtype=np.float64)]
        return KLLSketchState(
            sketch_size, shrinking_factor, compactors, count, rng_count
        )

    @staticmethod
    def reconstruct(raw_buffers, parameters) -> "KLLSketchState":
        """Rebuild from BucketDistribution.data/.parameters
        (analogue of QuantileNonSample.reconstruct, reference L46-60)."""
        shrinking_factor, sketch_size = parameters
        compactors = [np.array(buf, dtype=np.float64) for buf in raw_buffers]
        count = sum(len(b) * (2 ** i) for i, b in enumerate(compactors))
        return KLLSketchState(int(sketch_size), float(shrinking_factor), compactors, count)
