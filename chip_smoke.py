#!/usr/bin/env python3
"""Drive deequ_tpu_torch's main path on one CUDA card and hold every kernel
of that path against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N] [--seed S]

Phases, each printed as one JSON line on stdout:

1. ``device``  — the card (torch) and its name and power limit (nvidia-smi);
2. ``build``   — compile the CUDA kernels from the checkout's sources, one
   ``nvcc`` each, all at once, and the native host kernels
   (``deequ_tpu_torch/native/kernels.cpp``) with ``g++``;
3. ``kernel_parity`` — every kernel against its plain version on the card,
   bit-exact, over edge cases, both sides of each regime boundary, 10^7
   Zipf and single-hot-bin ids in every regime that can take their width,
   and weights whose per-block partial sums leave int32;
4. ``main_path`` — ``VerificationSuite.on_data(table).add_check(check).run()``
   on a 10^7-row table (20 float64 columns with 1% nulls, the repo's
   profiling config 2 in BASELINE.md, plus an all-distinct int64 id, a
   Zipf-skewed int64 customer id with ~10^6 distinct values, and string
   columns of 8 and 5,000 values), every metric checked against numpy;
   the kernel launch counts are read around the run and the run is
   watched for any torch operation computing on a CPU tensor;
5. ``kernel_timing`` — each kernel at the shapes the main path gave it:
   the kernel alone (``kernel_ms``: 100 queued launches into preallocated
   buffers, CUDA events; the same in every other regime that can take the
   width, ``regime_ms``; torch.profiler's device time beside it), one
   wrapper call as a caller pays it (``call_ms``), its plain version, the
   PyTorch library call computing the same function, and its bound; and
   every regime on both sides of each regime boundary (``boundaries``);
6. ``hll_parity`` (run after phase 3) — the HLL kernel against its plain
   version on the card, bit-exact: the float64 split's edge values (NaN
   payloads and signs, ±inf, ±0.0, f32-subnormal magnitudes, past the f32
   range, ±2^31, 2^53 + 1), boolean and string-LUT inputs, an all-invalid
   column, one row, sizes around a block's and the grid's rows, and 10^7
   rows of each input mode;
6b. ``select_parity`` (run after phase 6) — K4's kernel
   (``csrc/select.cu``) against its plain version on the card, bit for bit
   (the summary with the remainder in the same row order, and
   ``select_ranks``' keys, tie ranks and each pass's prefix and rank left,
   at the summary's targets and at ranks in any order), and against K3
   (the remainder sorted): tests/select_cases.py's adversarial columns at
   k = 256, 2,048 and 16,384, the kernel's tile edges at K = 1 and 50, and
   a constant column at the resident sketch chunk's rows;
7. ``sketch_path`` — a second ``run()`` at BASELINE.md config 3's width
   (10^7 rows: 48 float64 columns, an int64 column within int32 and one
   beyond it, a boolean and a 5,000-value string column): ApproxQuantile at
   four quantiles on the 50 numeric columns, one KLLSketch,
   ApproxCountDistinct on all 52 columns and one Correlation; it checks one
   fetch, one batched sort a chunk, no torch op on a CPU tensor, one HLL
   launch per column and chunk, every column's registers against the plain
   version, every estimate and quantile against numpy, and the card's KLL
   states against the CPU's on a 10^6-row slice; then the run's wall time
   and its pieces;
8. ``kernel_timing`` of the HLL kernel at that table's shape;
9. ``check_api_path`` (run after phase 4, over its table) — a second
   ``run()`` of one check holding the check methods of the frequency
   tables and the string analyzers: has_histogram_values(status),
   has_number_of_distinct_values(region) with a binning UDF,
   has_mutual_information(status, region) (dense, 9 x 5,001 slots) and
   (customer_id, status) (about 9.7M slots: the sparse device route),
   has_min_length / has_max_length / has_pattern / contains_email(region),
   has_data_type(status) and a Histogram of the float64 f0; every metric
   against numpy (exact; MutualInformation relative 1e-12), four K5
   launches, one fused scan with one fetch, no torch op on a CPU tensor;
10. ``frequency_path`` — BASELINE config 4 (benchmarks/run_configs.py:
   config4) at 10^7 rows: ApproxCountDistinct, Histogram (1,000 detail
   bins) and Uniqueness over one string column of 3,333,333 distinct
   labels; the Distribution (its tied boundary included) and Uniqueness
   exactly against numpy, the estimate within 0.15, one K5 launch a
   count, no torch op on a CPU tensor, no lookup table built by a second
   run, and the card's Distribution equal to the CPU's over 10^6 rows;
   then the run's wall time and its pieces;
11. ``kernel_timing`` of K5 at the frequency path's two shapes and at
   config 4's own width (10^8 ids over 33,333,334 slots, made on the
   card), and of the packed-key top-k there;
12. ``resident_path`` — ``persist()`` and the resident scan, in three
   parts run over the tables above before each is dropped (each runs its
   suite once checked, counts set to 0 just before and read just after,
   watched for CPU ops, then once warm and three times timed, and shows
   ``unpersist()`` dropping ``torch.cuda.memory_allocated()`` by at least
   the resident bytes): ``main`` (after phase 5) — every metric equal to
   the streaming run's (exact, or within PERF.md §2's bounds), no bytes
   packed, ``status`` and ``region`` counted from resident codes by K5;
   and, inside it, ``encoded`` — two low-cardinality numeric columns made
   from the main table, encoded and persisted, bit-identical to their
   decoded twin with at most half its resident bytes; ``sketch`` (after
   phase 8) — the select (K4) in place of every sort
   (``device_select_passes`` > 0, ``device_sort_passes`` = 0), every KLL
   state bit-identical to a ``select_kernel=False`` scan of the same
   resident chunks, one K4 kernel launch a select pass, quantiles within
   the rank bound, HLL estimates equal to the streaming run's, the run's
   pieces (``host_fold_summaries`` among them), then a ``kernel_timing``
   line of K4 at the resident chunk's shape (the kernel alone and each of
   its stages, a wrapper call and its working set, its plain version,
   ``torch.sort`` of the same keys, K3 whole, the bound; the same for
   constant columns), and a ``select_shapes`` line: K4 against K3 at
   resident chunk shapes (1, 8 and 50 columns, 2^16 to 2^25 rows, k =
   2^8, 2^11 and 2^14);
   ``frequency`` (after phase 11) — Histogram's top-k and Uniqueness's
   count statistics from resident codes, equal to the streaming run's,
   Uniqueness fetching four scalars (32 bytes). Each part runs its suite
   once more with every K5 launch held against ``bincount_plain`` on the
   same ids (``bincount_vs_plain``: the shapes checked);

then the ``kernels`` summary line (each kernel's launches summed over the
paths, and by path), the nvidia-smi line, and the result line
``{"ok": true, "device": {...}}`` last. Each path runs with the launch
counts set to 0 just before it and read just after. Any failure exits
non-zero without the result line. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

#: the hand-written kernels of the port's path, each built from
#: deequ_tpu_torch/csrc/<name>.cu
KERNELS = ("bincount", "hll", "select")

# memory rate of each H100 part (NVIDIA data sheets), bytes/s
_HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hbm_rate(name: str) -> float:
    for key in ("PCIe", "NVL"):
        if key in name:
            return _HBM_RATE[key]
    return _HBM_RATE["SXM"]


def time_cuda(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# -- phase 3: kernel parity --------------------------------------------------


def zipf_ids(rng, n: int, m: int, exponent: float = 0.7):
    """n ids over [1, m) drawn with Zipf weights k^-exponent (the main
    path's customer_id exponent) by inverse transform, ranks scattered over
    the key space, 1% null (-1)."""
    import numpy as np

    u = rng.random(n)
    top = (m - 1) ** (1.0 - exponent)
    ranks = np.floor((u * (top - 1.0) + 1.0) ** (1.0 / (1.0 - exponent))).astype(np.int64)
    keys = 1 + rng.permutation(m - 1)[np.clip(ranks, 1, m - 1) - 1]
    keys[rng.random(n) < 0.01] = -1
    return keys


def kernel_parity(device) -> dict:
    """The kernel against its plain version, bit for bit: the edge cases of
    tests/test_torch_histogram.py, both sides of every regime boundary the
    rule reports, K4's 65,536-bin width, 10^7-row Zipf and single-hot-bin
    inputs in every regime that can take their width, and weights whose
    per-block partial sums leave int32 while each bin's total does not."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import (
        REGIMES,
        bincount,
        bincount_plain,
        regime,
        regime_widths,
    )

    rng = np.random.default_rng(7)
    cases = 0
    max_err = 0

    def check(seg_np, m, weights_np=None, dtype=torch.int64, regimes=(None,)):
        """bincount (regime None: the rule's, through the wrapper) or a
        launch in each named regime, against the plain version."""
        nonlocal cases, max_err
        seg = torch.from_numpy(seg_np).to(device=device, dtype=dtype)
        w = None if weights_np is None else torch.from_numpy(weights_np).to(device)
        want = bincount_plain(seg, m, weights=w)
        for name in regimes:
            if name is None:
                got = bincount(seg, m, weights=w)
            else:
                bufs = histogram_device._buffers(seg, m, w, name)
                histogram_device._launch(seg, m, w, *bufs, regime_name=name)
                got = bufs[-1]
            torch.cuda.synchronize()
            err = int((got - want).abs().max()) if m else 0
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"bincount != plain (n={len(seg_np)}, m={m}, regime={name}, "
                     f"weighted={weights_np is not None}, dtype={dtype}): max err {err}")
            cases += 1

    widths = regime_widths()

    def takers(m):
        """Every regime that can take width m (each takes any width up to
        its widest)."""
        return [r for r in REGIMES if widths[r] is None or m <= widths[r]]

    for dtype in (torch.int32, torch.int64):
        for m in (1, 7, 511, 512, 513, 4097):
            for n in (0, 1, 1023, 1024, 1025, 5000):
                # ids in [-3, m + 3): negatives and ids >= m must be dropped
                seg = rng.integers(-3, m + 3, size=n)
                check(seg, m, dtype=dtype)
                check(seg, m, rng.integers(-50, 1000, size=n).astype(np.int32), dtype)

    # both sides of every boundary of the rule, and K4's first-pass width
    boundaries = {}
    for i, name in enumerate(REGIMES):
        widest = widths[name]
        if widest is None:
            continue
        got = {widest: regime(widest), widest + 1: regime(widest + 1)}
        if got != {widest: name, widest + 1: REGIMES[i + 1]}:
            fail(f"regime boundary of {name} not at {widest}: {got}")
        boundaries[name] = widest
    for m in sorted({8, 5001, 65_536, 1_000_001, 4_194_305}
                    | {w + d for w in boundaries.values() for d in (0, 1)}):
        seg = rng.integers(-1, m + 1, size=2_000_000)
        for dtype in (torch.int32, torch.int64):
            check(seg, m, dtype=dtype)
        check(seg, m, rng.integers(-5, 100, size=len(seg)).astype(np.int32))

    # skew at 10^7 rows: Zipf and one hot bin, in every regime that can
    # take the width, int32 and int64 ids
    rows = 10_000_000
    skew_widths = (9, 5001, 65_536, 1_078_737, boundaries["partition"] + 1)
    for m in skew_widths:
        hot = np.full(rows, m // 2, dtype=np.int64)
        zipf = zipf_ids(rng, rows, m)
        for seg in (zipf, hot):
            for dtype in (torch.int32, torch.int64):
                check(seg, m, dtype=dtype, regimes=takers(m))
    check(zipf_ids(rng, rows, 65_536), 65_536)  # K4's width, by the rule

    # weights: per-block partials leave int32, each bin's total does not
    # (the second half repeats the first half's ids with negated weights),
    # and then totals past int32 (taken mod 2^32 by both)
    half = rng.integers(0, 8, size=2_000_000)
    seg = np.concatenate([half, half, rng.integers(0, 8, size=1000)])
    big = np.int32(2**30 + 12345)
    inside = np.concatenate([np.full(len(half), big, np.int32),
                             np.full(len(half), -big, np.int32),
                             rng.integers(-100, 100, size=1000).astype(np.int32)])
    totals = np.bincount(seg, weights=inside.astype(np.float64), minlength=8)
    partial = np.bincount(half, minlength=8).max() * int(big)
    if np.abs(totals).max() >= 2**31 or partial < 2**31:
        fail("weighted edge case is not at the edge")
    beyond = np.full(len(seg), big, np.int32)
    for m in (9, 5001, 65_536):
        for weights in (inside, beyond):
            check(seg, m, weights, regimes=takers(m))
    return {"cases": cases, "max_abs_err": max_err, "boundaries": boundaries,
            "skew_widths": {m: takers(m) for m in skew_widths}}


# -- phase 4: the main path ---------------------------------------------------


def make_table(rows: int, seed: int):
    """The chip-smoke schema at ``rows`` rows, from ``seed``, built from
    numpy arrays (string columns from codes plus a dictionary)."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(seed)
    cols = []
    for j in range(20):
        if j == 19:
            # a column with a large mean and unit spread: a raw
            # sum-of-squares variance would lose it
            values = 1e6 + rng.standard_normal(rows)
        elif j == 1:
            values = 0.5 * cols[0].values + rng.normal(loc=3.0, scale=2.0, size=rows)
        else:
            values = rng.normal(loc=10.0 * j + 5.0, scale=1.0 + j, size=rows)
        mask = rng.random(rows) >= 0.01
        cols.append(Column(f"f{j}", DType.FRACTIONAL, values=values, mask=mask))
    cols.append(Column("id", DType.INTEGRAL, values=rng.permutation(rows).astype(np.int64)))
    n_cust = 1_100_000
    p = np.arange(1, n_cust + 1, dtype=np.float64) ** -0.7
    ranks = rng.choice(n_cust, size=rows, p=p / p.sum())
    cust = 1000 + 3 * rng.permutation(n_cust)[ranks].astype(np.int64)
    cols.append(Column("customer_id", DType.INTEGRAL, values=cust,
                       mask=rng.random(rows) >= 0.01))
    status_p = np.array([30, 20, 15, 12, 10, 7, 4, 2], dtype=np.float64)
    status = rng.choice(8, size=rows, p=status_p / status_p.sum()).astype(np.int32)
    cols.append(Column("status", DType.STRING, codes=status,
                       dictionary=np.array([f"S{i}" for i in range(8)], dtype=object)))
    region = rng.integers(0, 5000, size=rows).astype(np.int32)
    region[rng.random(rows) < 0.005] = -1
    cols.append(Column("region", DType.STRING, codes=region,
                       dictionary=np.array([f"R{i:04d}" for i in range(5000)], dtype=object)))
    return ColumnarTable(cols)


def build_check():
    from deequ_tpu_torch import Check, CheckLevel

    check = Check(CheckLevel.ERROR, "chip smoke").has_size(lambda n: n > 0)
    check = check.is_complete("id").has_completeness("f0", lambda v: v > 0.9)
    for j in range(20):
        c = f"f{j}"
        check = (check.has_min(c, lambda v: True).has_max(c, lambda v: True)
                 .has_mean(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_standard_deviation(c, lambda v: v > 0))
    return (
        check.has_correlation("f0", "f1", lambda v: -1.0 <= v <= 1.0)
        .is_non_negative("f5", lambda v: v > 0)
        .is_contained_in("status", [f"S{i}" for i in range(7)], lambda v: v > 0.9)
        .satisfies("f3 > -20", "f3 above -20", lambda v: v > 0.5)
        .where("status = 'S1'")
        .is_unique("id")
        .has_uniqueness(["customer_id"], lambda v: 0 < v < 1)
        .has_distinctness(["status"], lambda v: v > 0)
        .has_entropy("region", lambda v: v > 0)
        .has_unique_value_ratio(["customer_id"], lambda v: 0 < v < 1)
    )


def build_suite(table):
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import CountDistinct

    return (
        VerificationSuite.on_data(table)
        .add_check(build_check())
        .add_required_analyzer(CountDistinct(["customer_id"]))
    )


def expected_metrics(table) -> dict:
    """Every metric of the suite, computed with numpy: {(name, instance): value}."""
    import numpy as np

    n = table.num_rows
    exp = {("Size", "*"): float(n)}
    exp[("Completeness", "id")] = float(table["id"].mask.sum()) / n
    exp[("Completeness", "f0")] = float(table["f0"].mask.sum()) / n
    for j in range(20):
        c = f"f{j}"
        v = table[c].values[table[c].mask]
        exp[("Minimum", c)] = float(v.min())
        exp[("Maximum", c)] = float(v.max())
        exp[("Sum", c)] = float(v.sum())
        exp[("Mean", c)] = float(v.mean())
        exp[("StandardDeviation", c)] = float(v.std())
    both = table["f0"].mask & table["f1"].mask
    x, y = table["f0"].values[both], table["f1"].values[both]
    dx, dy = x - x.mean(), y - y.mean()
    exp[("Correlation", "f0,f1")] = float(
        (dx * dy).sum() / (math.sqrt((dx * dx).sum()) * math.sqrt((dy * dy).sum()))
    )
    f5 = table["f5"]
    exp[("Compliance", "f5 is non-negative")] = float(
        (np.where(f5.mask, f5.values, 0.0) >= 0).sum()
    ) / n
    st = table["status"].codes
    exp[("Compliance", "status contained in " + ",".join(f"S{i}" for i in range(7)))] = (
        float(((st < 0) | (st < 7)).sum()) / n
    )
    where = st == 1
    f3 = table["f3"]
    exp[("Compliance", "f3 above -20")] = float(
        (where & f3.mask & (f3.values > -20)).sum()
    ) / float(where.sum())

    def count_stats(codes_or_values, valid):
        _, counts = np.unique(codes_or_values[valid], return_counts=True)
        rows = int(valid.sum())
        p = counts / rows
        return rows, len(counts), int((counts == 1).sum()), float(-(p * np.log(p)).sum())

    rows, groups, singles, _ = count_stats(table["id"].values, table["id"].mask)
    exp[("Uniqueness", "id")] = singles / rows
    cu = table["customer_id"]
    rows, groups, singles, _ = count_stats(cu.values, cu.mask)
    exp[("Uniqueness", "customer_id")] = singles / rows
    exp[("UniqueValueRatio", "customer_id")] = singles / groups
    exp[("CountDistinct", "customer_id")] = float(groups)
    rows, groups, _, _ = count_stats(st, st >= 0)
    exp[("Distinctness", "status")] = groups / rows
    rg = table["region"].codes
    _, _, _, ent = count_stats(rg, rg >= 0)
    exp[("Entropy", "region")] = ent
    return exp


#: relative bounds per metric (tests/test_torch_*.py state the same)
_EXACT = {"Size", "Completeness", "Compliance", "Minimum", "Maximum",
          "Uniqueness", "UniqueValueRatio", "Distinctness", "CountDistinct"}
_REL = {"Sum": 1e-12, "Mean": 1e-12, "Entropy": 1e-12,
        "StandardDeviation": 1e-10, "Correlation": 1e-10}


def check_metrics(result, expected: dict) -> float:
    """Every metric of the run against numpy; returns the worst relative
    error seen on the toleranced metrics."""
    got = {}
    for metric in result.metrics.values():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance)] = metric.value.get()
    if set(got) != set(expected):
        fail(f"metric sets differ: only run {set(got) - set(expected)}, "
             f"only numpy {set(expected) - set(got)}")
    worst = 0.0
    for key, want in expected.items():
        have = got[key]
        if not math.isfinite(have):
            fail(f"{key} is not finite: {have}")
        if key[0] in _EXACT:
            if have != want:
                fail(f"{key}: {have!r} != numpy {want!r}")
        else:
            rel = abs(have - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            if rel > _REL[key[0]]:
                fail(f"{key}: {have!r} vs numpy {want!r}, rel {rel:.3g} > {_REL[key[0]]}")
    return worst


def watch_cpu_ops():
    """A dispatch mode that records every torch operation computing on a
    CPU tensor. Copies between host and card (and reading a scalar back)
    are transport, not computation, and are allowed."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    transport = {
        "aten::_to_copy", "aten::copy_", "aten::_local_scalar_dense",
        "aten::lift_fresh", "aten::lift_fresh_copy", "aten::detach",
        "aten::alias", "aten::empty.memory_format", "aten::empty_strided",
    }

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cpu_ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name not in transport:
                tensors = [
                    t for t in tree_flatten((args, kwargs or {}, out))[0]
                    if isinstance(t, torch.Tensor)
                ]
                if any(t.device.type == "cpu" and t.dim() > 0 for t in tensors):
                    self.cpu_ops[name] = self.cpu_ops.get(name, 0) + 1
            return out

    return Watch()


def main_path(rows: int, seed: int, device) -> dict:
    import torch

    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_table(rows, seed)
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    expected = expected_metrics(table)
    t_numpy = time.perf_counter() - t0
    suite = build_suite(table)

    # the checked run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = 0
    hll.LAUNCHES = 0
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    if hll.LAUNCHES:
        fail(f"the main path has no sketch, yet the hll kernel launched {hll.LAUNCHES} times")
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)

    if result.device != str(device):
        fail(f"run executed on {result.device}, expected {device}")
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    if launches < 3:
        fail(f"bincount kernel launched {launches} times in run(), expected >= 3")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"fused scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")
    if stats["hist_plain_dispatches"] != 0 or stats["hist_host_dispatches"] != 0:
        fail("a dense grouping count ran off the kernel on the card path: "
             f"{stats['hist_plain_dispatches']} plain, "
             f"{stats['hist_host_dispatches']} host")
    worst = check_metrics(result, expected)

    walls = []
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    phases = phase_times(table, device)
    return {
        "phase": "main_path",
        "rows": rows,
        "columns": len(table.column_names),
        "metrics_checked": len(expected),
        "worst_rel_err": worst,
        "kernel_launches": launches,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "phase_s": phases,
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_reference_s": t_numpy,
    }, table, result


def phase_times(table, device) -> dict:
    """Host-clock seconds of the run's pieces, each ending in a fetch."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.segment import group_count_stats

    scanning = list(dict.fromkeys(
        a for a in build_check().required_analyzers()
        if isinstance(a, ScanShareableAnalyzer)
    ))
    out = {}
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0
    for cols in (["id"], ["customer_id"], ["status"], ["region"]):
        t0 = time.perf_counter()
        group_count_stats(table, cols, device)
        out[f"grouping_{cols[0]}"] = time.perf_counter() - t0
    return out


# -- phase 5: kernel timing at the main path's shapes ------------------------


def time_queued(fn, reps: int = 100) -> float:
    """Milliseconds of one ``fn(i)`` on the card, the kernel alone: CUDA
    events around ``reps`` back-to-back calls, divided by ``reps``. The
    calls are enqueued behind a spin on the card that outlasts their
    enqueueing, so the window holds the card's work and none of the host's
    (unless a call waits for the card itself, as ``torch.bincount`` does)."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if marks[0].elapsed_time(marks[1]) > enqueue_ms or cycles > 10**10:
            return marks[1].elapsed_time(marks[2]) / reps
        cycles *= 4


def profiled_ms(fn, reps: int = 10, match: str = "bincount"):
    """Device milliseconds per ``fn(i)`` as torch.profiler sees them, by
    kernel (the kernels whose name holds ``match`` and, in some regimes,
    the output's memset): each kernel's mean over the events the profiler
    kept (``events``: it may keep fewer than ``reps``), or None where the
    profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    by_kernel, events = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and (match in ev.key or ev.key.startswith("Memset")):
            name = ev.key.split("::")[-1].split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / max(ev.count, 1) / 1e3
            events[name] = events.get(name, 0) + ev.count
    if not by_kernel:
        return None
    return {"total": sum(by_kernel.values()), "by_kernel": by_kernel, "events": events,
            "launches": reps}


def bincount_shape_timing(label: str, seg, m: int, rate: float, reps: int = 100,
                          fresh_buffers: bool = True) -> dict:
    """K5 at one shape a path gave it: the kernel alone in the rule's
    regime and in every other regime that can take the width (buffers
    preallocated as the wrapper makes them, one set a launch, or one set
    reused where ``reps`` sets would not fit: the partition regime writes
    its output whole), torch.profiler's device time, one wrapper call, the
    plain version, torch.bincount, and the bound: each id read once and
    each count written once, over the card's memory rate."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import bincount, bincount_plain

    slots = torch.where(seg >= 0, seg, m).long()  # torch.bincount refuses negatives
    saved = histogram_device.LAUNCHES
    name = histogram_device.regime(m)
    regime_ms = {}
    prof_ms = None
    for other in histogram_device.REGIMES:
        try:
            bufs = [histogram_device._buffers(seg, m, None, other)
                    for _ in range(reps if fresh_buffers else 1)]
        except ValueError:
            continue  # this regime cannot take the width
        launch = lambda i: histogram_device._launch(seg, m, None, *bufs[i % len(bufs)],
                                                    regime_name=other)
        regime_ms[other] = time_queued(launch, reps)
        if other == name:
            prof_ms = profiled_ms(launch)
        del bufs
    kernel_ms = regime_ms[name]
    call_ms = time_cuda(lambda: bincount(seg, m))
    plain_ms = time_queued(lambda i: bincount_plain(seg, m), reps)
    library_ms = time_queued(lambda i: torch.bincount(slots, minlength=m + 1), reps)
    got, want = bincount(seg, m), bincount_plain(seg, m)
    histogram_device.LAUNCHES = saved  # timing launches are not the path's
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"bincount != plain at the {label} shape (n={seg.numel()}, m={m}): "
             f"max err {err}")
    bound_ms = (seg.numel() * seg.element_size() + m * 8) / rate * 1e3
    return {
        "column": label,
        "n": seg.numel(),
        "num_segments": m,
        "ids": str(seg.dtype).replace("torch.", ""),
        "regime": name,
        "kernel_ms": kernel_ms,
        "regime_ms": regime_ms,
        "profiler_ms": prof_ms if prof_ms is not None else "no device time",
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms,
        "max_abs_err": err,
    }


def kernel_timing(table, device, rate: float) -> list:
    """K5 at the three dense grouping shapes of the main path."""
    import torch

    from deequ_tpu_torch.ops.segment import _prepare_grouping

    shapes = []
    for col in ("customer_id", "region", "status"):
        prep = _prepare_grouping(table, [col], device)
        seg = torch.from_numpy(prep.keys).to(device)
        shapes.append(bincount_shape_timing(col, seg, prep.keyspace, rate))
    return shapes


def boundary_timing(device, rate: float, rows: int = 10_000_000, reps: int = 20) -> list:
    """The kernel alone on uniform ids on both sides of each boundary of
    the regime rule, in every regime that can take the width: what the
    rule's choice rests on, measured on this card."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device

    rng = np.random.default_rng(11)
    out = []
    for name, widest in histogram_device.regime_widths().items():
        if widest is None:
            continue
        for m in (widest, widest + 1):
            seg = torch.from_numpy(rng.integers(0, m, size=rows)).to(device)
            regime_ms = {}
            for other in histogram_device.REGIMES:
                try:
                    bufs = histogram_device._buffers(seg, m, None, other)
                except ValueError:
                    continue  # this regime cannot take the width
                regime_ms[other] = time_queued(
                    lambda i: histogram_device._launch(seg, m, None, *bufs, regime_name=other),
                    reps)
            out.append({"num_segments": m, "regime": histogram_device.regime(m),
                        "regime_ms": regime_ms,
                        "bound_ms": (rows * 8 + m * 8) / rate * 1e3})
    return out


# -- the HLL kernel: parity ---------------------------------------------------

#: f64 bit patterns the canonical split treats apart: ±0.0, NaNs with and
#: without payloads and signs, ±inf, the f32 maximum and just past its
#: rounding edge, ±2^128, the f64 maximum, the smallest f64 subnormal
_HLL_EDGE_BITS = (
    0x0000000000000000, 0x8000000000000000, 0x7FF8000000000000, 0xFFF8000000000000,
    0x7FF4000000000000, 0x7FF0000000000123, 0xFFFC00000000ABCD, 0x7FFFFFFFFFFFFFFF,
    0x7FF0000000000000, 0xFFF0000000000000, 0x47EFFFFFE0000000, 0x47EFFFFFF0000000,
    0x47F0000000000000, 0xC7F0000000000000, 0x7FEFFFFFFFFFFFFF, 0x0000000000000001,
)


def hll_edge_values(rng, normals: int = 5000):
    """The edge values of the HLL split: the bit patterns above, magnitudes
    whose f32 rounding is subnormal, the integer edges (±2^31, 2^31 - 1,
    2^53 + 1), and normals at several scales."""
    import numpy as np

    return np.concatenate([
        np.array(_HLL_EDGE_BITS, dtype=np.uint64).view(np.float64),
        [2.0 ** -149, -(2.0 ** -149), 2.0 ** -140 * 1.25, 1e-40, -1e-39, 2.0 ** -126 * 0.999],
        [2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1, -(2.0 ** 31) + 1, 2.0 ** 53 + 1,
         -(2.0 ** 53) - 1, 2.0 ** 24 + 1, 0.0, 1.0, -1.0],
        rng.normal(size=normals) * 1e3, rng.normal(size=normals),
        1e6 + rng.standard_normal(normals),
    ])


def hll_parity(device) -> dict:
    """The HLL kernel against its plain version on the card, bit for bit:
    the split's edge values (and the card's plain version against the
    host's there), boolean and string-LUT inputs, an all-invalid column,
    one row, sizes around a block's and the grid's rows, and 10^7 rows of
    each input mode."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import hll

    rng = np.random.default_rng(13)
    cases = 0

    def check(x_np, valid_np=None, lut_np=None):
        nonlocal cases
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(device)
        valid = None if valid_np is None else torch.from_numpy(valid_np).to(device)
        lut = None if lut_np is None else torch.from_numpy(lut_np).to(device)
        got = hll.registers(x, valid, 9, lut)
        want = hll.registers_plain(x, valid, 9, lut)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"hll kernel != plain (n={len(x_np)}, dtype={x_np.dtype}, "
                 f"masked={valid_np is not None}): "
                 f"{int((got != want).sum())} registers differ")
        cases += 1
        return got

    edges = hll_edge_values(rng)
    got = check(edges)
    if not torch.equal(got.cpu(), hll.registers_plain(torch.from_numpy(edges))):
        fail("hll registers on the card != the plain version on the host at the edges")
    check(edges, rng.random(len(edges)) >= 0.3)
    if check(edges, np.zeros(len(edges), bool)).any():
        fail("hll: an all-invalid column set a register")
    dictionary = np.array([f"R{i:04d}" for i in range(5000)], dtype=object)
    lut = hll.string_idx_rank_lut(dictionary, 9)
    codes = rng.integers(-1, 5000, 20_000).astype(np.int32)
    flags = rng.random(20_000) < 0.3
    for valid in (None, rng.random(20_000) >= 0.1):
        check(codes, valid, lut)
        check(flags, valid)
    check(edges[:1])
    check(flags[:1])
    check(codes[:1], None, lut)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    block = 512 * 4          # hll.cu: kThreads rows, kUnroll deep
    grid = 4 * sms * block   # kBlocksPerSm blocks an SM
    sizes = (511, 512, 513, block - 1, block, block + 1, grid - 1, grid, grid + 1)
    for n in sizes:
        check(np.resize(edges, n), rng.random(n) >= 0.01)
    rows = 10_000_000
    mask = rng.random(rows) >= 0.01
    check(rng.normal(size=rows) * 1e3, mask)
    check(rng.random(rows) < 0.5, mask)
    big_codes = zipf_ids(rng, rows, 5001).astype(np.int32) - 1
    check(big_codes, None, lut)
    return {"cases": cases, "max_abs_err": 0, "sizes": list(sizes), "rows": rows}


# -- the sketch path ------------------------------------------------------------


def make_sketch_table(rows: int, seed: int):
    """BASELINE.md config 3's width at ``rows`` rows: 48 float64 columns with
    1% nulls (the last with mean 1e6 and unit spread), an int64 column
    within int32 (Zipf 0.7 over ~1.1M keys, 1% null), an int64 column
    beyond int32, a boolean with 1% nulls, and ``region`` (5,000 strings,
    0.5% null)."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(seed + 1)
    cols = []
    for j in range(48):
        values = (1e6 + rng.standard_normal(rows) if j == 47
                  else rng.normal(loc=10.0 * j + 5.0, scale=1.0 + j, size=rows))
        cols.append(Column(f"q{j}", DType.FRACTIONAL, values=values,
                           mask=rng.random(rows) >= 0.01))
    keys = zipf_ids(rng, rows, 1_100_001)
    cols.append(Column("cust", DType.INTEGRAL, values=1000 + 3 * np.maximum(keys, 0),
                       mask=keys >= 0))
    cols.append(Column("wide", DType.INTEGRAL,
                       values=rng.integers(-(2 ** 40), 2 ** 40, rows)))
    cols.append(Column("flag", DType.BOOLEAN, values=rng.random(rows) < 0.3,
                       mask=rng.random(rows) >= 0.01))
    region = rng.integers(0, 5000, size=rows).astype(np.int32)
    region[rng.random(rows) < 0.005] = -1
    cols.append(Column("region", DType.STRING, codes=region,
                       dictionary=np.array([f"R{i:04d}" for i in range(5000)], dtype=object)))
    return ColumnarTable(cols)


SKETCH_QUANTILES = (0.1, 0.5, 0.9, 0.99)
SKETCH_RELATIVE_ERROR = 0.01


def sketch_columns(table):
    numeric = [c for c in table.column_names if table[c].dtype.is_numeric]
    return numeric, table.column_names


def build_sketch_check(table):
    from deequ_tpu_torch import Check, CheckLevel

    numeric, every = sketch_columns(table)
    check = Check(CheckLevel.ERROR, "sketch smoke")
    for c in numeric:
        for q in SKETCH_QUANTILES:
            check = check.has_approx_quantile(c, q, lambda v: True,
                                              relative_error=SKETCH_RELATIVE_ERROR)
    check = check.kll_sketch_satisfies("q0", lambda d: len(d.buckets) == 100)
    for c in every:
        check = check.has_approx_count_distinct(c, lambda v: v > 0)
    return check.has_correlation("q0", "q1", lambda v: -1.0 <= v <= 1.0)


def check_sketch_metrics(table, result, sorted_cols=None) -> dict:
    """Each HLL estimate within 0.2 of numpy's exact distinct count (the
    reference's own test bound) and each quantile's rank among numpy's
    valid values within relative_error * m of q * m; the KLL metric has
    its 100 buckets holding every valid row. ``sorted_cols`` keeps each
    column's sorted valid values for a later call."""
    import numpy as np

    if sorted_cols is None:
        sorted_cols = {}

    got = {}
    for analyzer, metric in result.metrics.items():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance, getattr(analyzer, "quantile", None))] = (
            metric.value.get())
    numeric, every = sketch_columns(table)
    worst_hll, worst_rank = 0.0, 0.0
    for c in every:
        if c not in sorted_cols:
            col = table[c]
            if col.dtype.value == "string":
                sorted_cols[c] = np.sort(col.codes[col.codes >= 0])
            else:
                sorted_cols[c] = np.sort(col.values[col.mask])
        s = sorted_cols[c]
        distinct = int(len(s) > 0) + int(np.count_nonzero(s[1:] != s[:-1]))
        est = got[("ApproxCountDistinct", c, None)]
        rel = abs(est - distinct) / distinct
        worst_hll = max(worst_hll, rel)
        if rel > 0.2:
            fail(f"ApproxCountDistinct({c}) = {est} vs exact {distinct}: rel {rel:.3g} > 0.2")
        if c not in numeric:
            continue
        m = len(s)
        for q in SKETCH_QUANTILES:
            v = got[("ApproxQuantile", c, q)]
            lo, hi = np.searchsorted(s, v, "left"), np.searchsorted(s, v, "right")
            target = q * m
            err = 0.0 if lo <= target <= hi else min(abs(lo - target), abs(hi - target)) / m
            worst_rank = max(worst_rank, err)
            if err > SKETCH_RELATIVE_ERROR:
                fail(f"ApproxQuantile({c}, {q}) = {v}: rank error {err:.4g} > "
                     f"{SKETCH_RELATIVE_ERROR}")
        if c == "q0":
            dist = got[("KLL", "q0", None)]
            if sum(b.count for b in dist.buckets) != m or len(dist.buckets) != 100:
                fail("KLLSketch(q0): buckets do not hold every valid row")
    corr = got[("Correlation", "q0,q1", None)]
    if not -1.0 <= corr <= 1.0:
        fail(f"Correlation(q0, q1) = {corr}")
    return {"worst_hll_rel_err": worst_hll, "worst_quantile_rank_err": worst_rank,
            "metrics_checked": len(got)}


def registers_against_plain(table, device, result) -> int:
    """Every column's registers from the fused scan against the plain
    version run on the same device tensors, chunk by chunk, folded by max;
    the estimate of the folded plain registers equals the checked run's
    metric. Returns the columns checked."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.ops import hll
    from deequ_tpu_torch.ops.scan_engine import (
        _auto_chunk_rows,
        _ChunkPacker,
        _device_luts,
        run_scan,
    )

    _, every = sketch_columns(table)
    analyzers = [ApproxCountDistinct(c) for c in every]
    ops = [a.scan_op(table) for a in analyzers]
    scanned = run_scan(table, ops, device)
    cols = {c: table[c] for c in sorted(every)}
    chunk = min(_auto_chunk_rows(cols), table.num_rows)
    packer = _ChunkPacker(cols)
    luts = _device_luts(ops, cols, device)
    folded = {c: torch.zeros(512, dtype=torch.int32, device=device) for c in every}
    for start in range(0, table.num_rows, chunk):
        stop = min(start + chunk, table.num_rows)
        planes = packer.to_device(packer.pack(start, stop), device)
        row_valid = torch.ones(stop - start, dtype=torch.bool, device=device)
        vals = packer.unpack_vals(*planes, row_valid, luts)
        for c in every:
            v = vals[c]
            lut = v.lut("hll_ir_p9") if v.kind == "str" else None
            valid = None if v.kind == "str" or v.mask is row_valid else v.mask
            kernel = hll.registers(v.data, valid, 9, lut)
            plain = hll.registers_plain(v.data, valid, 9, lut)
            if not torch.equal(kernel, plain):
                fail(f"hll registers of {c}, rows {start}:{stop}: kernel != plain")
            folded[c] = torch.maximum(folded[c], plain)
    metrics = {m.instance: m.value.get() for m in result.metrics.values()
               if m.name == "ApproxCountDistinct"}
    for c, res in zip(every, scanned):
        plain = folded[c].cpu().numpy()
        if not np.array_equal(np.asarray(res["registers"]).astype(np.int32), plain):
            fail(f"hll registers of {c} from the fused scan != the plain version's")
        if hll.estimate_cardinality(plain) != metrics[c]:
            fail(f"ApproxCountDistinct({c}) of the run != the plain registers' estimate")
    return len(every)


def kll_states_card_vs_cpu(table, device, rows: int = 1_000_000) -> dict:
    """A rows-row slice of four columns: the KLL states the card builds
    (one batched op of four columns, and one k = 2048 single-column op)
    equal the port's CPU states bit for bit."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxQuantile, KLLSketch
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.table import Column, ColumnarTable
    from deequ_tpu_torch.ops.scan_engine import run_scan

    names = ("q0", "q47", "cust", "wide")
    rows = min(rows, table.num_rows)
    sub = ColumnarTable([
        Column(c, table[c].dtype, values=table[c].values[:rows], mask=table[c].mask[:rows])
        for c in names
    ])
    analyzers = [ApproxQuantile(c, 0.5) for c in names] + [KLLSketch("q0")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(sub) for a in analyzers])
    states = {}
    for dev in (device, torch.device("cpu")):
        results = run_scan(sub, exec_ops, dev)
        states[str(dev)] = [
            a.state_from_scan_result(ex(results[i]) if ex else results[i])
            for a, (i, ex) in zip(analyzers, plan)
        ]
    for a, card, cpu in zip(analyzers, states[str(device)], states["cpu"]):
        same = (
            (card.global_min, card.global_max) == (cpu.global_min, cpu.global_max)
            and (card.sketch.count, card.sketch.rng_count) == (cpu.sketch.count,
                                                               cpu.sketch.rng_count)
            and len(card.sketch.compactors) == len(cpu.sketch.compactors)
            and all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
                    for x, y in zip(card.sketch.compactors, cpu.sketch.compactors))
        )
        if not same:
            fail(f"KLL state of {a!r} on the card != on the CPU")
    return {"rows": rows, "columns": list(names), "states": len(analyzers)}


def sketch_pieces(table, device, check) -> dict:
    """Host-clock seconds of the sketch run's pieces: the fused scan, the
    batched sort (the coalesced op's sort and summary of one full chunk's
    (50, rows) stack, once per chunk), the host fold of every KLL
    analyzer's summaries, and the string LUT build."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.analyzers.sketches import _sketch_size_for_error
    from deequ_tpu_torch.ops import hll
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched
    from deequ_tpu_torch.ops.scan_engine import _auto_chunk_rows, run_scan

    scanning = list(dict.fromkeys(
        a for a in check.required_analyzers() if isinstance(a, ScanShareableAnalyzer)))
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0

    numeric, every = sketch_columns(table)
    chunk = min(_auto_chunk_rows({c: table[c] for c in every}), table.num_rows)
    chunks = -(-table.num_rows // chunk)
    X = torch.stack([torch.from_numpy(table[c].values[:chunk].astype(np.float64))
                     for c in numeric]).to(device)
    M = torch.stack([torch.from_numpy(table[c].mask[:chunk]) for c in numeric]).to(device)
    k = _sketch_size_for_error(SKETCH_RELATIVE_ERROR)
    chunk_summary_batched(X, M, k, chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        chunk_summary_batched(X, M, k, chunk)
    torch.cuda.synchronize()
    out["batched_sort"] = time.perf_counter() - t0
    del X, M

    kll = [a for a in scanning if type(a).__name__ in ("ApproxQuantile", "KLLSketch")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    results = run_scan(table, exec_ops, device)
    t0 = time.perf_counter()
    for a, (i, ex) in zip(kll, plan):
        a.state_from_scan_result(ex(results[i]) if ex else results[i])
    out["host_fold_summaries"] = time.perf_counter() - t0
    out["kll_analyzers_folded"] = len(kll)

    t0 = time.perf_counter()
    hll.string_idx_rank_lut(table["region"].dictionary, 9)
    out["string_lut_build"] = time.perf_counter() - t0
    return out


def sketch_path(rows: int, seed: int, device) -> tuple:
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_sketch_table(rows, seed)
    t_table = time.perf_counter() - t0
    check = build_sketch_check(table)
    suite = VerificationSuite.on_data(table).add_check(check)
    numeric, every = sketch_columns(table)

    # the checked run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    hll.LAUNCHES = 0
    histogram_device.LAUNCHES = 0
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = {"hll": hll.LAUNCHES, "bincount": histogram_device.LAUNCHES}
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)

    chunks = stats["chunks_processed"]
    if result.device != str(device):
        fail(f"sketch run executed on {result.device}, expected {device}")
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"sketch scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")
    if launches["hll"] != len(every) * chunks:
        fail(f"hll kernel launched {launches['hll']} times, want "
             f"{len(every)} columns x {chunks} chunks")
    # per chunk: one batched sort of the 50 quantile columns, one KLLSketch
    if (stats["kll_sort_passes"], stats["kll_sorted_columns"]) != (
            2 * chunks, (len(numeric) + 1) * chunks):
        fail(f"KLL sorts: {stats['kll_sort_passes']} passes over "
             f"{stats['kll_sorted_columns']} columns in {chunks} chunks, want one batched "
             f"sort of {len(numeric)} columns and one of KLLSketch's a chunk")
    t0 = time.perf_counter()
    sorted_cols = {}
    checked = check_sketch_metrics(table, result, sorted_cols)
    t_numpy = time.perf_counter() - t0

    walls = []
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pieces = sketch_pieces(table, device, check)
    registers_checked = registers_against_plain(table, device, result)
    kll_card_cpu = kll_states_card_vs_cpu(table, device)
    return {
        "phase": "sketch_path",
        "rows": rows,
        "reduced": {"rows": "BASELINE.md config 3's 10^8 rows cut to 10^7 for the "
                            "script's time limit"},
        "columns": len(every),
        "quantile_columns": len(numeric),
        "analyzers": len(result.metrics),
        "chunks": chunks,
        "kernel_launches": launches,
        "scan_stats": stats,
        **checked,
        "registers_equal_plain_columns": registers_checked,
        "kll_card_equals_cpu": kll_card_cpu,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "piece_s": pieces,
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_check_s": t_numpy,
    }, table, {"result": result, "sorted": sorted_cols}


def hll_timing(table, device, rate: float, launches: int) -> dict:
    """The HLL kernel at the sketch table's shape: 10^7 rows of one f64
    column with a mask. The kernel alone (100 launches queued behind a
    device spin into preallocated zeroed registers, CUDA events), one
    wrapper call, the plain version, and scatter_reduce_ amax over
    precomputed (idx, rank) — the one PyTorch call for the fold; no single
    call hashes too."""
    import torch

    from deequ_tpu_torch.ops import hll

    reps = 100
    col = table["q0"]
    x = torch.from_numpy(col.values).to(device)
    valid = torch.from_numpy(col.mask).to(device)
    saved = hll.LAUNCHES
    bufs = [torch.zeros(512, dtype=torch.int32, device=device) for _ in range(reps)]
    launch = lambda i: hll._launch(x, valid, 9, None, bufs[i % reps])
    kernel_ms = time_queued(launch, reps)
    prof = profiled_ms(launch, match="hll")
    call_ms = time_cuda(lambda: hll.registers(x, valid))
    plain_ms = time_queued(lambda i: hll.registers_plain(x, valid), 20)
    idx, rank, _ = hll.idx_rank(x, 9)
    rank = torch.where(valid, rank, 0)
    library_ms = time_queued(
        lambda i: torch.zeros(512, dtype=torch.int64, device=device).scatter_reduce_(
            0, idx, rank, "amax"), reps)
    got, want = hll.registers(x, valid), hll.registers_plain(x, valid)
    hll.LAUNCHES = saved  # timing launches are not the path's
    if not torch.equal(got, want):
        fail("hll kernel != plain at the sketch table's shape")
    nbytes = x.numel() * 8 + valid.numel() + 512 * 4
    bound_ms = nbytes / rate * 1e3
    return {
        "column": "q0",
        "n": x.numel(),
        "masked": True,
        "kernel_ms": kernel_ms,
        "profiler_ms": prof if prof is not None else "no device time",
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "scatter_reduce_(amax) over precomputed (idx, rank): the fold "
                        "alone; no single PyTorch call hashes too",
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_share": bound_ms / kernel_ms,
        "launches_in_sketch_path": launches,
        "max_abs_err": 0,
    }



# -- the check-method path: frequency tables and string analyzers ------------


def _stringify(value) -> str:
    """A group value as the Histogram metric labels it (null: NullValue)."""
    if value is None:
        return "NullValue"
    if isinstance(value, float) and value.is_integer():
        return f"{value:.1f}"
    return str(value)


def numpy_histogram(slot_counts, label, k: int, n: int):
    """The Histogram metric by numpy: slot_counts over slots (slot 0 =
    null), the top k by count, the lower slot first on equal counts;
    ({label: (count, ratio)}, number_of_bins)."""
    import numpy as np

    order = np.argsort(-slot_counts, kind="stable")[:k]
    return ({label(int(i)): (int(slot_counts[i]), int(slot_counts[i]) / n)
             for i in order if slot_counts[i] > 0},
            int((slot_counts > 0).sum()))


def distribution_of(metric):
    if not metric.value.is_success:
        fail(f"metric failed: {metric}")
    dist = metric.value.get()
    return ({k: (v.absolute, v.ratio) for k, v in dist.values.items()},
            dist.number_of_bins)


def numpy_mutual_information(a, a_valid, b, b_valid) -> float:
    """MI by numpy with the reference's rule: the rows with either value
    present are the total, the marginals count those rows, the joint only
    the rows with both."""
    import numpy as np

    rows = a_valid | b_valid
    total = int(rows.sum())
    _, ai = np.unique(np.where(a_valid, a, a[a_valid][0]), return_inverse=True)
    _, bi = np.unique(np.where(b_valid, b, b[b_valid][0]), return_inverse=True)
    both = a_valid & b_valid
    ma = np.bincount(ai[a_valid & rows]).astype(np.float64)
    mb = np.bincount(bi[b_valid & rows]).astype(np.float64)
    pair = ai[both].astype(np.int64) * (int(bi.max()) + 1) + bi[both]
    keys, joint = np.unique(pair, return_counts=True)
    ka, kb = keys // (int(bi.max()) + 1), keys % (int(bi.max()) + 1)
    pxy = joint / total
    return float(np.sum(pxy * np.log(pxy / ((ma[ka] / total) * (mb[kb] / total)))))


def build_check_api(table):
    from deequ_tpu_torch import Check, CheckLevel, ConstrainableDataTypes

    yes = lambda v: True  # noqa: E731 — the metrics are checked against numpy
    return (
        Check(CheckLevel.ERROR, "check api")
        .has_histogram_values("status", yes)
        .has_number_of_distinct_values("region", yes, binning_udf=lambda s: s[:3])
        .has_mutual_information("status", "region", yes)
        .has_mutual_information("customer_id", "status", yes)
        .has_min_length("region", yes)
        .has_max_length("region", yes)
        .has_pattern("region", r"^R00\d\d$", yes)
        .contains_email("region", yes)
        .has_data_type("status", ConstrainableDataTypes.STRING, yes)
        .has_histogram_values("f0", yes)
    )


def expected_check_api(table) -> dict:
    """Every metric of the check-method path by numpy: {(name, instance,
    histogram binned?): value}."""
    import numpy as np

    n = table.num_rows
    st, rg = table["status"].codes, table["region"].codes
    status_dict, region_dict = table["status"].dictionary, table["region"].dictionary
    exp = {}
    counts = np.bincount(st + 1, minlength=len(status_dict) + 1)
    exp[("Histogram", "status", False)] = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else status_dict[i - 1], 1000, n)
    labels = np.array([s[:3] for s in region_dict])
    uniq, inv = np.unique(labels, return_inverse=True)
    binned = np.where(rg >= 0, inv[np.maximum(rg, 0)] + 1, 0)
    counts = np.bincount(binned, minlength=len(uniq) + 1)
    exp[("Histogram", "region", True)] = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else str(uniq[i - 1]), 1000, n)
    exp[("MutualInformation", "status,region", None)] = numpy_mutual_information(
        st, st >= 0, rg, rg >= 0)
    cu = table["customer_id"]
    exp[("MutualInformation", "customer_id,status", None)] = numpy_mutual_information(
        cu.values, cu.mask, st, st >= 0)
    lengths = np.array([len(s) for s in region_dict])[rg[rg >= 0]]
    exp[("MinLength", "region", None)] = float(lengths.min())
    exp[("MaxLength", "region", None)] = float(lengths.max())
    exp[("PatternMatch", "region", "R00")] = float(((rg >= 0) & (rg < 100)).sum()) / n
    exp[("PatternMatch", "region", "email")] = 0.0
    exp[("DataType", "status", None)] = (
        {"Unknown": (int((st < 0).sum()), float((st < 0).sum()) / n),
         "Fractional": (0, 0.0), "Integral": (0, 0.0), "Boolean": (0, 0.0),
         "String": (int((st >= 0).sum()), float((st >= 0).sum()) / n)}, 5)
    f0 = table["f0"]
    uniq, counts = np.unique(f0.values[f0.mask], return_counts=True)
    counts = np.concatenate([[int((~f0.mask).sum())], counts])
    exp[("Histogram", "f0", False)] = numpy_histogram(
        counts, lambda i: _stringify(None if i == 0 else float(uniq[i - 1])), 1000, n)
    return exp


def check_api_path(table, device) -> dict:
    """A second run() over the main path's table holding the check methods
    of the frequency tables and the string analyzers; every metric against
    numpy: exact for counts, bins, lengths and fractions, relative 1e-12
    for MutualInformation."""
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops import histogram_device, hll, lut_cache
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    expected = expected_check_api(table)
    t_numpy = time.perf_counter() - t0
    suite = VerificationSuite.on_data(table).add_check(build_check_api(table))

    SCAN_STATS.reset()
    histogram_device.LAUNCHES = 0
    hll.LAUNCHES = 0
    builds = lut_cache.BUILDS
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    stats = SCAN_STATS.snapshot()
    builds = lut_cache.BUILDS - builds
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    # Histogram(status), the binned Histogram(region), the dense
    # MI(status, region) and Histogram(f0) count on K5; MI(customer_id,
    # status) has 9.7M slots, so it takes the sparse device route
    if launches != 4 or stats["hist_kernel_dispatches"] != 4:
        fail(f"check api path: {launches} bincount launches, "
             f"{stats['hist_kernel_dispatches']} kernel dispatches (want 4 and 4)")
    if hll.LAUNCHES or stats["hist_plain_dispatches"] or stats["hist_host_dispatches"]:
        fail(f"check api path: unexpected routes {stats}")
    if stats["scan_passes"] != 1 or stats["last_scan_fetches"] != 1:
        fail(f"check api scan: {stats['scan_passes']} passes, "
             f"{stats['last_scan_fetches']} fetches (want 1 and 1)")

    worst_mi = 0.0
    checked = 0
    for analyzer, metric in result.metrics.items():
        name = type(analyzer).__name__
        if name == "Histogram":
            key = (name, metric.instance, analyzer.binning_udf is not None)
            if distribution_of(metric) != expected[key]:
                fail(f"{analyzer!r}: the Distribution differs from numpy's")
        elif name == "DataType":
            if distribution_of(metric) != expected[(name, metric.instance, None)]:
                fail(f"{analyzer!r}: the Distribution differs from numpy's")
        else:
            if not metric.value.is_success:
                fail(f"metric failed: {metric}")
            have = metric.value.get()
            tag = None
            if name == "PatternMatch":
                tag = "R00" if analyzer.pattern.startswith("^R00") else "email"
            want = expected[(name, metric.instance, tag)]
            if name == "MutualInformation":
                rel = abs(have - want) / abs(want)
                worst_mi = max(worst_mi, rel)
                if rel > 1e-12:
                    fail(f"{analyzer!r}: {have!r} vs numpy {want!r}, rel {rel:.3g}")
            elif have != want:
                fail(f"{analyzer!r}: {have!r} != numpy {want!r}")
        checked += 1
    if checked != len(expected):
        fail(f"check api path: {checked} metrics, numpy has {len(expected)}")

    walls = []
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {
        "phase": "check_api_path",
        "rows": table.num_rows,
        "metrics_checked": checked,
        "worst_mi_rel_err": worst_mi,
        "kernel_launches": launches,
        "lut_builds": builds,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "numpy_reference_s": t_numpy,
    }


# -- the frequency path: BASELINE config 4 -----------------------------------


def make_config4_table(rows: int, seed: int):
    """BASELINE config 4 (benchmarks/run_configs.py:config4) at ``rows``
    rows: one dictionary-encoded string column ``key`` of rows // 3
    distinct labels ``id_{i:09d}``, uniform int32 codes."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(43 + seed)
    cardinality = max(rows // 3, 1)
    codes = rng.integers(0, cardinality, rows).astype(np.int32)
    dictionary = np.array([f"id_{i:09d}" for i in range(cardinality)], dtype=object)
    return ColumnarTable([Column("key", DType.STRING, codes=codes, dictionary=dictionary)])


def build_config4_check():
    from deequ_tpu_torch import Check, CheckLevel

    yes = lambda v: True  # noqa: E731 — the metrics are checked against numpy
    return (
        Check(CheckLevel.ERROR, "config 4")
        .has_approx_count_distinct("key", yes)
        .has_histogram_values("key", yes, max_bins=1000)
        .has_uniqueness(["key"], yes)
    )


def frequency_pieces(table, device) -> dict:
    """Host-clock seconds of the config 4 run's pieces, each ending in a
    synchronisation: the Histogram's key codes on the host, their copy to
    the card, K5 over card + 1 slots, the packed-key top-k and its fetch,
    the host decode and stringify of the top 1,000; Uniqueness's count;
    the fused scan of ApproxCountDistinct (its LUT memoized); and the
    string LUT built cold (xxHash64 of every label, native)."""
    import numpy as np
    import torch

    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.analyzers.grouping import _stringify as label
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops import histogram_device, hll
    from deequ_tpu_torch.ops.scan_engine import fetch
    from deequ_tpu_torch.ops.segment import _packed_topk, _unpack_topk, group_count_stats

    col = table["key"]
    m = len(col.dictionary) + 1
    out = {}
    saved = histogram_device.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = col.codes + np.int32(1)
    out["key_codes_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = torch.from_numpy(codes).to(device)
    torch.cuda.synchronize()
    out["h2d_copy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = histogram_device.bincount(seg, m)
    torch.cuda.synchronize()
    out["k5_call"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys, groups = _packed_topk(counts, 1000)
    groups, keys = fetch(groups, keys)
    out["topk_and_fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slots, cnts = _unpack_topk(keys)
    _ = {label(col.dictionary[i - 1]): int(c) for i, c in zip(slots.tolist(), cnts.tolist())}
    out["host_decode_stringify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    group_count_stats(table, ["key"], device)
    out["uniqueness_count_stats"] = time.perf_counter() - t0
    histogram_device.LAUNCHES = saved
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, [ApproxCountDistinct("key")], device)
    torch.cuda.synchronize()
    out["fused_scan_acd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll.string_idx_rank_lut(col.dictionary, 9)
    out["string_lut_build_cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll.hash_strings_plain(col.dictionary[:100_000])
    out["string_hash_plain_python_1e5"] = time.perf_counter() - t0
    return out


def frequency_path(rows: int, seed: int, device) -> dict:
    """A run() at BASELINE config 4 (ApproxCountDistinct, Histogram with
    1,000 detail bins and Uniqueness over one n/3-cardinality string
    column); every metric against numpy, one K5 launch a count, no torch
    op on a CPU tensor, no LUT built by a second run, and the card's
    Distribution equal to the CPU's over a 10^6-row slice."""
    import numpy as np
    import torch

    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
    from deequ_tpu_torch.ops import histogram_device, hll, lut_cache
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    t0 = time.perf_counter()
    table = make_config4_table(rows, seed)
    t_table = time.perf_counter() - t0
    col = table["key"]
    t0 = time.perf_counter()
    counts = np.bincount(col.codes + 1, minlength=len(col.dictionary) + 1)
    want_hist = numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else col.dictionary[i - 1], 1000, rows)
    distinct = int((counts > 0).sum())
    want_unique = float((counts == 1).sum()) / rows
    t_numpy = time.perf_counter() - t0
    suite = VerificationSuite.on_data(table).add_check(build_config4_check())

    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = 0
    hll.LAUNCHES = 0
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if watch.cpu_ops:
        fail(f"torch operations computed on CPU tensors during run(): {watch.cpu_ops}")
    if launches != 2 or stats["hist_kernel_dispatches"] != 2:
        fail(f"config 4: {launches} bincount launches, {stats['hist_kernel_dispatches']} "
             "kernel dispatches (want one each for the top-k and Uniqueness counts)")
    if hll.LAUNCHES != stats["chunks_processed"]:
        fail(f"config 4: {hll.LAUNCHES} hll launches over {stats['chunks_processed']} chunks")
    got = {m.name: (a, m) for a, m in result.metrics.items()}
    if distribution_of(got["Histogram"][1]) != want_hist:
        fail("config 4: the Histogram's Distribution differs from numpy's")
    if got["Uniqueness"][1].value.get() != want_unique:
        fail(f"config 4: Uniqueness {got['Uniqueness'][1].value.get()} != {want_unique}")
    est = got["ApproxCountDistinct"][1].value.get()
    hll_rel = abs(est - distinct) / distinct
    if hll_rel > 0.15:
        fail(f"config 4: ApproxCountDistinct {est} vs exact {distinct}: rel {hll_rel:.3g}")
    boundary = sorted(want_hist[0].values())[0][0]
    tied = int((counts[1:] == boundary).sum())

    walls = []
    builds = lut_cache.BUILDS
    for _ in range(4):  # one warm run, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if lut_cache.BUILDS != builds:
        fail(f"config 4: a second run() built {lut_cache.BUILDS - builds} lookup tables")

    # the card's Distribution against the port's own CPU run, 10^6 rows
    cut = min(rows, 1_000_000)
    sub = ColumnarTable([Column("key", DType.STRING, codes=col.codes[:cut],
                                dictionary=col.dictionary)])
    hist = Histogram("key")
    card, cpu = (distribution_of(AnalysisRunner.do_analysis_run(sub, [hist], d).metric(hist))
                 for d in (device, "cpu"))
    if card != cpu:
        fail("config 4: the card's Distribution over 10^6 rows != the CPU's")
    return {
        "phase": "frequency_path",
        "rows": rows,
        "cardinality": len(col.dictionary),
        "reduced": {"rows": "BASELINE config 4's 10^8 rows cut to 10^7 for the "
                            "script's time limit"},
        "kernel_launches": launches,
        "hll_launches": stats["chunks_processed"],
        "number_of_bins": want_hist[1],
        "boundary_count": boundary,
        "groups_tied_at_boundary": tied,
        "hll_rel_err": hll_rel,
        "uniqueness": want_unique,
        "second_run_lut_builds": 0,
        "card_equals_cpu_rows": cut,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "piece_s": frequency_pieces(table, device),
        "peak_device_bytes": peak,
        "table_build_s": t_table,
        "numpy_reference_s": t_numpy,
    }, table, result


def config4_timing(table, device, rate: float, full_rows: int = 100_000_000) -> dict:
    """K5 and the packed-key top-k at the shapes of the frequency path
    (the Histogram's int32 codes and Uniqueness's int64 keys over card + 1
    slots), and at config 4's own width: 10^8 uniform ids over
    10^8 // 3 + 1 slots, made on the card."""
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.segment import _packed_topk, _prepare_grouping

    col = table["key"]
    m = len(col.dictionary) + 1
    shapes = [bincount_shape_timing(
        "key (top-k)", torch.from_numpy(col.codes + 1).to(device), m, rate)]
    prep = _prepare_grouping(table, ["key"], device)
    shapes.append(bincount_shape_timing(
        "key (Uniqueness)", torch.from_numpy(prep.keys).to(device), prep.keyspace, rate))
    full_m = full_rows // 3 + 1
    gen = torch.Generator(device=device).manual_seed(7)
    seg = torch.randint(1, full_m, (full_rows,), dtype=torch.int32, device=device,
                        generator=gen)
    shapes.append(bincount_shape_timing(
        "config 4 width", seg, full_m, rate, reps=20, fresh_buffers=False))

    topk = []
    saved = histogram_device.LAUNCHES
    for label, s, width in (("key", torch.from_numpy(col.codes + 1).to(device), m),
                            ("config 4 width", seg, full_m)):
        counts = histogram_device.bincount(s, width)
        ms = time_queued(lambda i: _packed_topk(counts, 1000), 20)
        sort_ms = time_queued(lambda i: torch.sort(counts, descending=True, stable=True), 20)
        keys, _ = _packed_topk(counts, 1000)
        want = torch.sort(counts, descending=True, stable=True).indices[:1000]
        got = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
        if not torch.equal(got, want):
            fail(f"packed top-k at {label} != a stable descending sort's first 1,000")
        # the function reads the counts once; its 1,000 keys out are noise
        bound_ms = width * 8 / rate * 1e3
        topk.append({"column": label, "num_segments": width, "k": 1000, "ms": ms,
                     "stable_sort_ms": sort_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "bound_share": bound_ms / ms})
    histogram_device.LAUNCHES = saved
    return {"bincount": shapes, "packed_topk": topk}


# -- the resident path: persist(), resident grouping, K4, encoded columns ----


class ResidentSpy:
    """Counts the grouping counts taken from resident codes
    (``segment._resident_string_bincount`` returning a tensor) while
    active."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from deequ_tpu_torch.ops import segment

        self._orig = segment._resident_string_bincount

        def spy(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            self.calls += out is not None
            return out

        segment._resident_string_bincount = spy
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import segment

        segment._resident_string_bincount = self._orig


class PlainCheck:
    """While active, every K5 launch of the resident consumers (the
    resident counts in ``segment``; K4 launches its own kernel) is held
    against ``bincount_plain`` on the same ids with ``torch.equal``; a
    mismatch fails. ``shapes`` lists what was checked: ids, bins, calls and
    the least and most ids inside the bins (the rest are dropped)."""

    def __init__(self, label: str):
        self.label = label
        self.seen = {}

    def __enter__(self):
        from deequ_tpu_torch.ops import histogram_device, segment

        self._orig = histogram_device.bincount

        def checked(seg, num_segments, *args, **kwargs):
            import torch

            out = self._orig(seg, num_segments, *args, **kwargs)
            want = histogram_device.bincount_plain(seg, num_segments, *args, **kwargs)
            if not torch.equal(out, want):
                fail(f"{self.label}: K5 != bincount_plain at {seg.numel()} ids, "
                     f"{num_segments} bins")
            if seg.numel() == 0 or num_segments == 0:
                return out  # the wrapper launches nothing
            inside = int(want.sum())
            key = (seg.numel(), int(num_segments))
            lo, hi, calls = self.seen.get(key, (inside, inside, 0))
            self.seen[key] = (min(lo, inside), max(hi, inside), calls + 1)
            return out

        segment.bincount = checked
        return self

    def __exit__(self, *exc):
        from deequ_tpu_torch.ops import segment

        segment.bincount = self._orig

    @property
    def shapes(self) -> list:
        return [{"ids": ids, "bins": bins, "calls": calls,
                 "ids_in_range_min": lo, "ids_in_range_max": hi}
                for (ids, bins), (lo, hi, calls) in sorted(self.seen.items())]


def metric_values(result) -> dict:
    """{(name, instance, quantile): value} of a run; a failed metric fails."""
    got = {}
    for analyzer, metric in result.metrics.items():
        if not metric.value.is_success:
            fail(f"metric failed: {metric}")
        got[(metric.name, metric.instance, getattr(analyzer, "quantile", None))] = (
            metric.value.get())
    return got


def resident_runs(suite, table, device, label: str) -> dict:
    """The checked run of ``suite`` over the persisted ``table`` (counts
    set to 0 just before, read just after, watched for CPU ops), then one
    warm and three timed runs. Fails unless the runs read the resident
    chunks and packed nothing."""
    import torch

    from deequ_tpu_torch.ops import histogram_device, hll, select_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    torch.cuda.reset_peak_memory_stats(device)
    SCAN_STATS.reset()
    histogram_device.LAUNCHES = 0
    hll.LAUNCHES = 0
    select_device.LAUNCHES = 0
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch, ResidentSpy() as spy:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = {"bincount": histogram_device.LAUNCHES, "hll": hll.LAUNCHES,
                "select": select_device.LAUNCHES}
    stats = SCAN_STATS.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    if watch.cpu_ops:
        fail(f"{label}: torch operations computed on CPU tensors: {watch.cpu_ops}")
    if stats["resident_passes"] != stats["scan_passes"] or stats["bytes_packed"] != 0:
        fail(f"{label}: {stats['resident_passes']} of {stats['scan_passes']} scans "
             f"resident, {stats['bytes_packed']} bytes packed (want all and 0)")
    walls = []
    with ResidentSpy() as later:
        for _ in range(4):  # one warm run, then three timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            suite.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    if later.calls != 4 * spy.calls:
        fail(f"{label}: later runs took {later.calls} resident counts, want 4 x {spy.calls}")
    with PlainCheck(label) as plain:  # every K5 launch of a further run against plain
        suite.run()
    checked = sum(s["calls"] for s in plain.shapes)
    if checked != launches["bincount"]:
        fail(f"{label}: {checked} K5 launches held against plain, the run made "
             f"{launches['bincount']}")
    return {
        "result": result,
        "kernel_launches": launches,
        "bincount_vs_plain": plain.shapes,
        "resident_string_counts": spy.calls,
        "scan_stats": stats,
        "first_run_s_watched": t_first,
        "warm_run_s": walls[0],
        "run_wall_s_median_of_3": statistics.median(walls[1:]),
        "run_wall_s": walls[1:],
        "peak_device_bytes": peak,
    }


def compare_runs(streamed: dict, resident: dict, label: str) -> float:
    """Every metric of a resident run against the streaming run's: exact
    where PERF.md §2 says exact, within its relative bound elsewhere
    (the runs cut chunks differently). Returns the worst relative error."""
    if set(streamed) != set(resident):
        fail(f"{label}: metric sets differ")
    worst = 0.0
    for key, want in streamed.items():
        have = resident[key]
        if key[0] in _REL:
            rel = abs(have - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            if rel > _REL[key[0]]:
                fail(f"{label}: {key} resident {have!r} vs streamed {want!r}, "
                     f"rel {rel:.3g} > {_REL[key[0]]}")
        elif have != want:
            fail(f"{label}: {key} resident {have!r} != streamed {want!r}")
    return worst


def persist_timed(table, device, **kwargs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table.persist(device, **kwargs)
    return table._device_cache, time.perf_counter() - t0


def unpersist_frees(table, device, label: str) -> dict:
    """unpersist() must drop torch.cuda.memory_allocated() by at least the
    resident bytes."""
    import torch

    from deequ_tpu_torch.ops.scan_engine import total_resident_bytes

    nbytes = table._device_cache.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    table.unpersist()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated(device)
    if freed < nbytes or table.is_persisted or total_resident_bytes() != 0:
        fail(f"{label}: unpersist() freed {freed} bytes of {nbytes} resident")
    return {"resident_bytes": nbytes, "freed_bytes": freed}


def make_encoded_table(table, encode: bool):
    """Two low-cardinality numeric columns made from the main table's
    (customer_id mod 1,000 with its nulls; f5 rounded to 0.1, about 600
    values) beside status, encoded or not."""
    import numpy as np

    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    cu, f5 = table["customer_id"], table["f5"]
    out = ColumnarTable([
        Column("cbucket", DType.INTEGRAL, values=cu.values % 1000, mask=cu.mask),
        Column("f5r", DType.FRACTIONAL, values=np.round(f5.values, 1), mask=f5.mask),
        table["status"],
    ])
    if encode and out.encode(["cbucket", "f5r"])["cbucket"].encoding is None:
        fail("encoded: cbucket did not take an encoding")
    return out


def build_encoded_check():
    from deequ_tpu_torch import Check, CheckLevel

    yes = lambda v: True  # noqa: E731 — compared bit for bit between two runs
    check = Check(CheckLevel.ERROR, "encoded")
    for c in ("cbucket", "f5r"):
        check = (check.has_min(c, yes).has_max(c, yes).has_mean(c, yes).has_sum(c, yes)
                 .has_standard_deviation(c, yes).has_completeness(c, yes)
                 .has_approx_quantile(c, 0.5, yes).has_approx_count_distinct(c, yes))
    return (check.has_correlation("f5r", "cbucket", yes).satisfies("f5r > 55", "f5r above 55", yes)
            .has_uniqueness(["cbucket"], yes).has_entropy("status", yes))


def resident_main(table, device, streamed_result, streamed_report) -> dict:
    """(a) the main path over its persisted table and (d) encoded columns."""
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    cache, persist_s = persist_timed(table, device)
    n_chunks = len(cache.device_chunks)
    runs = resident_runs(build_suite(table), table, device, "resident main")
    result = runs.pop("result")
    worst = compare_runs(metric_values(streamed_result), metric_values(result), "resident main")
    stats = runs["scan_stats"]
    if runs["resident_string_counts"] != 2:
        fail(f"resident main: {runs['resident_string_counts']} grouping counts from "
             "resident codes, want 2 (status and region)")
    if runs["kernel_launches"]["bincount"] < 2 * n_chunks + 1:
        fail(f"resident main: {runs['kernel_launches']['bincount']} K5 launches")
    if stats["hist_plain_dispatches"] or stats["hist_host_dispatches"]:
        fail("resident main: a grouping count ran off the kernel")
    freed = unpersist_frees(table, device, "resident main")

    # (d) encoded columns against their decoded twin, both persisted
    t0 = time.perf_counter()
    enc, dec = make_encoded_table(table, True), make_encoded_table(table, False)
    enc_cache, enc_persist_s = persist_timed(enc, device)
    dec_cache, _ = persist_timed(dec, device)
    check = build_encoded_check()
    SCAN_STATS.reset()
    got_enc = metric_values(VerificationSuite.on_data(enc).add_check(check).run())
    enc_stats = SCAN_STATS.snapshot()
    got_dec = metric_values(VerificationSuite.on_data(dec).add_check(check).run())
    if enc_stats["encoded_scan_passes"] < 1 or enc_stats["bytes_packed"] != 0:
        fail(f"encoded: {enc_stats['encoded_scan_passes']} encoded passes, "
             f"{enc_stats['bytes_packed']} bytes packed")
    for key, want in got_dec.items():
        have = got_enc[key]
        if not (have == want or (have != have and want != want)):
            fail(f"encoded: {key} encoded {have!r} != decoded {want!r}")
    if enc_cache.nbytes * 2 > dec_cache.nbytes:
        fail(f"encoded: {enc_cache.nbytes} resident bytes, decoded {dec_cache.nbytes}")
    encoded = {
        "columns": list(enc_cache.packer.enc_names),
        "metrics_bit_identical": len(got_dec),
        "resident_bytes_encoded": enc_cache.nbytes,
        "resident_bytes_decoded": dec_cache.nbytes,
        "persist_s_encoded": enc_persist_s,
        "scan_stats": enc_stats,
        "seconds": time.perf_counter() - t0,
    }
    enc.unpersist()
    dec.unpersist()
    return {
        "phase": "resident_path", "part": "main",
        "rows": table.num_rows, "chunks": n_chunks,
        "persist_s": persist_s, **freed,
        "streaming_run_wall_s_median_of_3": streamed_report["run_wall_s_median_of_3"],
        "worst_rel_err_vs_streaming": worst,
        **runs,
        "encoded": encoded,
    }


def kll_states_select_vs_sort(table, device, check) -> dict:
    """K4 against K3 on the same resident chunks: every KLL state of the
    sketch check from a resident scan with the select and one without,
    bit for bit; the select scan sorts nothing."""
    import numpy as np

    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan

    kll = list(dict.fromkeys(a for a in check.required_analyzers()
                             if type(a).__name__ in ("ApproxQuantile", "KLLSketch")))
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    states = {}
    for select in (True, False):
        SCAN_STATS.reset()
        results = run_scan(table, exec_ops, device, select_kernel=select)
        stats = SCAN_STATS.snapshot()
        if stats["resident_passes"] != 1:
            fail("select vs sort: the scan did not read the resident chunks")
        if select and (stats["device_sort_passes"] or not stats["device_select_passes"]):
            fail(f"select scan: {stats['device_sort_passes']} sorts, "
                 f"{stats['device_select_passes']} selects")
        states[select] = [a.state_from_scan_result(ex(results[i]) if ex else results[i])
                          for a, (i, ex) in zip(kll, plan)]
    for a, sel, srt in zip(kll, states[True], states[False]):
        same = (
            (sel.global_min, sel.global_max) == (srt.global_min, srt.global_max)
            and (sel.sketch.count, sel.sketch.rng_count) == (srt.sketch.count,
                                                             srt.sketch.rng_count)
            and len(sel.sketch.compactors) == len(srt.sketch.compactors)
            and all(np.array_equal(x.view(np.uint64), y.view(np.uint64))
                    for x, y in zip(sel.sketch.compactors, srt.sketch.compactors))
        )
        if not same:
            fail(f"KLL state of {a!r}: the select (K4) != the sort (K3) on the same chunks")
    return {"states": len(kll), "batched_ops": len(exec_ops)}


def resident_sketch_pieces(table, device, check) -> dict:
    """Host-clock seconds of the resident sketch run's pieces: the whole
    resident scan with its fetch and fold, the scan of the KLL ops alone
    (K4 a chunk and op, one fetch), and the host fold of every KLL
    analyzer's fetched summaries (``kll_device.fold_summaries`` through
    ``state_from_scan_result``)."""
    import torch

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops.scan_engine import run_scan

    scanning = list(dict.fromkeys(
        a for a in check.required_analyzers() if isinstance(a, ScanShareableAnalyzer)))
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    out["fused_scan"] = time.perf_counter() - t0
    kll = [a for a in scanning if type(a).__name__ in ("ApproxQuantile", "KLLSketch")]
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops([a.scan_op(table) for a in kll])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_scan(table, exec_ops, device)
    out["kll_scan_select"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a, (i, ex) in zip(kll, plan):
        a.state_from_scan_result(ex(results[i]) if ex else results[i])
    out["host_fold_summaries"] = time.perf_counter() - t0
    out["kll_analyzers_folded"] = len(kll)
    return out


def resident_sketch(table, device, streamed: dict, streamed_report) -> dict:
    """(b) the sketch path over its persisted table: the select (K4's
    kernel) replaces every sort, K4 = K3 on the same chunks, quantiles
    within the rank bound, HLL estimates equal to the streaming run's."""
    from deequ_tpu_torch import VerificationSuite

    cache, persist_s = persist_timed(table, device)
    check = build_sketch_check(table)
    runs = resident_runs(VerificationSuite.on_data(table).add_check(check), table,
                         device, "resident sketch")
    result = runs.pop("result")
    stats = runs["scan_stats"]
    if stats["device_select_passes"] <= 0 or stats["device_sort_passes"] != 0 or (
            stats["kll_sort_passes"] != 0):
        fail(f"resident sketch: {stats['device_select_passes']} select passes, "
             f"{stats['device_sort_passes']} sort passes (want > 0 and 0)")
    if runs["kernel_launches"]["select"] != stats["device_select_passes"]:
        fail(f"resident sketch: {runs['kernel_launches']['select']} K4 kernel launches for "
             f"{stats['device_select_passes']} select passes")
    if stats["last_scan_fetches"] != 1:
        fail(f"resident sketch: {stats['last_scan_fetches']} fetches")
    checked = check_sketch_metrics(table, result, streamed["sorted"])
    got, want = metric_values(result), metric_values(streamed["result"])
    for key, value in want.items():
        if key[0] == "ApproxCountDistinct" and got[key] != value:
            fail(f"resident sketch: {key} {got[key]} != streamed {value}")
    select_vs_sort = kll_states_select_vs_sort(table, device, check)
    return {
        "phase": "resident_path", "part": "sketch",
        "rows": table.num_rows, "chunks": len(cache.device_chunks), "chunk_rows": cache.chunk,
        "persist_s": persist_s, "resident_bytes": cache.nbytes,
        "streaming_run_wall_s_median_of_3": streamed_report["run_wall_s_median_of_3"],
        **checked, "kll_select_equals_sort": select_vs_sort,
        **runs,
        "piece_s": resident_sketch_pieces(table, device, check),
    }


def _same_values(a, b) -> bool:
    """Equal as values, any NaN equal to any NaN (min and max)."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _summaries_agree(got: dict, want: dict, k: int, exact_order: bool) -> bool:
    """Two summaries agree: count and weights equal, min and max as values,
    the strata items bit for bit and the remainder's items bit for bit in
    the same order (``exact_order``: the kernel against its plain version)
    or as a multiset (against K3, which sorts it)."""
    import torch

    if not (torch.equal(got["count"], want["count"])
            and torch.equal(got["weights"], want["weights"])
            and _same_values(got["min"], want["min"]) and _same_values(got["max"], want["max"])):
        return False
    a, b = got["items"].view(torch.int64), want["items"].view(torch.int64)
    if exact_order:
        return torch.equal(a, b)
    return torch.equal(a[:, :k], b[:, :k]) and torch.equal(
        a[:, k:].sort(1).values, b[:, k:].sort(1).values)


def select_case(X, M, k: int, label: str) -> None:
    """K4's kernel on one (K, n) case against its plain version on the
    same card tensors, bit for bit: the summary, and ``select_ranks``'
    keys, tie ranks and every pass's prefix and rank left, at the
    summary's targets and at 37 ranks a column in any order; the summary
    against K3 too."""
    import torch

    from deequ_tpu_torch.ops import select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched

    capacity = X.shape[1]
    got = sd.chunk_summary_select_batched(X, M, k, capacity)
    if not _summaries_agree(got, sd.chunk_summary_select_batched_plain(X, M, k, capacity), k,
                            exact_order=True):
        fail(f"select parity ({label}): the kernel's summary != its plain version's")
    if not _summaries_agree(got, chunk_summary_batched(X, M, k, capacity), k,
                            exact_order=False):
        fail(f"select parity ({label}): the kernel's summary != K3's")
    Xp, Mp = sd._padded(X, M)
    gen = torch.Generator(device=X.device).manual_seed(37)
    n = Xp.shape[1]
    for ranks in (sd._targets(Mp.sum(-1), k)[0],
                  torch.randint(-3, n + 3, (Xp.shape[0], 37), generator=gen, device=X.device)):
        a = sd.select_ranks(Xp, Mp, ranks, trace=True)
        b = sd.select_ranks_plain(Xp, Mp, ranks, trace=True)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])):
            fail(f"select parity ({label}): select_ranks' keys, ties or passes != plain")


def select_parity(device) -> dict:
    """K4's kernel against its plain version and K3 on the card
    (:func:`select_case`): tests/select_cases.py's adversarial columns (the
    CPU tests' generator and seed; each with its reverse, K = 2) at k = 256,
    2,048 and 16,384; the kernel's tile edges (1, 8,191, 8,192, 8,193 and
    20,000 rows) at K = 1 and 50, normal columns and columns of few tied
    values (both zeros, NaN payloads, +inf, nulls); a constant column at
    the resident sketch chunk's rows."""
    import numpy as np
    import torch

    from deequ_tpu_torch.ops import histogram_device, select_device

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from select_cases import adversarial_cases

    saved = (select_device.LAUNCHES, histogram_device.LAUNCHES)
    _, nan_bits, cases = adversarial_cases()
    checked = []
    for name, (values, mask) in sorted(cases.items()):
        mask = np.ones(len(values), dtype=bool) if mask is None else mask
        X = torch.from_numpy(np.stack([values, values[::-1].copy()])).to(device)
        M = torch.from_numpy(np.stack([mask, mask[::-1].copy()])).to(device)
        for k in (256, 2048, 16384):
            select_case(X, M, k, f"{name}, k={k}")
        checked.append(name)
    rng = np.random.default_rng(8192)
    pool = np.array([-0.0, 0.0, 1.5, -2.0, np.inf, nan_bits[1].view(np.float64), 2.0 ** 60])
    edges = []
    for n in (1, 8191, 8192, 8193, 20_000):
        for K in (1, 50):
            for kind in ("normal", "ties"):
                if kind == "normal":
                    values = rng.normal(100, 10, (K, n))
                else:
                    values = rng.choice(pool, (K, n))
                X = torch.from_numpy(values).to(device)
                M = torch.from_numpy(rng.random((K, n)) > 0.05).to(device)
                select_case(X, M, 256, f"{kind}, K={K}, n={n}")
                edges.append(f"{kind} {K}x{n}")
    chunk_rows = 4_761_604  # the resident sketch chunk (resident_path)
    X = torch.full((1, chunk_rows), 2.5, dtype=torch.float64, device=device)
    select_case(X, torch.ones_like(X, dtype=torch.bool), 256, "constant column")
    select_device.LAUNCHES, histogram_device.LAUNCHES = saved
    return {"adversarial": checked, "ks": [256, 2048, 16384], "tile_edges": edges,
            "constant_column_rows": chunk_rows, "max_abs_err": 0,
            "parity": "bit-exact against the plain version; K3's summary"}


def select_timing(table, device, rate: float) -> dict:
    """K4 for one batched summary at the resident sketch chunk's shape
    (50 columns x chunk rows, k = 256): the kernel alone (CUDA events
    around a launch into preallocated buffers, median of 3 after a warm
    launch) and each of its stages (``select_device.STAGES``, events
    between them, median of 3), one wrapper call, its plain version (the
    previous route: eight K5 launches and torch passes), torch.sort of the
    same (K, n) keys (the library call), K3 whole, and the bound: one read
    of the values and validity and one write of the summary. The same for
    a constant column at that shape. The kernel's summary is held against
    its plain version (bit for bit) and K3 at both."""
    import torch

    from deequ_tpu_torch.analyzers.sketches import _sketch_size_for_error
    from deequ_tpu_torch.ops import histogram_device, select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched, strata_capacity

    cache = table._device_cache
    numeric, _ = sketch_columns(table)
    planes = cache.device_chunks[0]
    n = planes[0].shape[1]
    row_valid = torch.ones(n, dtype=torch.bool, device=device)
    vals = cache.packer.unpack_vals(*planes, row_valid, names=numeric)
    X = torch.stack([vals[c].data for c in numeric])
    M = torch.stack([vals[c].mask for c in numeric])
    del vals
    k = _sketch_size_for_error(SKETCH_RELATIVE_ERROR)
    cap = cache.chunk
    saved = (sd.LAUNCHES, histogram_device.LAUNCHES)
    K = X.shape[0]
    W = strata_capacity(cap, k)
    bound_ms = (K * n * 9 + K * (k + W) * 16 + K * 24) / rate * 1e3

    def measure(X, M, label):
        bufs = sd.summary_buffers(X, k, cap)
        kernel_ms = time_cuda(lambda: sd.launch_summary(X, M, k, bufs), reps=3, warmup=1)
        stages = [sd.launch_summary(X, M, k, bufs, stage_ms=True) for _ in range(4)][1:]
        got = {key: bufs[key] for key in ("items", "weights", "count", "min", "max")}
        if not _summaries_agree(got, sd.chunk_summary_select_batched_plain(X, M, k, cap), k,
                                exact_order=True):
            fail(f"select timing ({label}): the kernel's summary != its plain version's")
        if not _summaries_agree(got, chunk_summary_batched(X, M, k, cap), k,
                                exact_order=False):
            fail(f"select timing ({label}): the kernel's summary != K3's")
        del bufs, got
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        call_ms = time_cuda(lambda: sd.chunk_summary_select_batched(X, M, k, cap),
                            reps=3, warmup=1)
        working = torch.cuda.max_memory_allocated(device) - base
        plain_ms = time_cuda(lambda: sd.chunk_summary_select_batched_plain(X, M, k, cap),
                             reps=3, warmup=1)
        key = torch.where(M, X, math.inf)
        key = torch.where(key == 0, 0.0, key)
        sort_ms = time_cuda(lambda: torch.sort(key, dim=-1, stable=True), reps=3, warmup=1)
        del key
        k3_ms = time_cuda(lambda: chunk_summary_batched(X, M, k, cap), reps=3, warmup=1)
        return {
            "column": label,
            "shape": {"columns": K, "rows": n, "k": k, "targets": k + 2, "W": W},
            "kernel_ms": kernel_ms,
            "stage_ms_median_of_3": {name: statistics.median(s[name] for s in stages)
                                     for name in sd.STAGES},
            "call_ms": call_ms,
            "working_set_bytes": working,
            "plain_ms": plain_ms,
            "torch_sort_ms": sort_ms,
            "k3_summary_ms": k3_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "bound_share": bound_ms / kernel_ms,
            "max_abs_err": 0,
        }

    out = measure(X, M, "resident sketch chunk")
    const = torch.full_like(X, 2.5)
    out["constant_column"] = measure(const, torch.ones_like(M), "constant columns")
    del const, X, M
    sd.LAUNCHES, histogram_device.LAUNCHES = saved
    out["name"] = "select (K4)"
    out["peak_device_bytes_after"] = torch.cuda.max_memory_allocated(device)
    return out


#: the resident chunk rule's bytes (scan_engine.persist_table: 2 GiB a
#: chunk, 9 bytes a row of an f64 column with its validity)
_CHUNK_ROWS_9B = (2 << 30) // 9


def select_shapes(device, rate: float) -> dict:
    """K4's kernel (alone, into preallocated buffers) against K3 whole at
    resident chunk shapes: batch widths 1, 8 and 50, rows 2^16 to 2^25,
    k = 2^8, 2^11 and 2^14, CUDA events, median of 3 after a warm call.
    Shapes whose chunk would pass the resident chunk rule's 2 GiB are not
    resident chunks and are listed as skipped. Normal(100, 10) values, 1%
    null, made on the card from a seed; the kernel's summary is held
    against K3's at every shape."""
    import torch

    from deequ_tpu_torch.ops import select_device as sd
    from deequ_tpu_torch.ops.kll_device import chunk_summary_batched

    saved = sd.LAUNCHES
    gen = torch.Generator(device=device).manual_seed(3)
    cells, skipped = [], []
    for K in (1, 8, 50):
        for n in (1 << 16, 1 << 19, 1 << 22, 1 << 24, 1 << 25):
            if K * n > _CHUNK_ROWS_9B:
                skipped.append({"columns": K, "rows": n})
                continue
            X = torch.randn((K, n), generator=gen, dtype=torch.float64, device=device) * 10 + 100
            M = torch.rand((K, n), generator=gen, device=device) > 0.01
            for k in (1 << 8, 1 << 11, 1 << 14):
                bufs = sd.summary_buffers(X, k, n)
                k4 = time_cuda(lambda: sd.launch_summary(X, M, k, bufs), reps=3, warmup=1)
                got = {key: bufs[key] for key in ("items", "weights", "count", "min", "max")}
                if not _summaries_agree(got, chunk_summary_batched(X, M, k, n), k,
                                        exact_order=False):
                    fail(f"select shapes: K4 != K3 at K={K}, n={n}, k={k}")
                del bufs, got
                k3 = time_cuda(lambda: chunk_summary_batched(X, M, k, n), reps=3, warmup=1)
                cells.append({"columns": K, "rows": n, "k": k, "k4_ms": k4, "k3_ms": k3,
                              "k4_over_k3": k4 / k3,
                              "bound_ms": K * n * 9 / rate * 1e3})
            del X, M
            torch.cuda.empty_cache()
    sd.LAUNCHES = saved
    return {"cells": cells, "skipped_past_the_chunk_rule": skipped,
            "k4_faster_everywhere": all(c["k4_ms"] < c["k3_ms"] for c in cells)}


def resident_frequency(table, device, streamed_result, streamed_report) -> dict:
    """(c) config 4 over its persisted table: Histogram's top-k and
    Uniqueness's count statistics from resident codes, equal to the
    streaming run's; Uniqueness fetches four scalars."""
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.ops.segment import group_count_stats

    cache, persist_s = persist_timed(table, device)
    n_chunks = len(cache.device_chunks)
    runs = resident_runs(VerificationSuite.on_data(table).add_check(build_config4_check()),
                         table, device, "resident frequency")
    result = runs.pop("result")
    if runs["resident_string_counts"] != 2:
        fail(f"resident frequency: {runs['resident_string_counts']} resident counts, "
             "want 2 (Histogram and Uniqueness)")
    got = {m.name: m for m in result.metrics.values()}
    want = {m.name: m for m in streamed_result.metrics.values()}
    if distribution_of(got["Histogram"]) != distribution_of(want["Histogram"]):
        fail("resident frequency: the Histogram differs from the streaming run's")
    for name in ("Uniqueness", "ApproxCountDistinct"):
        if got[name].value.get() != want[name].value.get():
            fail(f"resident frequency: {name} {got[name].value.get()} != "
                 f"{want[name].value.get()}")
    before = SCAN_STATS.snapshot()
    with ResidentSpy() as spy:
        group_count_stats(table, ["key"], device)
    fetched = SCAN_STATS.bytes_fetched - before["bytes_fetched"]
    fetches = SCAN_STATS.device_fetches - before["device_fetches"]
    if spy.calls != 1 or fetches != 1 or fetched != 32:
        fail(f"resident Uniqueness: {fetches} fetches of {fetched} bytes (want 1 of 32)")
    freed = unpersist_frees(table, device, "resident frequency")
    return {
        "phase": "resident_path", "part": "frequency",
        "rows": table.num_rows, "chunks": n_chunks,
        "persist_s": persist_s, **freed,
        "uniqueness_fetch_bytes": fetched,
        "streaming_run_wall_s_median_of_3": streamed_report["run_wall_s_median_of_3"],
        **runs,
    }


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from deequ_tpu_torch import native
        from deequ_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a deequ_tpu checkout ({e})",
              file=sys.stderr)
        return 3

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rate = hbm_rate(kind)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "hbm_bytes_per_s": rate})

    t0 = time.perf_counter()
    cuda_build.build(*KERNELS, verbose=True)
    native_lib = native.build()
    emit({"phase": "build", "built": list(KERNELS), "native": str(native_lib.name),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    parity = kernel_parity(device)
    emit({"phase": "kernel_parity", "kernel": "bincount", **parity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    hparity = hll_parity(device)
    emit({"phase": "hll_parity", "kernel": "hll", **hparity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    sparity = select_parity(device)
    emit({"phase": "select_parity", "kernel": "select", **sparity,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    report, table, main_result = main_path(args.rows, args.seed, device)
    emit({**report, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    api = check_api_path(table, device)
    emit({**api, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    shapes = kernel_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi, "shapes": shapes,
          "boundaries": boundary_timing(device, rate), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_main = resident_main(table, device, main_result, report)
    emit({**res_main, "seconds": time.perf_counter() - t0})
    del table, main_result

    t0 = time.perf_counter()
    sketch, table, streamed = sketch_path(args.rows, args.seed, device)
    emit({**sketch, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    htime = hll_timing(table, device, rate, sketch["kernel_launches"]["hll"])
    emit({"phase": "kernel_timing", "kernel": "hll", "card": smi, "shapes": [htime],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_sketch = resident_sketch(table, device, streamed, sketch)
    t_sel = time.perf_counter()
    select = select_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "select (K4)", "card": smi, "shapes": [select],
          "seconds": time.perf_counter() - t_sel})
    res_sketch.update(unpersist_frees(table, device, "resident sketch"))
    emit({**res_sketch, "seconds": time.perf_counter() - t0})
    del table, streamed

    t0 = time.perf_counter()
    sshapes = select_shapes(device, rate)
    emit({"phase": "select_shapes", "kernel": "select", "card": smi, **sshapes,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    freq, table, freq_result = frequency_path(args.rows, args.seed, device)
    emit({**freq, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    c4 = config4_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi,
          "shapes": c4["bincount"], "packed_topk": c4["packed_topk"],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    res_freq = resident_frequency(table, device, freq_result, freq)
    emit({**res_freq, "seconds": time.perf_counter() - t0})
    del table, freq_result

    launches = {"main_path": report["kernel_launches"],
                "check_api_path": api["kernel_launches"],
                "sketch_path": sketch["kernel_launches"]["bincount"],
                "frequency_path": freq["kernel_launches"],
                "resident_path": sum(r["kernel_launches"]["bincount"]
                                     for r in (res_main, res_sketch, res_freq))}
    # the headline shape: the config 4 top-k count, the shape this slice
    # was cut for; every shape timed is listed beside it
    shapes = shapes + c4["bincount"]
    widest = c4["bincount"][0]
    max_err = max([parity["max_abs_err"]] + [s["max_abs_err"] for s in shapes])
    emit({"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/bincount.cu",
        "replaces": "deequ_tpu/ops/histogram_device.py:200",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "headline_shape": widest["column"],
        "max_abs_err": max_err,
        "ms": widest["kernel_ms"],
        "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"],
        "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"],
        "parity": "exact" if max_err == 0 else f"max abs err {max_err}",
        "shapes": shapes,
    }, {
        "name": "hll",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/hll.cu",
        "replaces": "deequ_tpu/ops/hll.py:350",
        "launches": (sketch["kernel_launches"]["hll"] + freq["hll_launches"]
                     + sum(r["kernel_launches"]["hll"] for r in (res_main, res_sketch, res_freq))),
        "launches_by_path": {"sketch_path": sketch["kernel_launches"]["hll"],
                             "frequency_path": freq["hll_launches"],
                             "resident_path": sum(r["kernel_launches"]["hll"]
                                                  for r in (res_main, res_sketch, res_freq))},
        "max_abs_err": 0,
        "ms": htime["kernel_ms"],
        "plain_ms": htime["plain_ms"],
        "bound_ms": htime["bound_ms"],
        "bound_by": htime["bound_by"],
        "library_ms": htime["library_ms"],
        "library_call": htime["library_call"],
        "parity": "exact",
        "shapes": [htime],
    }, {
        "name": "select",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/select.cu",
        "replaces": "deequ_tpu/ops/select_device.py:149",
        "launches": res_sketch["kernel_launches"]["select"],
        "launches_by_path": {"resident_path": res_sketch["kernel_launches"]["select"]},
        "max_abs_err": 0,
        "ms": select["kernel_ms"],
        "plain_ms": select["plain_ms"],
        "bound_ms": select["bound_ms"],
        "bound_by": select["bound_by"],
        "library_ms": select["torch_sort_ms"],
        "library_call": "torch.sort of the same (K, n) keys, stable",
        "k3_summary_ms": select["k3_summary_ms"],
        "parity": "exact",
        "shapes": [select],
        "routing_shapes": sshapes["cells"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
