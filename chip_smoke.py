#!/usr/bin/env python3
"""Drive deequ_tpu_torch's main path on one CUDA card and hold every kernel
of that path against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N] [--seed S]

Phases, each printed as one JSON line on stdout:

1. ``device``  — the card (torch) and its name and power limit (nvidia-smi);
2. ``build``   — compile the CUDA kernels from the checkout's sources;
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

then the ``kernels`` summary line, the nvidia-smi line, and the result
line ``{"ok": true, "device": {...}}`` last. Any failure exits non-zero
without the result line. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

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

    from deequ_tpu_torch.ops import histogram_device
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
    watch = watch_cpu_ops()
    t0 = time.perf_counter()
    with watch:
        result = suite.run()
    t_first = time.perf_counter() - t0
    launches = histogram_device.LAUNCHES
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
    }, table


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


def profiled_ms(fn, reps: int = 10):
    """Device milliseconds per ``fn(i)`` as torch.profiler sees them, by
    kernel (the kernels named ``bincount*`` and, in some regimes, the
    output's memset), or None where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and ("bincount" in ev.key or ev.key.startswith("Memset")):
            name = ev.key.split("::")[-1].split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / reps / 1e3
    if not by_kernel:
        return None
    return {"total": sum(by_kernel.values()), "by_kernel": by_kernel}


def kernel_timing(table, device, rate: float) -> list:
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import bincount, bincount_plain
    from deequ_tpu_torch.ops.segment import _prepare_grouping

    reps = 100
    shapes = []
    for col in ("customer_id", "region", "status"):
        prep = _prepare_grouping(table, [col], device)
        seg = torch.from_numpy(prep.keys).to(device)
        m = prep.keyspace
        slots = torch.where(seg >= 0, seg, m)  # torch.bincount refuses negatives
        saved = histogram_device.LAUNCHES
        # the kernel alone, in the rule's regime and in every other regime
        # that can take the width: buffers preallocated as the wrapper makes them
        name = histogram_device.regime(m)
        regime_ms = {}
        for other in histogram_device.REGIMES:
            try:
                bufs = [histogram_device._buffers(seg, m, None, other) for _ in range(reps)]
            except ValueError:
                continue  # this regime cannot take the width
            launch = lambda i: histogram_device._launch(seg, m, None, *bufs[i % reps],
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
            fail(f"bincount != plain at the main path's {col} shape "
                 f"(n={seg.numel()}, m={m}): max err {err}")
        nbytes = seg.numel() * seg.element_size() + m * 8
        bound_ms = nbytes / rate * 1e3
        shapes.append({
            "column": col,
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
        })
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
        from deequ_tpu_torch.ops import histogram_device
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
    histogram_device.build(verbose=True)
    emit({"phase": "build", "kernels": ["bincount"], "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    parity = kernel_parity(device)
    emit({"phase": "kernel_parity", "kernel": "bincount", **parity,
          "seconds": time.perf_counter() - t0})

    report, table = main_path(args.rows, args.seed, device)
    emit(report)

    shapes = kernel_timing(table, device, rate)
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi, "shapes": shapes,
          "boundaries": boundary_timing(device, rate)})

    widest = max(shapes, key=lambda s: s["num_segments"])
    max_err = max([parity["max_abs_err"]] + [s["max_abs_err"] for s in shapes])
    emit({"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "deequ_tpu_torch/csrc/bincount.cu",
        "replaces": "deequ_tpu/ops/histogram_device.py:200",
        "launches": report["kernel_launches"],
        "max_abs_err": max_err,
        "ms": widest["kernel_ms"],
        "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"],
        "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"],
        "parity": "exact" if max_err == 0 else f"max abs err {max_err}",
        "shapes": shapes,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
