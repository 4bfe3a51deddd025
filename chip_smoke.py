#!/usr/bin/env python3
"""Drive deequ_tpu_torch's main path on one CUDA card and hold every kernel
of that path against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N] [--seed S]

Phases, each printed as one JSON line on stdout:

1. ``device``  — the card (torch) and its name and power limit (nvidia-smi);
2. ``build``   — compile the CUDA kernels from the checkout's sources;
3. ``kernel_parity`` — every kernel against its plain version on the card,
   bit-exact, over edge cases, key-space boundaries and 10^7 ids;
4. ``main_path`` — ``VerificationSuite.on_data(table).add_check(check).run()``
   on a 10^7-row table (20 float64 columns with 1% nulls, the repo's
   profiling config 2 in BASELINE.md, plus an all-distinct int64 id, a
   Zipf-skewed int64 customer id with ~10^6 distinct values, and string
   columns of 8 and 5,000 values), every metric checked against numpy;
   the kernel launch counts are read around the run and the run is
   watched for any torch operation computing on a CPU tensor;
5. ``kernel_timing`` — each kernel at the shapes the main path gave it,
   beside its plain version, the PyTorch library call computing the same
   function, and its bound;

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


def kernel_parity(device) -> dict:
    import numpy as np
    import torch

    from deequ_tpu_torch.ops.histogram_device import (
        bincount,
        bincount_plain,
        uses_shared_memory,
    )

    rng = np.random.default_rng(7)
    cases = 0
    max_err = 0

    def check(seg_np, m, weights_np=None, dtype=torch.int64):
        nonlocal cases, max_err
        seg = torch.from_numpy(seg_np).to(device=device, dtype=dtype)
        w = None if weights_np is None else torch.from_numpy(weights_np).to(device)
        got = bincount(seg, m, weights=w)
        want = bincount_plain(seg, m, weights=w)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if m else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"bincount != plain (n={len(seg_np)}, m={m}, "
                 f"weighted={weights_np is not None}, dtype={dtype}): max err {err}")
        cases += 1

    for dtype in (torch.int32, torch.int64):
        for m in (1, 7, 511, 512, 513, 4097):
            for n in (0, 1, 1023, 1024, 1025, 5000):
                # ids in [-3, m + 3): negatives and ids >= m must be dropped
                seg = rng.integers(-3, m + 3, size=n)
                check(seg, m, dtype=dtype)
                check(seg, m, rng.integers(-50, 1000, size=n).astype(np.int32), dtype)
    regimes = {}
    for m in (8, 5000, 58_000, 58_200, 1_000_001, 4_194_305):
        seg = rng.integers(-1, m, size=2_000_000)
        for dtype in (torch.int32, torch.int64):
            check(seg, m, dtype=dtype)
        check(seg, m, rng.integers(0, 100, size=len(seg)).astype(np.int32))
        regimes[m] = "shared" if uses_shared_memory(m) else "global"
    big = rng.integers(-1, 1_000_001, size=10_000_000)
    check(big, 1_000_001)
    check(big, 1_000_001, rng.integers(-5, 6, size=len(big)).astype(np.int32))
    check(rng.integers(0, 9, size=10_000_000), 9)
    if regimes[58_000] != "shared" or regimes[58_200] != "global":
        fail(f"shared-memory boundary not where expected: {regimes}")
    return {"cases": cases, "max_abs_err": max_err, "regimes": regimes}


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


def kernel_timing(table, device, rate: float) -> list:
    import torch

    from deequ_tpu_torch.ops import histogram_device
    from deequ_tpu_torch.ops.histogram_device import bincount, bincount_plain
    from deequ_tpu_torch.ops.segment import _prepare_grouping

    shapes = []
    for col in ("customer_id", "region", "status"):
        prep = _prepare_grouping(table, [col], device)
        seg = torch.from_numpy(prep.keys).to(device)
        m = prep.keyspace
        slots = torch.where(seg >= 0, seg, m)  # torch.bincount refuses negatives
        saved = histogram_device.LAUNCHES
        ms = time_cuda(lambda: bincount(seg, m))
        plain_ms = time_cuda(lambda: bincount_plain(seg, m))
        library_ms = time_cuda(lambda: torch.bincount(slots, minlength=m + 1))
        got, want = bincount(seg, m), bincount_plain(seg, m)
        histogram_device.LAUNCHES = saved  # timing launches are not the path's
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"bincount != plain at the main path's {col} shape "
                 f"(n={seg.numel()}, m={m}): max err {err}")
        nbytes = seg.numel() * seg.element_size() + m * 8
        shapes.append({
            "column": col,
            "n": seg.numel(),
            "num_segments": m,
            "ids": str(seg.dtype).replace("torch.", ""),
            "regime": "shared" if histogram_device.uses_shared_memory(m) else "global",
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": nbytes / rate * 1e3,
            "bound_by": "bytes",
            "max_abs_err": err,
        })
    return shapes


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
    emit({"phase": "kernel_timing", "kernel": "bincount", "card": smi, "shapes": shapes})

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
