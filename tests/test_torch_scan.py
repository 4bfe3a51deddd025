"""The port's scan analyzers against the reference's, on the CPU.

Each table runs ONE analysis of every analyzer below through both
packages (the fused scan on each side) and the metrics are compared one
test case per analyzer, under the bounds of tests/torch_parity.py:
exact for Size, Completeness, Compliance, Minimum and Maximum; relative
1e-12 for Sum and Mean; 1e-10 for StandardDeviation and Correlation.
Failures (all-null columns, empty tables, wrong types, missing columns)
must come back as the same Failure metrics, never as exceptions. The
reference also runs with DEEQU_TPU_COMPUTE=f64 (its exact-f64 escape
hatch) against the same port results and bounds.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.scan_engine as ref_scan_engine
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.scan_engine as port_scan_engine
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from torch_parity import assert_metric_parity, parity_env, port_table, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port


def _table_nulls():
    rng = np.random.default_rng(11)
    n = 3000
    return RefTable([
        ref_column("x", "fractional", rng.normal(5.0, 2.0, n), rng.random(n) > 0.1),
        # mean 1e6, spread 1: a raw sum-of-squares variance loses it
        ref_column("big", "fractional", 1e6 + rng.standard_normal(n), np.ones(n, bool)),
        ref_column("y", "fractional", 0.3 * rng.normal(5.0, 2.0, n) + rng.normal(1.0, 1.0, n),
                   rng.random(n) > 0.05),
        ref_column("k", "integral", rng.integers(-20, 100, n), rng.random(n) > 0.2),
        ref_column("s", "string", codes=rng.integers(-1, 5, n).astype(np.int32),
                   dictionary=["v", "w", "x", "y", "z"]),
        ref_column("flag", "boolean", rng.random(n) > 0.5, rng.random(n) > 0.1),
    ])


def _table_all_null():
    rng = np.random.default_rng(12)
    n = 500
    return RefTable([
        ref_column("x", "fractional", np.zeros(n), np.zeros(n, bool)),
        ref_column("y", "fractional", rng.normal(1.0, 3.0, n), np.ones(n, bool)),
        ref_column("k", "integral", np.zeros(n, np.int64), np.zeros(n, bool)),
        ref_column("s", "string", codes=np.full(n, -1, np.int32), dictionary=["a"]),
    ])


def _table_empty():
    return RefTable([
        ref_column("x", "fractional", np.zeros(0), np.zeros(0, bool)),
        ref_column("y", "fractional", np.zeros(0), np.zeros(0, bool)),
        ref_column("k", "integral", np.zeros(0, np.int64), np.zeros(0, bool)),
        ref_column("s", "string", codes=np.zeros(0, np.int32), dictionary=[]),
    ])


def _table_nan():
    rng = np.random.default_rng(13)
    n = 1000
    x = rng.normal(2.0, 1.0, n)
    x[rng.random(n) < 0.02] = np.nan
    y = rng.normal(-3.0, 4.0, n)
    y[7] = np.inf
    return RefTable([
        ref_column("x", "fractional", x, rng.random(n) > 0.05),
        ref_column("y", "fractional", y, np.ones(n, bool)),
        ref_column("k", "integral", rng.integers(0, 10, n), np.ones(n, bool)),
        ref_column("s", "string", codes=rng.integers(0, 3, n).astype(np.int32),
                   dictionary=["a", "b", "c"]),
    ])


TABLES = {
    "nulls": _table_nulls,
    "all_null": _table_all_null,
    "empty": _table_empty,
    "nan": _table_nan,
}

# (analyzer class name, positional args, keyword args)
COMMON = [
    ("Size", (), {}),
    ("Size", (), {"where": "x > 2"}),
    ("Completeness", ("x",), {}),
    ("Completeness", ("s",), {"where": "k >= 5"}),
    ("Completeness", ("nope",), {}),
    ("Compliance", ("x positive", "x > 0"), {}),
    ("Compliance", ("s in", "s IN ('a', 'v', 'w')"), {"where": "y < 4"}),
    ("Compliance", ("bad where", "x > 0"), {"where": "nope > 1"}),
    ("Minimum", ("x",), {}),
    ("Minimum", ("k",), {"where": "s = 'a' OR s = 'w'"}),
    ("Maximum", ("x",), {}),
    ("Maximum", ("y",), {"where": "x BETWEEN 1 AND 6"}),
    ("Minimum", ("s",), {}),
    ("Mean", ("x",), {}),
    ("Mean", ("y",), {"where": "s <> 'x'"}),
    ("Mean", ("k",), {}),
    ("Sum", ("x",), {}),
    ("Sum", ("y",), {"where": "COALESCE(x, 0.0) >= 1"}),
    ("Sum", ("k",), {}),
    ("StandardDeviation", ("x",), {}),
    ("StandardDeviation", ("y",), {"where": "x IS NOT NULL"}),
    ("StandardDeviation", ("k",), {}),
    ("Correlation", ("x", "y"), {}),
    ("Correlation", ("x", "k"), {"where": "y > 0"}),
]
EXTRA = {
    "nulls": [
        ("StandardDeviation", ("big",), {}),
        ("Mean", ("big",), {}),
        ("Correlation", ("big", "x"), {}),
        ("Compliance", ("flag set", "flag"), {"where": "NOT (k < 0)"}),
        ("Compliance", ("arith", "x * 2 - k / 4 > 3 AND abs(y) < 9"), {}),
        ("Completeness", ("flag",), {"where": "s IS NULL"}),
    ],
}

CASES = [
    (table, mode, i)
    for table in TABLES
    for mode in (("pairs", "f64") if table == "nulls" else ("pairs",))
    for i in range(len(COMMON) + len(EXTRA.get(table, [])))
]


def _specs(table):
    return COMMON + EXTRA.get(table, [])


_RESULTS = {}


def _results(table, mode, monkeypatch):
    """Both packages' metrics for one table (computed once per module)."""
    key = (table, mode)
    if key not in _RESULTS:
        if mode == "f64":
            monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
        ref = TABLES[table]()
        specs = _specs(table)
        ref_list = [getattr(ref_analyzers, n)(*a, **k) for n, a, k in specs]
        port_list = [getattr(port_analyzers, n)(*a, **k) for n, a, k in specs]
        ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
        port_ctx = PortRunner.do_analysis_run(port_table(ref), port_list, device="cpu")
        _RESULTS[key] = [
            (ref_ctx.metric(r), port_ctx.metric(p)) for r, p in zip(ref_list, port_list)
        ]
    return _RESULTS[key]


@pytest.mark.parametrize(
    "table,mode,index", CASES,
    ids=[f"{t}-{m}-{i}" for t, m, i in CASES],
)
def test_scan_analyzer_parity(parity_env, monkeypatch, table, mode, index):
    ref_metric, port_metric = _results(table, mode, monkeypatch)[index]
    assert_metric_parity(ref_metric, port_metric)


def _exact_correlation(a, b):
    """Pearson correlation of two float arrays in exact rational
    arithmetic, rounded once at the end."""
    n = len(a)
    fa = [Fraction(float(v)) for v in a]
    fb = [Fraction(float(v)) for v in b]
    ma, mb = sum(fa) / n, sum(fb) / n
    ck = sum((p - ma) * (q - mb) for p, q in zip(fa, fb))
    xa = sum((p - ma) ** 2 for p in fa)
    yb = sum((q - mb) ** 2 for q in fb)
    return float(ck) / math.sqrt(float(xa) * float(yb))


# the one ill-conditioned case of the multi-chunk table: a mean-1e6 column
# against an independent one (correlation ~0.01). Each chunk's mean of the
# big column carries the sum's rounding (~1e-9 absolute), which the Chan
# merge multiplies into the merged co-moment; on this table the
# reference's df32 pairs land ~2e-9 (relative) off the exact value and the
# port ~2e-11. The port is held to the exact value at the Correlation bound,
# the reference to 1e-8 of it.
ILL_CONDITIONED = ("Correlation", ("big", "x"), {})


def _multi_chunk_results(monkeypatch):
    monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 704)
    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 704)
    ref = _table_nulls()
    specs = [s for s in COMMON + EXTRA["nulls"] if "nope" not in repr(s)]
    ref_list = [getattr(ref_analyzers, n)(*a, **k) for n, a, k in specs]
    port_list = [getattr(port_analyzers, n)(*a, **k) for n, a, k in specs]
    ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
    port_scan_engine.SCAN_STATS.reset()
    port_ctx = PortRunner.do_analysis_run(port_table(ref), port_list, device="cpu")
    return ref, specs, ref_list, port_list, ref_ctx, port_ctx


def test_multi_chunk_scan_parity(parity_env, monkeypatch):
    """Both packages cut the table at the same 704 rows: the chunk partials
    fold on the device (sum/min/max in chunk order, Welford moments
    gathered per chunk) and the whole scan fetches once."""
    ref, specs, ref_list, port_list, ref_ctx, port_ctx = _multi_chunk_results(monkeypatch)
    stats = port_scan_engine.SCAN_STATS.snapshot()
    assert stats["scan_passes"] == 1
    assert stats["chunks_processed"] == 5
    assert stats["device_fetches"] == 1
    for spec, r, p in zip(specs, ref_list, port_list):
        ref_metric, port_metric = ref_ctx.metric(r), port_ctx.metric(p)
        if spec != ILL_CONDITIONED:
            assert_metric_parity(ref_metric, port_metric)
            continue
        ok = ref["big"].mask & ref["x"].mask
        exact = _exact_correlation(ref["big"].values[ok], ref["x"].values[ok])
        assert abs(port_metric.value.get() - exact) <= 1e-10 * abs(exact)
        assert abs(ref_metric.value.get() - exact) <= 1e-8 * abs(exact)


def test_scan_computes_in_float64(parity_env):
    """Values that float32 would round: the port keeps every digit."""
    ref = RefTable([ref_column("x", "fractional",
                               np.array([1e8 + 0.25, 1e8 + 0.5, 0.1]), np.ones(3, bool))])
    port = port_table(ref)
    metrics = PortRunner.do_analysis_run(
        port, [port_analyzers.Sum("x"), port_analyzers.Maximum("x")], device="cpu"
    )
    assert metrics.metric(port_analyzers.Sum("x")).value.get() == 2e8 + 0.75 + 0.1
    assert metrics.metric(port_analyzers.Maximum("x")).value.get() == 1e8 + 0.5


def test_scan_op_tensors_stay_on_requested_device(parity_env):
    """Every partial leaf of a scan op lives on the scan's device."""
    port = port_table(_table_nulls())
    op = port_analyzers.Correlation("x", "y", where="k > 3").scan_op(port)
    packer = port_scan_engine._ChunkPacker({c: port[c] for c in op.columns})
    planes = packer.to_device(packer.pack(0, 100), torch.device("cpu"))
    row_valid = torch.ones(100, dtype=torch.bool)
    out = op.update(packer.unpack_vals(*planes, row_valid), row_valid, 100, 100)
    assert {k: v.dtype for k, v in out.items()} == {
        "n": torch.int64, "x_avg": torch.float64, "y_avg": torch.float64,
        "ck": torch.float64, "x_mk": torch.float64, "y_mk": torch.float64,
    }


@pytest.mark.parametrize(
    "spec", [("Mean", ("x",), {}), ("Uniqueness", (["k"],), {}), ("Minimum", ("s",), {})],
    ids=["scan", "grouping", "precondition"],
)
def test_single_analyzer_calculate_matches_reference(parity_env, spec):
    """``Analyzer.calculate`` (one analyzer on its own pass) gives the
    reference's metric, failures included."""
    name, args, kwargs = spec
    ref = _table_nulls()
    ref_metric = getattr(ref_analyzers, name)(*args, **kwargs).calculate(ref)
    port_metric = getattr(port_analyzers, name)(*args, **kwargs).calculate(
        port_table(ref), device="cpu"
    )
    assert_metric_parity(ref_metric, port_metric)


def test_f64_subnormals_against_numpy(parity_env, record_property):
    """f64 subnormals keep their values: Minimum/Maximum and the
    predicates ``f > 0`` / ``f = 0`` against numpy, streaming and over the
    persisted table. The reference reads every f64 subnormal as 0 under
    XLA on the CPU (ROADMAP queue 3), so its values are recorded beside
    the test (``record_property``) and not compared."""
    f = np.array([5e-324, 1e-310, -1e-310, 1.0, -2.0, 1e-40, 3e-39, 1e-38])
    g = np.array([1e-310, 5e-324, 1e-300, 3.0, 1e-310, 2e-310, 7.0, 1e-305])
    ref = RefTable([ref_column("f", "fractional", f, np.ones(8, bool)),
                    ref_column("g", "fractional", g, np.ones(8, bool))])
    specs = [("Minimum", ("f",)), ("Maximum", ("f",)), ("Minimum", ("g",)),
             ("Compliance", ("f positive", "f > 0")), ("Compliance", ("f zero", "f = 0")),
             ("Compliance", ("g below", "g < 1e-309"))]
    want = [f.min(), f.max(), g.min(), np.mean(f > 0), np.mean(f == 0), np.mean(g < 1e-309)]
    assert want[2] == 5e-324 and want[3] == 0.75 and want[4] == 0.0
    port = port_table(ref)
    analyzers = [getattr(port_analyzers, n)(*a) for n, a in specs]
    streamed = PortRunner.do_analysis_run(port, analyzers, device="cpu")
    port.persist("cpu", max_bytes=1 << 20)
    resident = PortRunner.do_analysis_run(port, analyzers, device="cpu")
    port.unpersist()
    for ctx in (streamed, resident):
        got = [ctx.metric(a).value.get() for a in analyzers]
        assert got == want
    ref_list = [getattr(ref_analyzers, n)(*a) for n, a in specs]
    ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
    record_property("reference_values", [ref_ctx.metric(a).value.get() for a in ref_list])
