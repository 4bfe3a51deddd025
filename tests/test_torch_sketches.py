"""The sketch slice of the port — ApproxCountDistinct, ApproxQuantile,
ApproxQuantiles, KLLSketch — against ``deequ_tpu`` on the CPU.

- KLL chunk summaries (``ops/kll_device.py``) bit-identical to the
  reference's wide f64 path, single and batched, including a short last
  chunk (the reference pads it to the chunk capacity), all-null and empty
  columns, and valid NaN / ±inf / ±0.0 (a chunk's min or max over a NaN
  is any NaN on both sides);
- the whole suite through both packages on a 10,000-row table cut into
  3,000-row chunks (the last one short), every sketch analyzer with and
  without ``where=``, the reference on one device: under
  ``DEEQU_TPU_COMPUTE=f64`` every metric is identical, KLL buckets and
  compactors included; on the reference's default (hi, lo) f32-pair path
  ApproxCountDistinct is identical and each quantile lies within one
  ulp(f32) of the reference's (its sort orders values that share an f32
  hi by row, ties < 1 ulp(f32) apart, PAIR_QUANTILE_REL);
- the same failure metrics for bad parameters, a string column and a
  missing column;
- KLL op coalescing: one batched sort a chunk, identical to solo runs;
- the reference's KLL goldens and properties
  (tests/test_reference_conformance.py, tests/test_kll_properties.py)
  through the port;
- states carried across with ``interop.state_from_fields`` merge with the
  port's own as the reference's merge.
"""

import numpy as np
import pytest
import torch

import deequ_tpu
import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.scan_engine as ref_scan_engine
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.scan_engine as port_scan_engine
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.ops import kll_device as ref_kll_device
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu.verification import VerificationResult as RefResult
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.interop import state_from_fields
from deequ_tpu_torch.ops import hll, kll_device
from deequ_tpu_torch.ops.kll import KLLSketchState
from deequ_tpu_torch.verification import VerificationResult as PortResult
from torch_parity import assert_metric_parity, parity_env, port_table, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port

#: pair path: values sharing an f32 hi sort by row, < 1 ulp(f32) apart
PAIR_QUANTILE_REL = 2.0 ** -23


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64), b.view(np.uint64))


def _same_or_both_nan(a, b) -> bool:
    """Bit for bit, except that any NaN equals any NaN: a chunk's min/max
    over a NaN is some NaN in XLA (the first it meets) and the canonical
    NaN in torch."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isnan(a) & np.isnan(b)
    return a.shape == b.shape and _bits_equal(np.where(both, 0.0, a), np.where(both, 0.0, b))


# -- KLL chunk summaries ------------------------------------------------------


def _special_values(rng, n, signed_zero=True):
    """Normals with ±inf, NaNs (with payloads and signs), 1e300 and, with
    ``signed_zero``, -0.0 and -1e-300 (the reference's wide-path HLL
    hashes -0.0 apart from +0.0: tests/test_torch_hll.py)."""
    x = rng.normal(50.0, 10.0, n)
    picks = rng.integers(0, n, 60)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e300, -1e-300])
    if not signed_zero:
        specials = np.array([0.0, 2.5, np.inf, -np.inf, np.nan, -np.nan, 1e300, -7.0])
    x[picks] = specials[np.arange(60) % len(specials)]
    x[picks[:3]] = np.array([0x7FF0000000000123, 0xFFF4000000000000, 0x7FF8000000000007],
                            dtype=np.uint64).view(np.float64)
    return x


def _summary_case(name):
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    if name == "normal":
        x = rng.normal(size=5000)
        return x, rng.random(5000) >= 0.1, 256, 5000
    if name == "short-last-chunk":
        x = rng.normal(size=1234)
        return x, rng.random(1234) >= 0.1, 256, 5000
    if name == "specials":
        return _special_values(rng, 4000), rng.random(4000) >= 0.05, 64, 4000
    if name == "all-null":
        return rng.normal(size=700), np.zeros(700, bool), 256, 3000
    if name == "empty":
        return np.zeros(0), np.zeros(0, bool), 256, 1
    if name == "exact":  # m < k: every item at weight 1
        return rng.normal(size=100), np.ones(100, bool), 256, 100
    raise ValueError(name)


def _ref_summary(x, valid, k, capacity, batched=False):
    """The reference's wide-path summary of rows padded, as its packer pads
    a short chunk, to ``capacity`` invalid rows."""
    pad = capacity - x.shape[-1]
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    xp = np.pad(x, widths)
    vp = np.pad(valid, widths)
    import jax.numpy as jnp

    fn = ref_kll_device.chunk_summary_batched if batched else ref_kll_device.chunk_summary
    out = fn(jnp.asarray(xp), jnp.asarray(vp), k, capacity, jnp)
    return {key: np.asarray(v) for key, v in out.items()}


@pytest.mark.parametrize(
    "name", ["normal", "short-last-chunk", "specials", "all-null", "empty", "exact"]
)
def test_chunk_summary_bit_identical_to_reference_f64(name):
    x, valid, k, capacity = _summary_case(name)
    want = _ref_summary(x, valid, k, capacity)
    got = kll_device.chunk_summary(torch.from_numpy(x), torch.from_numpy(valid), k, capacity)
    assert set(got) == set(want)
    for key in ("items", "weights"):
        assert _bits_equal(got[key].numpy(), want[key]), key
    for key in ("min", "max"):
        assert _same_or_both_nan(got[key].numpy(), want[key]), key
    assert int(got["count"]) == int(want["count"]) == int(valid.sum())
    assert got["weights"].sum().item() == valid.sum()


def test_chunk_summary_batched_bit_identical_to_reference_f64():
    rng = np.random.default_rng(8)
    X = np.stack([rng.normal(size=3000), _special_values(rng, 3000), rng.uniform(size=3000)])
    M = rng.random(X.shape) >= 0.05
    M[2] = False
    want = _ref_summary(X[:, :2100], M[:, :2100], 128, 3000, batched=True)
    got = kll_device.chunk_summary_batched(
        torch.from_numpy(X[:, :2100].copy()), torch.from_numpy(M[:, :2100].copy()), 128, 3000
    )
    for key in want:
        assert _same_or_both_nan(got[key].numpy(), want[key]), key
    assert _bits_equal(got["items"].numpy(), want["items"])
    for j in range(3):  # each row equals its own single-column summary
        one = kll_device.chunk_summary(torch.from_numpy(X[j, :2100].copy()),
                                       torch.from_numpy(M[j, :2100].copy()), 128, 3000)
        assert _bits_equal(got["items"][j].numpy(), one["items"].numpy())


def test_strata_weight_is_exact_at_powers_of_two():
    for k in (64, 256, 2048):
        for m in [1, k - 1, k, k + 1, 2 * k, 2 * k + 1, 8 * k, 8 * k + 1, 2**20, 2**23 + 3]:
            w, n_strata = kll_device.strata_weight(torch.tensor(m), k)
            w, n_strata = int(w), int(n_strata)
            assert w & (w - 1) == 0 and w * k >= m and (w == 1 or (w // 2) * k < m)
            assert n_strata == m // w
            assert w <= kll_device.strata_capacity(max(m, 1), k)


# -- the suite through both packages ------------------------------------------

ROWS, CHUNK = 10_000, 3_000


def _sketch_table(seed=21):
    rng = np.random.default_rng(seed)
    n = ROWS
    return RefTable([
        ref_column("f", "fractional", rng.normal(10.0, 3.0, n), rng.random(n) >= 0.05),
        ref_column("g", "fractional", _special_values(rng, n, signed_zero=False),
                   rng.random(n) >= 0.02),
        ref_column("i", "integral", rng.integers(-50, 50, n), rng.random(n) >= 0.1),
        ref_column("e", "integral", np.array([2**31 - 1, -(2**31), 2**31, 2**53 + 1, 7])[
            rng.integers(0, 5, n)], np.ones(n, bool)),
        ref_column("w", "integral", rng.integers(-(2**40), 2**40, n), np.ones(n, bool)),
        ref_column("b", "boolean", rng.random(n) < 0.3, rng.random(n) >= 0.1),
        ref_column("s", "string", codes=np.where(rng.random(n) < 0.05, -1,
                                                 rng.integers(0, 40, n)).astype(np.int32),
                   dictionary=[f"cat-{j}" for j in range(40)]),
        ref_column("z", "fractional", np.zeros(n), np.zeros(n, bool)),
    ])


def _specs():
    specs = [("ApproxCountDistinct", (c,), {}) for c in "fgiewbsz"]
    specs += [("ApproxCountDistinct", (c,), {"where": "i > 0"}) for c in "fsb"]
    specs += [
        ("ApproxQuantile", ("f", 0.5), {}),
        ("ApproxQuantile", ("f", 0.9), {}),
        ("ApproxQuantile", ("i", 0.25), {}),
        ("ApproxQuantile", ("e", 0.5), {}),
        ("ApproxQuantile", ("w", 0.75), {}),
        ("ApproxQuantile", ("g", 0.99), {}),
        ("ApproxQuantile", ("f", 0.5), {"where": "i > 0"}),
        ("ApproxQuantile", ("f", 0.3, 0.001), {}),
        ("ApproxQuantile", ("z", 0.5), {}),
        ("ApproxQuantiles", ("g", (0.1, 0.5, 0.9)), {}),
        ("ApproxQuantiles", ("f", (0.01, 0.25, 0.75)), {}),
        ("KLLSketch", ("f",), {}),
        ("KLLSketch", ("g",), {"kll_parameters": "small"}),
    ]
    return specs


def _build(pkg, name, args, kwargs):
    kwargs = dict(kwargs)
    if kwargs.get("kll_parameters") == "small":
        kwargs["kll_parameters"] = pkg.KLLParameters(64, 0.64, 10)
    return getattr(pkg, name)(*args, **kwargs)


_SUITE = {}


def _suite_results(mode, monkeypatch):
    """Both packages' metrics on the sketch table (once per mode), and the
    port's scan counters."""
    if mode not in _SUITE:
        if mode == "f64":
            monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
        monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: CHUNK)
        monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: CHUNK)
        ref = _sketch_table()
        specs = _specs()
        ref_list = [_build(ref_analyzers, *s) for s in specs]
        port_list = [_build(port_analyzers, *s) for s in specs]
        with use_mesh(None):
            ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
        port_scan_engine.SCAN_STATS.reset()
        port_ctx = PortRunner.do_analysis_run(port_table(ref), port_list, device="cpu")
        stats = port_scan_engine.SCAN_STATS.snapshot()
        _SUITE[mode] = (specs, [(ref_ctx.metric(r), port_ctx.metric(p))
                                for r, p in zip(ref_list, port_list)], stats)
    return _SUITE[mode]


def _assert_sketch_metric(ref_metric, port_metric, rel):
    """A sketch metric of both packages: the same failure, or values equal
    within ``rel`` (0: bit for bit)."""
    assert (port_metric.name, port_metric.instance) == (ref_metric.name, ref_metric.instance)
    if not ref_metric.value.is_success:
        assert_metric_parity(ref_metric, port_metric)
        return
    if isinstance(ref_metric.value.get(), float):
        a, b = ref_metric.value.get(), port_metric.value.get()
        if rel == 0.0 or ref_metric.name == "ApproxCountDistinct":
            assert _bits_equal(a, b), (ref_metric, a, b)
            return
        assert a == b or abs(a - b) <= rel * max(abs(a), abs(b)), (ref_metric, a, b)
        return
    want, got = ref_metric.value.get(), port_metric.value.get()
    if isinstance(want, dict):
        assert list(got) == list(want)
        for q in want:
            a, b = want[q], got[q]
            assert (_bits_equal(a, b) if rel == 0.0
                    else a == b or abs(a - b) <= rel * max(abs(a), abs(b))), (q, a, b)
        return
    # KLLMetric: buckets, sketch parameters and compactors
    assert got.parameters == want.parameters
    if rel == 0.0:
        assert [b.count for b in got.buckets] == [b.count for b in want.buckets]
        edges = lambda d: [(b.low_value, b.high_value) for b in d.buckets]
        assert _same_or_both_nan(edges(got), edges(want))
        assert len(got.data) == len(want.data)
        for a, b in zip(got.data, want.data):
            assert _bits_equal(a, b)
    else:
        total = sum(b.count for b in want.buckets)
        assert sum(b.count for b in got.buckets) == total
        assert [len(d) for d in got.data] == [len(d) for d in want.data]


CASES = list(range(len(_specs())))


@pytest.mark.parametrize("mode", ["f64", "pairs"])
@pytest.mark.parametrize("index", CASES, ids=[
    f"{n}-{'-'.join(map(str, a))}{'-where' if 'where' in k else ''}" for n, a, k in _specs()])
def test_sketch_analyzer_parity(parity_env, monkeypatch, mode, index):
    specs, pairs, _ = _suite_results(mode, monkeypatch)
    ref_metric, port_metric = pairs[index]
    _assert_sketch_metric(ref_metric, port_metric, 0.0 if mode == "f64" else PAIR_QUANTILE_REL)


def test_sketch_suite_is_one_fused_pass_with_batched_sorts(parity_env, monkeypatch):
    specs, pairs, stats = _suite_results("f64", monkeypatch)
    chunks = -(-ROWS // CHUNK)
    assert stats["scan_passes"] == 1 and stats["device_fetches"] == 1
    assert stats["chunks_processed"] == chunks
    # per chunk: one batched sort of the k=256 where-free columns
    # (f, i, e, w, g, z: once each), one for f at relative error 0.001, one
    # for the k=2048 KLLSketch, one for the k=64 KLLSketch, one filtered
    assert stats["kll_sort_passes"] == 5 * chunks
    assert stats["kll_sorted_columns"] == (6 + 4) * chunks
    ok = [m.value.is_success for _, m in pairs]
    assert ok.count(False) == 1  # ApproxQuantile of the all-null column


def test_check_results_agree(parity_env, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    ref = _sketch_table(seed=3)

    def check(pkg):
        return (
            pkg.Check(pkg.CheckLevel.ERROR, "sketches")
            .has_approx_count_distinct("f", lambda v: v > 8000)
            .has_approx_count_distinct("s", lambda v: 35 < v < 45).where("i > 0")
            .has_approx_quantile("f", 0.5, lambda v: 9.0 < v < 11.0)
            .has_approx_quantile("i", 0.9, lambda v: v > 100, relative_error=0.05)
            .kll_sketch_satisfies("f", lambda d: len(d.buckets) == 100)
            .kll_sketch_satisfies("s", lambda d: True)
        )

    with use_mesh(None):
        ref_result = deequ_tpu.VerificationSuite.on_data(ref).add_check(check(deequ_tpu)).run()
    port_result = deequ_tpu_torch.VerificationSuite.on_data(
        port_table(ref), device="cpu").add_check(check(deequ_tpu_torch)).run()
    rows = PortResult.check_results_as_rows(port_result)
    assert rows == RefResult.check_results_as_rows(ref_result)
    assert [r["constraint_status"] for r in rows] == [
        "Success", "Success", "Success", "Failure", "Success", "Failure"]


# -- failure metrics ----------------------------------------------------------

FAILING = [
    ("ApproxQuantile", ("f", 1.5), {}),
    ("ApproxQuantile", ("f", 0.0), {}),
    ("ApproxQuantile", ("f", 0.5, 2.0), {}),
    ("ApproxQuantile", ("s", 0.5), {}),
    ("ApproxQuantile", ("nope", 0.5), {}),
    ("ApproxQuantiles", ("f", ()), {}),
    ("ApproxQuantiles", ("f", (0.5, 1.0)), {}),
    ("ApproxQuantiles", ("b", (0.5,)), {}),
    ("ApproxCountDistinct", ("nope",), {}),
    ("ApproxCountDistinct", ("z",), {}),
    ("KLLSketch", ("f",), {"kll_parameters": "too-many-buckets"}),
    ("KLLSketch", ("s",), {}),
    ("KLLSketch", ("z",), {}),
    ("ApproxQuantile", ("f", 0.5), {"where": "nope > 1"}),
]


@pytest.mark.parametrize("spec", FAILING, ids=[
    f"{n}-{'-'.join(map(str, a))}{'-' + '-'.join(map(str, k.values())) if k else ''}"
    for n, a, k in FAILING])
def test_failure_metrics_agree(parity_env, spec):
    name, args, kwargs = spec

    def build(pkg):
        kw = dict(kwargs)
        if kw.get("kll_parameters") == "too-many-buckets":
            kw["kll_parameters"] = pkg.KLLParameters(number_of_buckets=101)
        return getattr(pkg, name)(*args, **kw)

    ref = _sketch_table(seed=4)
    with use_mesh(None):
        ref_metric = build(ref_analyzers).calculate(ref)
    port_metric = build(port_analyzers).calculate(port_table(ref), "cpu")
    if name == "ApproxCountDistinct" and args == ("z",):
        # an all-null column: the estimate of empty registers, 0
        assert port_metric.value.get() == ref_metric.value.get() == 0.0
        return
    assert not ref_metric.value.is_success
    _assert_sketch_metric(ref_metric, port_metric, 0.0)


def test_quantile_type_errors_raise_at_construction():
    for pkg in (ref_analyzers, port_analyzers):
        for bad in (float("nan"), "0.5", True):
            with pytest.raises(Exception) as info:
                pkg.ApproxQuantile("f", bad)
            assert type(info.value).__name__ == "IllegalAnalyzerParameterException"
        with pytest.raises(Exception) as info:
            pkg.ApproxQuantiles("f", (0.5, float("nan")))
        assert "must not be NaN" in str(info.value)
    assert port_analyzers.ApproxQuantiles("f", (0.5, 0.1, 0.5)).quantiles == (0.5, 0.1)


# -- coalescing ---------------------------------------------------------------


def test_kll_op_coalescing_matches_individual_results(parity_env):
    rng = np.random.default_rng(17)
    n, k_cols = 20_000, 6
    ref = RefTable([ref_column(f"c{i}", "fractional", rng.normal(10 * i, 3, n))
                    for i in range(k_cols)])
    table = port_table(ref)
    quants = [port_analyzers.ApproxQuantile(f"c{i}", q) for i in range(k_cols)
              for q in (0.5, 0.9)]
    analyzers = [port_analyzers.Size(), port_analyzers.Mean("c0")] + quants
    port_scan_engine.SCAN_STATS.reset()
    ctx = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    stats = port_scan_engine.SCAN_STATS.snapshot()
    assert stats["scan_passes"] == 1
    assert (stats["kll_sort_passes"], stats["kll_sorted_columns"]) == (1, k_cols)
    for a in quants:
        solo = PortRunner.do_analysis_run(table, [a], device="cpu").metric(a).value.get()
        assert ctx.metric(a).value.get() == solo
    assert abs(ctx.metric(quants[4]).value.get() - 20) < 0.5

    w = port_analyzers.ApproxQuantile("c1", 0.5, where="c0 > 2")
    ctx2 = PortRunner.do_analysis_run(table, [w] + quants, device="cpu")
    solo = PortRunner.do_analysis_run(table, [w], device="cpu").metric(w).value.get()
    assert ctx2.metric(w).value.get() == solo != ctx2.metric(quants[2]).value.get()


# -- the reference's KLL goldens and properties, through the port ------------

_KLL_GOLDEN = {
    0.01: -2.33797989959002,
    0.25: -0.6690293162886349,
    0.5: 0.0008542768130695202,
    0.75: 0.6836562750337061,
    0.99: 2.421409868961832,
}


def _rank_error(sketch, data):
    data_sorted = np.sort(data)
    n = len(data)
    errs = []
    for q in np.linspace(0.01, 0.99, 25):
        value = data_sorted[int(q * (n - 1))]
        errs.append(abs(sketch.rank(value) - np.searchsorted(data_sorted, value, "right")) / n)
    return max(errs)


def test_kll_golden_quantiles_and_rank_error():
    data = np.random.default_rng(123).normal(0.0, 1.0, 100_000)
    sk = KLLSketchState(256, 0.64)
    sk.update_batch(data)
    sorted_d = np.sort(data)
    for q, want in _KLL_GOLDEN.items():
        assert sk.quantile(q) == want, q
        rank = np.searchsorted(sorted_d, want, side="right") / len(data)
        assert abs(rank - q) <= 0.01


def test_kll_exact_rank_rule():
    import math

    data = np.arange(100, dtype=np.float64) + 0.5
    np.random.default_rng(7).shuffle(data)
    sk = KLLSketchState(256, 0.64)
    sk.update_batch(data)
    for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert sk.quantile(q) == np.sort(data)[max(0, math.ceil(q * 100) - 1)], q


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_kll_rank_accuracy(dist):
    rng = np.random.default_rng(0 if dist == "uniform" else 1)
    data = rng.uniform(0, 1, 100_000) if dist == "uniform" else rng.lognormal(0, 2, 100_000)
    sketch = KLLSketchState()
    sketch.update_batch(data)
    assert _rank_error(sketch, data) < 0.02


def test_kll_merge_weight_serde_empty_and_capacity():
    a, b = KLLSketchState(sketch_size=64), KLLSketchState(sketch_size=64)
    a.update_batch(np.arange(7777, dtype=float))
    b.update_batch(np.arange(3333, dtype=float))
    assert a.merge(b).rank(1e12) == 7777 + 3333
    rng = np.random.default_rng(4)
    sk = KLLSketchState(sketch_size=256, shrinking_factor=0.5)
    sk.update_batch(rng.normal(size=20_000))
    back = KLLSketchState.deserialize(sk.serialize())
    assert (back.count, back.sketch_size, back.shrinking_factor) == (sk.count, 256, 0.5)
    assert all(back.quantile(q) == sk.quantile(q) for q in (0.1, 0.5, 0.9))
    empty = KLLSketchState()
    assert np.isnan(empty.quantile(0.5)) and empty.rank(10.0) == 0 and empty.count == 0
    grow = KLLSketchState(sketch_size=64)
    for _ in range(40):
        grow.update_batch(rng.normal(size=500))
        assert all(len(c) <= grow._capacity(lvl) for lvl, c in enumerate(grow.compactors))


def test_kll_rng_position_round_trips():
    rng = np.random.default_rng(7)
    a_data, b_data = rng.normal(0, 1, 30_000), rng.normal(0, 1, 30_000)
    live = KLLSketchState(sketch_size=128)
    live.update_batch(a_data)
    resumed = KLLSketchState.deserialize(live.serialize())
    assert resumed.rng_count == live.rng_count
    live.update_batch(b_data)
    resumed.update_batch(b_data)
    assert live.rng_count == resumed.rng_count
    assert all(np.array_equal(x, y) for x, y in zip(live.compactors, resumed.compactors))


def test_port_kll_sketch_matches_reference_host_sketch():
    """The copied host sketch makes the reference's every decision."""
    from deequ_tpu.ops.kll import KLLSketchState as RefSketch

    rng = np.random.default_rng(9)
    port, ref = KLLSketchState(128, 0.64), RefSketch(128, 0.64)
    for _ in range(6):
        batch = rng.normal(size=7000)
        port.update_batch(batch)
        ref.update_batch(batch)
    assert port.rng_count == ref.rng_count and port.count == ref.count
    assert all(_bits_equal(a, b) for a, b in zip(port.compactors, ref.compactors))


def test_bucket_distribution_percentiles_and_where_mask(parity_env):
    rng = np.random.default_rng(29)
    vals = rng.uniform(0, 100, 20_000)
    flag = rng.integers(0, 2, 20_000).astype(np.float64)
    ref = RefTable([ref_column("v", "fractional", vals), ref_column("flag", "fractional", flag)])
    table = port_table(ref)
    dist = port_analyzers.KLLSketch("v").calculate(table, "cpu").value.get()
    percentiles = dist.compute_percentiles()
    assert len(percentiles) == 100 and percentiles == sorted(percentiles)
    assert abs(percentiles[49] - 50) < 2
    est = port_analyzers.ApproxQuantile("v", 0.5, where="flag > 0.5").calculate(
        table, "cpu").value.get()
    filtered = port_analyzers.ApproxQuantile("v", 0.5).calculate(
        port_table(ref.filter_rows(flag > 0.5)), "cpu").value.get()
    assert est == filtered
    assert abs(est - np.quantile(vals[flag > 0.5], 0.5)) < 1.0


# -- states carried across ----------------------------------------------------


def _halves():
    rng = np.random.default_rng(31)
    a = RefTable([ref_column("x", "fractional", rng.normal(0, 1, 6000), rng.random(6000) > 0.1)])
    b = RefTable([ref_column("x", "fractional", rng.normal(3, 2, 5000))])
    return a, b


def test_hll_state_carried_across_merges_as_the_reference(parity_env):
    a, b = _halves()
    with use_mesh(None):
        ref_a = ref_analyzers.ApproxCountDistinct("x").compute_state_from(a)
        ref_b = ref_analyzers.ApproxCountDistinct("x").compute_state_from(b)
    carried = state_from_fields("ApproxCountDistinctState", {
        "registers": ref_a.registers, "hash_version": ref_a.hash_version})
    port_b = port_analyzers.ApproxCountDistinct("x").compute_state_from(port_table(b), "cpu")
    merged = carried.sum(port_b)
    assert merged.registers == ref_a.sum(ref_b).registers
    assert merged.metric_value() == ref_a.sum(ref_b).metric_value()
    with pytest.raises(ValueError, match="different suites"):
        state_from_fields("ApproxCountDistinctState", {
            "registers": ref_a.registers, "hash_version": 1}).sum(port_b)


def test_kll_state_carried_across_merges_as_the_reference(parity_env, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    a, b = _halves()
    analyzer = ("ApproxQuantile", ("x", 0.5), {})
    with use_mesh(None):
        ref_a = _build(ref_analyzers, *analyzer).compute_state_from(a)
        ref_b = _build(ref_analyzers, *analyzer).compute_state_from(b)
    sk = ref_a.sketch
    carried = state_from_fields("KLLState", {
        "compactors": sk.compactors, "count": sk.count, "rng_count": sk.rng_count,
        "sketch_size": sk.sketch_size, "shrinking_factor": sk.shrinking_factor,
        "global_min": ref_a.global_min, "global_max": ref_a.global_max})
    port_b = _build(port_analyzers, *analyzer).compute_state_from(port_table(b), "cpu")
    merged, want = carried.sum(port_b), ref_a.sum(ref_b)
    assert (merged.global_min, merged.global_max) == (want.global_min, want.global_max)
    assert (merged.sketch.count, merged.sketch.rng_count) == (want.sketch.count,
                                                              want.sketch.rng_count)
    assert all(_bits_equal(x, y) for x, y in zip(merged.sketch.compactors,
                                                 want.sketch.compactors))
    assert merged.sketch.quantile(0.5) == want.sketch.quantile(0.5)


def test_cpu_sketch_run_launches_no_kernel(parity_env):
    before = hll.LAUNCHES
    table = deequ_tpu_torch.ColumnarTable.from_pydict({"x": [1.0, 2.0, 2.0], "s": ["a", "b", None]})
    check = (deequ_tpu_torch.Check(deequ_tpu_torch.CheckLevel.ERROR, "c")
             .has_approx_count_distinct("x", lambda v: v == 2)
             .has_approx_count_distinct("s", lambda v: v == 2))
    result = deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu").add_check(check).run()
    assert result.status == deequ_tpu_torch.CheckStatus.SUCCESS
    assert hll.LAUNCHES == before
