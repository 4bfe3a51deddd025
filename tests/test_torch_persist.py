"""Device residency in the port — ``ColumnarTable.persist()`` /
``unpersist()``, ``scan_engine.persist_table`` and ``DeviceTableCache``,
the resident branch of ``run_scan`` and the resident string grouping of
``ops/segment.py`` — on the CPU, against the port's streaming runs and
the reference's persisted runs.

Bounds: a persisted run cuts the table as a streaming run of the same
``chunk_rows`` does, so its metrics are bit-identical to it; the
reference's own persisted runs agree under ``tests/torch_parity.py``'s
bounds (exact counts and grouping statistics, 1e-12 relative for sums,
means and entropy — the resident count statistics reduce on the device —,
1e-10 for standard deviation and correlation).
"""

import numpy as np
import pytest
import torch

import deequ_tpu
import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.scan_engine as ref_scan_engine
import deequ_tpu.ops.segment as ref_segment
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.scan_engine as port_scan_engine
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu.verification import VerificationResult as RefResult
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.exceptions import DeviceUnavailableException
from deequ_tpu_torch.ops import segment
from deequ_tpu_torch.ops.scan_engine import (
    SCAN_STATS,
    _resident_cache,
    persist_table,
    run_scan,
    total_resident_bytes,
)
from deequ_tpu_torch.verification import VerificationResult as PortResult
from torch_parity import (  # noqa: F401
    assert_metric_parity,
    parity_env,
    port_table,
    ref_column,
    smoke_schema_table,
)

pytestmark = pytest.mark.torch_port

BUDGET = 1 << 30


@pytest.fixture(autouse=True)
def _no_residency_left():
    """Each test starts with nothing resident, whatever the last one left."""
    for cache in list(port_scan_engine._ACTIVE_CACHES):
        cache.device_chunks, cache.nbytes = [], 0
        port_scan_engine._ACTIVE_CACHES.discard(cache)
    yield


def _numeric_table(seed=11, n=4096):
    rng = np.random.default_rng(seed)
    mask = np.ones(n, dtype=bool)
    mask[rng.integers(0, n, 40)] = False
    return ColumnarTable([
        Column("a", DType.FRACTIONAL, values=rng.normal(5.0, 2.0, n), mask=mask),
        Column("b", DType.INTEGRAL, values=rng.integers(0, 1000, n)),
        Column("s", DType.STRING, codes=rng.integers(-1, 12, n).astype(np.int32),
               dictionary=np.array([f"v{i}" for i in range(12)], dtype=object)),
    ])


def _analyzers(pkg):
    return [
        pkg.Size(), pkg.Completeness("a"), pkg.Mean("a"), pkg.StandardDeviation("a"),
        pkg.Minimum("b"), pkg.Maximum("b"), pkg.Sum("b"), pkg.Correlation("a", "b"),
        pkg.ApproxCountDistinct("s"), pkg.ApproxQuantile("a", 0.5),
        pkg.Compliance("a big", "a > 5"), pkg.Uniqueness(["s"]), pkg.Entropy("s"),
        pkg.Histogram("s"), pkg.Distinctness(["b"]),
    ]


def _dist(d):
    return d.number_of_bins, {k: (v.absolute, v.ratio) for k, v in d.values.items()}


def _assert_same_metrics(want_ctx, got_ctx, analyzers):
    """Bit for bit, but Entropy within 1e-12 relative: the resident count
    statistics reduce it on the device, in another order than the host."""
    for a in analyzers:
        want, got = want_ctx.metric(a), got_ctx.metric(a)
        if isinstance(want.value.get(), float):
            assert_metric_parity(want, got)
        else:
            assert got.value.get() == want.value.get(), a


def test_persisted_table_scans_from_resident_chunks(parity_env):
    """Twin of tests/test_scan_fusion.py::test_persisted_table_scans_from_hbm:
    a persisted run packs nothing, reads the resident chunks and gives the
    streaming run's metrics."""
    table = _numeric_table()
    analyzers = _analyzers(port_analyzers)
    with use_device("cpu"):
        streamed = PortRunner.do_analysis_run(table, analyzers)
        table.persist(max_bytes=BUDGET)
        assert table.is_persisted
        nbytes = table._device_cache.nbytes
        assert nbytes == total_resident_bytes() > 0
        for _ in range(2):  # any number of runs
            SCAN_STATS.reset()
            resident = PortRunner.do_analysis_run(table, analyzers)
            assert SCAN_STATS.scan_passes == 1 and SCAN_STATS.resident_passes == 1
            assert SCAN_STATS.bytes_packed == 0
            assert SCAN_STATS.bytes_resident == nbytes
            assert SCAN_STATS.last_scan_fetches == 1
            _assert_same_metrics(streamed, resident, analyzers)
        table.unpersist()
    assert not table.is_persisted


def test_resident_chunks_cut_as_the_reference_persists(monkeypatch):
    """persist_table sizes chunks by the reference's resident rule, and a
    scan asked for other chunk rows streams."""
    seen = []

    def rule(cols, target_bytes=0, max_rows=0):
        seen.append((target_bytes, max_rows))
        return 1000

    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", rule)
    table = _numeric_table()
    cache = persist_table(table, "cpu", max_bytes=BUDGET)
    assert seen == [(2 << 30, 1 << 25)]
    assert cache.chunk == 1000 and len(cache.device_chunks) == 5
    assert cache.device_chunks[-1][0].shape[1] == 96  # the last chunk is short
    op = port_analyzers.Sum("a").scan_op(table)
    SCAN_STATS.reset()
    run_scan(table, [op], "cpu", chunk_rows=1000)
    assert SCAN_STATS.resident_passes == 1 and SCAN_STATS.chunks_processed == 5
    SCAN_STATS.reset()
    run_scan(table, [op], "cpu", chunk_rows=512)
    assert SCAN_STATS.resident_passes == 0 and SCAN_STATS.bytes_packed > 0
    table.unpersist()


def test_budget_raises_memory_error():
    a, b = _numeric_table(1), _numeric_table(2)
    with pytest.raises(MemoryError):
        a.persist("cpu", max_bytes=1000)
    assert not a.is_persisted and total_resident_bytes() == 0
    a.persist("cpu", max_bytes=BUDGET)
    one = total_resident_bytes()
    # the budget covers every persisted table together
    with pytest.raises(MemoryError):
        b.persist("cpu", max_bytes=one + one // 2)
    assert not b.is_persisted and total_resident_bytes() == one
    b.persist("cpu", max_bytes=2 * one)
    assert total_resident_bytes() == 2 * one
    a.unpersist()
    b.unpersist()


def test_budget_is_each_devices_own():
    """A table resident on another device takes nothing of this device's
    budget. The CPU build has no second card, so the first table's cache
    is relabelled as lying on one; its bytes and accounting are real."""
    a, b = _numeric_table(1), _numeric_table(2)
    a.persist("cpu", max_bytes=BUDGET)
    one = total_resident_bytes("cpu")
    a._device_cache.device = torch.device("cuda", 1)
    assert total_resident_bytes("cpu") == 0
    assert total_resident_bytes(torch.device("cuda", 1)) == one
    b.persist("cpu", max_bytes=one + one // 2)  # would not fit beside a on one device
    assert total_resident_bytes("cpu") == one and total_resident_bytes() == 2 * one
    a._device_cache.device = torch.device("cpu")
    with pytest.raises(MemoryError):  # both on the CPU: b no longer fits
        b.persist("cpu", max_bytes=one + one // 2)
    a.unpersist()
    b.unpersist()
    assert total_resident_bytes() == 0


def test_unpersist_zeroes_the_accounting():
    table = _numeric_table()
    table.persist("cpu", max_bytes=BUDGET)
    cache = table._device_cache
    table.persist("cpu", max_bytes=BUDGET)  # persisting again replaces, never adds
    assert total_resident_bytes() == table._device_cache.nbytes
    assert cache.nbytes == 0 and cache.device_chunks == []
    table.unpersist()
    assert total_resident_bytes() == 0 and not table.is_persisted
    table.unpersist()  # a second unpersist is a no-op


def test_persist_resolves_its_device_as_every_entry_point():
    table = _numeric_table()
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableException):
            table.persist(max_bytes=BUDGET)
    with use_device("cpu"), pytest.raises(ValueError, match="max_bytes"):
        table.persist()
    assert not table.is_persisted


def test_device_or_column_mismatch_streams(parity_env):
    table = _numeric_table()
    table.persist("cpu", max_bytes=BUDGET)
    cache = table._device_cache
    # another device never reads these chunks
    assert _resident_cache(table, torch.device("cuda", 0), ["a"], None) is None
    assert not cache.matches(torch.device("meta"), ["a"])
    # a column the cache does not hold streams the whole scan from the host
    wider = ColumnarTable(list(table.columns.values()) + [
        Column("c", DType.FRACTIONAL, values=np.arange(table.num_rows, dtype=np.float64))])
    wider._device_cache = cache
    SCAN_STATS.reset()
    with use_device("cpu"):
        ctx = PortRunner.do_analysis_run(wider, [port_analyzers.Sum("c"),
                                                 port_analyzers.Sum("a")])
    assert SCAN_STATS.resident_passes == 0 and SCAN_STATS.bytes_packed > 0
    assert ctx.metric(port_analyzers.Sum("c")).value.get() == float(
        np.arange(table.num_rows).sum())
    SCAN_STATS.reset()
    with use_device("cpu"):
        PortRunner.do_analysis_run(wider, [port_analyzers.Sum("a")])
    assert SCAN_STATS.resident_passes == 1
    table.unpersist()


# -- resident grouping --------------------------------------------------------


def _grouping_table(nullvalue: bool):
    rng = np.random.default_rng(31)
    n = 5000
    labels = [f"g{i}" for i in range(40)] + (["NullValue"] if nullvalue else [])
    codes = rng.integers(-1, len(labels), n).astype(np.int32)
    codes[:700] = 3  # one heavy group
    return RefTable([
        ref_column("s", "string", codes=codes, dictionary=labels),
        ref_column("x", "fractional", rng.normal(0, 1, n), np.ones(n, bool)),
    ])


@pytest.mark.parametrize("nullvalue", [False, True], ids=["plain", "literal-NullValue"])
@pytest.mark.parametrize("k", [5, 100])
def test_resident_group_top_k_matches_streaming_and_reference(parity_env, nullvalue, k):
    ref = _grouping_table(nullvalue)
    port = port_table(ref)
    streamed = segment.group_top_k(port, "s", k, "cpu")
    port.persist("cpu", max_bytes=BUDGET)
    SCAN_STATS.reset()
    resident = segment.group_top_k(port, "s", k, "cpu")
    assert SCAN_STATS.hist_plain_dispatches == len(port._device_cache.device_chunks)
    port.unpersist()
    with use_mesh(None):
        ref.persist()
        ref_top = ref_segment.group_top_k(ref, "s", k)
        ref.unpersist()
    assert resident == streamed
    assert (resident.num_rows, resident.num_groups) == (ref_top.num_rows, ref_top.num_groups)
    assert resident.top == ref_top.top


@pytest.mark.parametrize("require_any_non_null", [True, False])
def test_resident_group_count_stats_match_streaming_and_reference(
        parity_env, monkeypatch, require_any_non_null):
    """Four scalars from the resident codes (one fetch of 32 bytes): exact
    counts, entropy within 1e-12 relative; several resident chunks."""
    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 1500)
    monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 1500)
    ref = _grouping_table(False)
    port = port_table(ref)
    streamed = segment.group_count_stats(port, ["s"], "cpu", require_any_non_null)
    port.persist("cpu", max_bytes=BUDGET)
    SCAN_STATS.reset()
    resident = segment.group_count_stats(port, ["s"], "cpu", require_any_non_null)
    assert SCAN_STATS.device_fetches == 1 and SCAN_STATS.bytes_fetched == 32
    assert SCAN_STATS.hist_plain_dispatches == 4  # one K5 count a resident chunk
    port.unpersist()
    with use_mesh(None):
        ref.persist()
        ref_stats = ref_segment.group_count_stats(ref, ["s"], None, require_any_non_null)
        ref.unpersist()
    for stats in (streamed, ref_stats):
        assert (resident.num_rows, resident.num_groups, resident.singletons) == (
            stats.num_rows, stats.num_groups, stats.singletons)
        assert abs(resident.entropy - stats.entropy) <= 1e-12 * abs(stats.entropy)


def test_numeric_and_multi_column_groupings_stay_on_the_host_route(parity_env):
    port = port_table(_grouping_table(False))
    port.persist("cpu", max_bytes=BUDGET)
    assert segment._resident_string_bincount(port, "x", True, "cpu") is None
    assert segment._resident_string_bincount(port, "s", True, torch.device("meta")) is None
    SCAN_STATS.reset()
    segment.group_count_stats(port, ["s", "x"], "cpu")
    assert SCAN_STATS.bytes_fetched > 32
    port.unpersist()


# -- whole suites through both packages, persisted on both sides ---------------


def _quantile_check(pkg, base):
    return (base.has_approx_quantile("f0", 0.5, lambda v: True)
            .has_approx_quantile("customer_id", 0.9, lambda v: True)
            .has_approx_count_distinct("region", lambda v: v > 0)
            .has_histogram_values("status", lambda d: True))


def test_whole_suite_persisted_on_both_sides(parity_env, monkeypatch):
    """The chip-smoke check set plus quantiles, ApproxCountDistinct and a
    Histogram through both packages over persisted tables in 3,000-row
    chunks (the reference under DEEQU_TPU_COMPUTE=f64, whose quantiles
    sort and equal the port's select bit for bit)."""
    from test_torch_verification import _smoke_check

    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 3000)
    monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 3000)
    ref = smoke_schema_table(10_000, seed=8)
    port = port_table(ref)
    with use_mesh(None):
        ref.persist()
        ref_result = deequ_tpu.VerificationSuite.on_data(ref).add_check(
            _quantile_check(deequ_tpu, _smoke_check(deequ_tpu))).run()
        ref.unpersist()
    port.persist("cpu", max_bytes=BUDGET)
    SCAN_STATS.reset()
    port_result = deequ_tpu_torch.VerificationSuite.on_data(port, device="cpu").add_check(
        _quantile_check(deequ_tpu_torch, _smoke_check(deequ_tpu_torch))).run()
    stats = SCAN_STATS.snapshot()
    port.unpersist()
    assert stats["resident_passes"] == 1 and stats["bytes_packed"] == 0
    assert stats["device_select_passes"] == 4 and stats["device_sort_passes"] > 0  # grouping sorts
    assert PortResult.check_results_as_rows(port_result) == RefResult.check_results_as_rows(
        ref_result)
    ref_metrics = {repr(a): m for a, m in ref_result.metrics.items()}
    port_metrics = {repr(a): m for a, m in port_result.metrics.items()}
    assert set(port_metrics) == set(ref_metrics)
    for key, ref_metric in ref_metrics.items():
        if ref_metric.name == "Histogram":
            assert _dist(port_metrics[key].value.get()) == _dist(ref_metric.value.get())
        else:
            assert_metric_parity(ref_metric, port_metrics[key])


def test_persisted_runner_matches_reference_persisted_runner(parity_env):
    """The analyzer set of the streaming twin, through both runners over
    persisted tables (reference on one device, its default layout): the
    same metrics under the parity bounds."""
    ref = RefTable([
        ref_column(c.name, c.dtype.value, values=c.values, mask=c.mask)
        if c.dtype != DType.STRING else
        ref_column(c.name, "string", codes=c.codes, dictionary=c.dictionary)
        for c in _numeric_table().columns.values()
    ])
    port = port_table(ref)
    ref_list = [a for a in _analyzers(ref_analyzers) if type(a).__name__ != "ApproxQuantile"]
    port_list = [a for a in _analyzers(port_analyzers) if type(a).__name__ != "ApproxQuantile"]
    with use_mesh(None):
        ref.persist()
        ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
        ref.unpersist()
    port.persist("cpu", max_bytes=BUDGET)
    port_ctx = PortRunner.do_analysis_run(port, port_list, device="cpu")
    port.unpersist()
    for r, p in zip(ref_list, port_list):
        if type(r).__name__ == "Histogram":
            assert _dist(port_ctx.metric(p).value.get()) == _dist(ref_ctx.metric(r).value.get())
        else:
            assert_metric_parity(ref_ctx.metric(r), port_ctx.metric(p))
