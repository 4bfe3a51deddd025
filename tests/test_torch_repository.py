"""The port's metrics repositories, queries and quality monitor
(``deequ_tpu_torch/repository``) against the reference's
(``deequ_tpu/repository``): the port twin of tests/test_repository.py and
tests/test_metrics_repo.py.

The same saves go through both packages on the CPU, held to:

- serde: the port's JSON of every analyzer and metric equals the
  reference's byte for byte, and each package decodes the other's;
- loader results bit-identical across the memory, filesystem and
  columnar backends, and to the reference's on the same saves;
- query aggregates bit-identical to the loader-side baseline and to the
  decoded query, and against the reference's query on the same saves:
  count/min/max exact, sum/mean within 1e-12 relative, stddev within
  1e-10;
- monitor kill-and-resume: states and alerts identical to the
  uninterrupted run;
- cross-package reads: a ``FileSystemMetricsRepository`` file, a
  ``ColumnarMetricsRepository`` directory and a monitor checkpoint
  written by one package are read by the other with identical loader
  results and alerts, in both directions;
- the monitor's observability and serving seams: the execution report's
  ``repository`` section, the ``quality_alert`` event and the alerts a
  ``VerificationService(monitor=...)`` raises, each equal to the
  reference's over the same stream.
"""

import contextlib
import json
import math
import os
import struct

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_an
import deequ_tpu.metrics as ref_metrics
import deequ_tpu.repository as ref_repo
import deequ_tpu.repository.serde as ref_serde
import deequ_tpu.tryresult as ref_try
import deequ_tpu_torch.analyzers as port_an
import deequ_tpu_torch.metrics as port_metrics
import deequ_tpu_torch.repository as port_repo
import deequ_tpu_torch.tryresult as port_try
from deequ_tpu.analyzers.runner import AnalyzerContext as RefContext
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import Completeness, Mean, Size
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
from deequ_tpu_torch.exceptions import CorruptStateException, EnvConfigError
from deequ_tpu_torch.metrics import DoubleMetric, Entity
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.repository import (
    AnalysisResult,
    ColumnarMetricsRepository,
    InMemoryMetricsRepository,
    QualityMonitor,
    RepositoryQuery,
    ResultKey,
)
from deequ_tpu_torch.repository import serde
from deequ_tpu_torch.repository.columnar import REPO_STATS
from deequ_tpu_torch.repository.monitor import MONITOR_STATS
from deequ_tpu_torch.repository.query import loader_side_aggregates, run_repository_query
from deequ_tpu_torch.tryresult import Success
from tests.torch_parity import port_table

pytestmark = pytest.mark.torch_port

#: the query's bounds against the reference (tests/torch_parity.py's):
#: the reference sums the value plane in f32 pairs, the port in f64
QUERY_REL = {"count": 0.0, "min": 0.0, "max": 0.0, "completeness": 0.0,
             "sum": 1e-12, "mean": 1e-12, "stddev": 1e-10}


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _bits(v: float) -> bytes:
    return struct.pack("<d", float(v))


# -- helpers over both packages ----------------------------------------------

PKGS = {
    "port": (port_an, port_metrics, port_repo, port_try),
    "ref": (ref_an, ref_metrics, ref_repo, ref_try),
}


def _scalar_result(date, tags, values, pkg="port"):
    """One AnalysisResult of scalar metrics: {column: value} as
    Completeness(column), plus Size = date (tests/test_metrics_repo.py)."""
    an, metrics, repo, tryr = PKGS[pkg]
    metric_map = {}
    for col, v in values.items():
        metric_map[an.Completeness(col)] = metrics.DoubleMetric(
            metrics.Entity.COLUMN, "Completeness", col, tryr.Success(float(v)))
    metric_map[an.Size()] = metrics.DoubleMetric(
        metrics.Entity.DATASET, "Size", "*", tryr.Success(float(date)))
    ctx_cls = AnalyzerContext if pkg == "port" else RefContext
    return repo.AnalysisResult(repo.ResultKey(date, tags), ctx_cls(metric_map))


def _value_repr(value):
    if isinstance(value, float):
        return _bits(value)
    if hasattr(value, "buckets"):
        return ([(b.low_value, b.high_value, b.count) for b in value.buckets],
                tuple(value.parameters), value.data)
    if hasattr(value, "values") and hasattr(value, "number_of_bins"):
        return (value.number_of_bins,
                {k: (v.absolute, v.ratio) for k, v in value.values.items()})
    return value


def _result_view(results):
    """Results as comparable plain data: keys, metric_map order, metric
    types and the bits of every value (either package's objects)."""
    out = []
    for r in results:
        rows = []
        for analyzer, metric in r.analyzer_context.metric_map.items():
            ok = metric.value.is_success
            rows.append((repr(analyzer), type(metric).__name__, metric.entity.value,
                         metric.name, metric.instance, ok,
                         _value_repr(metric.value.get()) if ok else None))
        out.append(((r.result_key.data_set_date, tuple(r.result_key.tags)), rows))
    return out


def _assert_results_bit_identical(a, b):
    assert _result_view(a) == _result_view(b)


# -- tests/test_repository.py twins ------------------------------------------

ALL_ANALYZERS = [
    "Size()", "Size(where='x > 2')", "Completeness('col')",
    "Completeness('col', 'x > 1')", "Compliance('rule', 'x > 3')",
    r"PatternMatch('col', r'\d+')", "Minimum('col')", "Maximum('col')",
    "MinLength('col')", "MaxLength('col')", "Mean('col')", "Sum('col')",
    "StandardDeviation('col')", "Correlation('a', 'b')", "DataType('col')",
    "ApproxCountDistinct('col')", "ApproxQuantile('col', 0.5)",
    "ApproxQuantiles('col', [0.25, 0.5])", "KLLSketch('col')",
    "KLLSketch('col', KLLParameters(1024, 0.5, 50))", "Uniqueness(('a', 'b'))",
    "UniqueValueRatio(('a',))", "Distinctness(('a',))",
    "CountDistinct(('a', 'b'))", "Entropy('col')", "MutualInformation('a', 'b')",
    "Histogram('col')",
]


def test_analyzer_serde_roundtrip_identity():
    """Every analyzer round-trips, and the port's JSON is the reference's."""
    for text in ALL_ANALYZERS:
        a_port, a_ref = eval(text, vars(port_an)), eval(text, vars(ref_an))
        data = serde.analyzer_to_json(a_port)
        assert serde.analyzer_from_json(data) == a_port, text
        assert json.dumps(data) == json.dumps(ref_serde.analyzer_to_json(a_ref)), text
        assert repr(ref_serde.analyzer_from_json(data)) == repr(a_ref)


def test_full_result_serde_roundtrip(df_with_numeric_values):
    def run(pkg, runner_mod, table, **kw):
        an = PKGS[pkg][0]
        analyzers = [an.Size(), an.Completeness("att1"), an.Mean("att1"),
                     an.DataType("att1"), an.Uniqueness(("att1",)), an.KLLSketch("att1"),
                     an.ApproxQuantiles("att1", [0.5]), an.Histogram("att1")]
        return runner_mod.AnalysisRunner.do_analysis_run(table, analyzers, **kw)

    import deequ_tpu.analyzers.runner as ref_runner
    import deequ_tpu_torch.analyzers.runner as port_runner

    ctx = run("port", port_runner, port_table(df_with_numeric_values), device="cpu")
    result = AnalysisResult(ResultKey(12345, {"region": "EU"}), ctx)
    text = serde.serialize([result])
    [back] = serde.deserialize(text)
    assert back.result_key == result.result_key
    assert set(back.analyzer_context.metric_map) == set(ctx.metric_map)
    for analyzer, metric in ctx.metric_map.items():
        restored = back.analyzer_context.metric_map[analyzer]
        assert type(restored) is type(metric)
        assert restored.value.is_success == metric.value.is_success
    # the reference reads the port's text and writes it back the same
    [ref_back] = ref_serde.deserialize(text)
    assert ref_serde.serialize([ref_back]) == text
    # and the same run through the reference serialises to the same bytes
    ref_ctx = run("ref", ref_runner, df_with_numeric_values)
    ref_text = ref_serde.serialize([ref_repo.AnalysisResult(
        ref_repo.ResultKey(12345, {"region": "EU"}), ref_ctx)])
    assert json.loads(ref_text)[0]["resultKey"] == json.loads(text)[0]["resultKey"]
    _assert_results_bit_identical(serde.deserialize(ref_text), ref_serde.deserialize(ref_text))


BACKENDS = ["memory", "fs", "columnar", "columnar_fs"]


def _make_repo(kind, tmp_path, pkg="port"):
    repo = PKGS[pkg][2]
    if kind == "memory":
        return repo.InMemoryMetricsRepository()
    if kind == "columnar":
        return repo.ColumnarMetricsRepository()
    if kind == "columnar_fs":
        return repo.ColumnarMetricsRepository(str(tmp_path / f"segments-{pkg}"))
    return repo.FileSystemMetricsRepository(str(tmp_path / f"metrics-{pkg}.json"))


@pytest.fixture(params=BACKENDS)
def repository(request, tmp_path):
    return _make_repo(request.param, tmp_path)


def _make_result(date, tags, value):
    metric = DoubleMetric(Entity.DATASET, "Size", "*", Success(value))
    return AnalysisResult(ResultKey(date, tags), AnalyzerContext({Size(): metric}))


def test_save_and_load_by_key(repository):
    repository.save(_make_result(100, {"env": "test"}, 5.0))
    loaded = repository.load_by_key(ResultKey(100, {"env": "test"}))
    assert loaded is not None
    assert loaded.analyzer_context.metric_map[Size()].value.get() == 5.0
    assert repository.load_by_key(ResultKey(999)) is None


def test_save_overwrites_same_key(repository):
    repository.save(_make_result(100, {}, 5.0))
    repository.save(_make_result(100, {}, 7.0))
    loaded = repository.load_by_key(ResultKey(100, {}))
    assert loaded.analyzer_context.metric_map[Size()].value.get() == 7.0


def test_query_dsl(repository):
    repository.save(_make_result(100, {"env": "dev"}, 1.0))
    repository.save(_make_result(200, {"env": "prod"}, 2.0))
    repository.save(_make_result(300, {"env": "prod"}, 3.0))
    assert len(repository.load().get()) == 3
    assert len(repository.load().after(150).get()) == 2
    assert len(repository.load().before(250).get()) == 2
    assert len(repository.load().after(150).before(250).get()) == 1
    assert len(repository.load().with_tag_values({"env": "prod"}).get()) == 2
    filtered = repository.load().for_analyzers([Completeness("x")]).get()
    assert all(len(r.analyzer_context.metric_map) == 0 for r in filtered)


def test_query_rows_include_tags(repository):
    repository.save(_make_result(100, {"env": "dev"}, 1.0))
    rows = repository.load().get_success_metrics_as_rows()
    assert rows[0]["dataset_date"] == 100
    assert rows[0]["env"] == "dev"
    assert json.loads(repository.load().get_success_metrics_as_json()) == rows


def test_repository_reuse_in_runner(df_with_numeric_values, repository):
    table = port_table(df_with_numeric_values)
    key = ResultKey(42, {})
    analyzers = [Size(), Mean("att1")]
    AnalysisRunner.do_analysis_run(
        table, analyzers, metrics_repository=repository,
        save_or_append_results_with_key=key,
    )
    passes_before = SCAN_STATS.scan_passes
    ctx2 = AnalysisRunner.do_analysis_run(
        table, analyzers, metrics_repository=repository,
        reuse_existing_results_for_key=key,
    )
    assert SCAN_STATS.scan_passes == passes_before
    assert ctx2.metric_map[Size()].value.get() == 6.0
    assert ctx2.metric_map[Mean("att1")].value.get() == 3.5


def test_fail_if_results_missing(df_with_numeric_values, repository):
    from deequ_tpu_torch.exceptions import ReusingNotPossibleResultsMissingException

    with pytest.raises(ReusingNotPossibleResultsMissingException):
        AnalysisRunner.do_analysis_run(
            port_table(df_with_numeric_values), [Size()],
            metrics_repository=repository,
            reuse_existing_results_for_key=ResultKey(1, {}),
            fail_if_results_missing=True,
        )


def test_every_analyzer_metric_round_trips_with_exact_values():
    """The analyzer x metric serde matrix over one mixed fixture: the
    port's run round-trips exactly, and its JSON reads back in the
    reference to the same values."""
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantile, ApproxQuantiles, Compliance,
        Correlation, CountDistinct, DataType, Distinctness, Entropy, Histogram,
        KLLSketch, Maximum, MaxLength, Minimum, MinLength, MutualInformation,
        PatternMatch, StandardDeviation, Sum, Uniqueness, UniqueValueRatio,
    )
    from deequ_tpu_torch.data.table import ColumnarTable

    table = ColumnarTable.from_pydict({
        "col": [1.0, 2.0, 3.0, 4.0, 5.0, None],
        "a": ["x", "y", "x", None, "z", "x"],
        "b": ["1", "2", "3", "4", "5", "6"],
        "s": ["ab", "cde", "", "ab", None, "f"],
        "x": [1, 2, 3, 4, 5, 6],
    })
    analyzers = [
        Size(), Size(where="x > 2"), Completeness("col"), Compliance("rule", "x > 3"),
        PatternMatch("s", r"^[a-z]+$"), Minimum("col"), Maximum("col"),
        MinLength("s"), MaxLength("s"), Mean("col"), Sum("col"),
        StandardDeviation("col"), Correlation("col", "x"), DataType("b"),
        ApproxCountDistinct("a"), ApproxQuantile("col", 0.5),
        ApproxQuantiles("col", [0.25, 0.5, 0.75]), KLLSketch("col"),
        Uniqueness(("a",)), UniqueValueRatio(("a",)), Distinctness(("a",)),
        CountDistinct(("a", "b")), Entropy("a"), MutualInformation(("a", "b")),
        Histogram("a"), Mean("a"), Completeness("nope"),
    ]
    ctx = AnalysisRunner.do_analysis_run(table, analyzers)
    assert set(ctx.metric_map) == set(analyzers)
    text = serde.serialize([AnalysisResult(ResultKey(777, {"env": "test"}), ctx)])
    [back] = serde.deserialize(text)
    restored = back.analyzer_context.metric_map
    assert set(restored) == set(analyzers)
    for analyzer, metric in ctx.metric_map.items():
        r = restored[analyzer]
        assert type(r) is type(metric), analyzer
        assert (r.entity, r.name, r.instance) == (metric.entity, metric.name, metric.instance)
        if metric.value.is_failure:
            assert r.value.is_failure, analyzer
            continue
        v, rv = metric.value.get(), r.value.get()
        if isinstance(v, float):
            assert rv == v or (math.isnan(v) and math.isnan(rv)), analyzer
        elif isinstance(v, dict):
            assert rv == v, analyzer
        elif hasattr(v, "number_of_bins"):
            assert rv.values == v.values and rv.number_of_bins == v.number_of_bins
        elif hasattr(v, "buckets"):
            assert (rv.buckets, rv.parameters, rv.data) == (v.buckets, v.parameters, v.data)
        else:
            assert rv == v, analyzer
    [ref_back] = ref_serde.deserialize(text)
    _assert_results_bit_identical([ref_back], [back])
    assert ref_serde.serialize([ref_back]) == text


def test_nan_and_infinite_values_ride_the_special_encoding():
    """_sanitize/_unsanitize (serde.py:172-182): NaN and +-inf values are
    written as {"__special__": repr} by both packages, the same bytes."""
    values = [float("nan"), float("inf"), -float("inf"), -0.0, 5e-324]
    results = [_scalar_result(i, {"t": "x"}, {"c": v}) for i, v in enumerate(values)]
    refs = [_scalar_result(i, {"t": "x"}, {"c": v}, pkg="ref") for i, v in enumerate(values)]
    text = serde.serialize(results)
    assert text == ref_serde.serialize(refs)
    assert '{"__special__": "nan"}' in text and '{"__special__": "-inf"}' in text
    back = serde.deserialize(text)
    for v, r in zip(values, back):
        got = r.analyzer_context.metric_map[Completeness("c")].value.get()
        assert _bits(got) == _bits(v) or (math.isnan(v) and math.isnan(got))


# -- tests/test_metrics_repo.py twins: the loader contract -------------------


def test_loader_bit_identity_vs_inmemory():
    col, mem, ref_col = ColumnarMetricsRepository(), InMemoryMetricsRepository(), \
        ref_repo.ColumnarMetricsRepository()
    rng = np.random.default_rng(13)
    for d in range(30):
        tags = {"tenant": f"t{d % 5}", "env": "prod" if d % 2 else "dev"}
        values = {"x": rng.random(), "y": rng.random()}
        col.save(_scalar_result(d, tags, values))
        mem.save(_scalar_result(d, tags, values))
        ref_col.save(_scalar_result(d, tags, values, pkg="ref"))
    _assert_results_bit_identical(col.load().get(), mem.load().get())
    _assert_results_bit_identical(col.load().get(), ref_col.load().get())
    for make in (
        lambda repo, an: repo.load().after(10).get(),
        lambda repo, an: repo.load().before(20).get(),
        lambda repo, an: repo.load().with_tag_values({"env": "dev"}).get(),
        lambda repo, an: repo.load().for_analyzers([an.Completeness("x")]).get(),
    ):
        _assert_results_bit_identical(make(col, port_an), make(mem, port_an))
        _assert_results_bit_identical(make(col, port_an), make(ref_col, ref_an))
    key = ResultKey(7, {"tenant": "t2", "env": "prod"})
    _assert_results_bit_identical([col.load_by_key(key)], [mem.load_by_key(key)])
    assert col.load_by_key(ResultKey(999)) is None


def test_every_metric_family_round_trips(df_with_numeric_values):
    from deequ_tpu_torch.analyzers import (
        ApproxQuantiles, DataType, Histogram, KLLSketch, Maximum, Minimum, Uniqueness,
    )

    analyzers = [
        Size(), Completeness("att1"), Mean("att1"), Minimum("att1"), Maximum("att1"),
        DataType("att1"), Uniqueness(("att1",)), KLLSketch("att1"),
        ApproxQuantiles("att1", [0.25, 0.5]), Histogram("att1"),
    ]
    ctx = AnalysisRunner.do_analysis_run(port_table(df_with_numeric_values), analyzers)
    result = AnalysisResult(ResultKey(77, {"region": "EU"}), ctx)
    col, mem = ColumnarMetricsRepository(), InMemoryMetricsRepository()
    col.save(result)
    mem.save(result)
    _assert_results_bit_identical(col.load().get(), mem.load().get())


def test_persisted_round_trip_and_compaction(tmp_path):
    path = str(tmp_path / "repo")
    repo = ColumnarMetricsRepository(path, segment_rows=8)
    for d in range(20):
        repo.save(_scalar_result(d, {"t": "a"}, {"x": d * 0.5}))
    for d in range(5):
        repo.save(_scalar_result(d, {"t": "a"}, {"x": d * 0.5 + 100.0}))
    before = repo.load().get()
    assert repo.num_segments == 25
    assert repo.compact() == 5
    assert repo.num_segments < 25
    _assert_results_bit_identical(repo.load().get(), before)
    _assert_results_bit_identical(ColumnarMetricsRepository(path).load().get(), before)
    # the reference replays the port's compacted directory to the same history
    _assert_results_bit_identical(ref_repo.ColumnarMetricsRepository(path).load().get(), before)


def test_ttl_retention_drops_at_compaction_only(tmp_path, monkeypatch):
    ttl_before = REPO_STATS.ttl_dropped
    path = str(tmp_path / "repo")
    repo = ColumnarMetricsRepository(path, segment_rows=8, ttl=10.0)
    untrimmed = ColumnarMetricsRepository()
    for d in range(30):
        result = _scalar_result(d, {"t": "a"}, {"x": d * 0.25})
        repo.save(result)
        untrimmed.save(result)
    assert len(repo.load().get()) == 30
    assert repo.compact() == 19
    assert REPO_STATS.ttl_dropped == ttl_before + 19
    survivors = repo.load().get()
    assert [r.result_key.data_set_date for r in survivors] == list(range(19, 30))
    _assert_results_bit_identical(survivors, untrimmed.load().after(19).get())
    _assert_results_bit_identical(ColumnarMetricsRepository(path).load().get(), survivors)
    monkeypatch.setenv("DEEQU_TORCH_REPO_TTL", "5")
    assert ColumnarMetricsRepository().ttl == 5.0
    monkeypatch.setenv("DEEQU_TORCH_REPO_TTL", "0")
    assert ColumnarMetricsRepository().ttl is None
    monkeypatch.setenv("DEEQU_TORCH_REPO_TTL", "soon")
    with pytest.raises(EnvConfigError, match="DEEQU_TORCH_REPO_TTL"):
        ColumnarMetricsRepository()
    with pytest.raises(ValueError, match="ttl"):
        ColumnarMetricsRepository(ttl=-1.0)


def test_hundred_saves_without_quadratic_wall(tmp_path):
    repo = ColumnarMetricsRepository(str(tmp_path / "repo"))
    n = 120

    def run_half(start):
        before = REPO_STATS.bytes_appended
        for d in range(start, start + n // 2):
            repo.save(_scalar_result(d, {"t": "x"}, {"x": 1.0, "y": 2.0}))
        return REPO_STATS.bytes_appended - before

    first = run_half(0)
    second = run_half(n // 2)
    assert repo.num_segments >= n
    assert second <= first * 1.05, (first, second)


def _torn_tail(path):
    files = sorted(f for f in os.listdir(path) if f.endswith(".dqmr"))
    tail = os.path.join(path, files[-1])
    with open(tail, "rb+") as f:
        f.truncate(os.path.getsize(tail) // 2)


def test_torn_tail_segment_raises_typed(tmp_path):
    path = str(tmp_path / "repo")
    repo = ColumnarMetricsRepository(path)
    for d in range(4):
        repo.save(_scalar_result(d, {}, {"x": float(d)}))
    _torn_tail(path)
    with pytest.raises(CorruptStateException):
        ColumnarMetricsRepository(path)


def test_torn_tail_recover_keeps_prior_segments(tmp_path):
    path = str(tmp_path / "repo")
    repo = ColumnarMetricsRepository(path)
    for d in range(4):
        repo.save(_scalar_result(d, {}, {"x": float(d)}))
    intact = repo.load().after(0).before(2).get()
    _torn_tail(path)
    recovered = ColumnarMetricsRepository(path, on_torn_segment="recover")
    results = recovered.load().get()
    assert [r.result_key.data_set_date for r in results] == [0, 1, 2]
    _assert_results_bit_identical(results, intact)
    recovered.save(_scalar_result(9, {}, {"x": 9.0}))
    assert recovered.load_by_key(ResultKey(9)) is not None
    assert any(f.endswith(".corrupt") for f in os.listdir(path))
    again = ColumnarMetricsRepository(path).load().get()
    assert [r.result_key.data_set_date for r in again] == [0, 1, 2, 9]
    _assert_results_bit_identical(again[:3], intact)


def test_corruption_before_valid_segments_always_raises(tmp_path):
    path = str(tmp_path / "repo")
    repo = ColumnarMetricsRepository(path)
    for d in range(4):
        repo.save(_scalar_result(d, {}, {"x": float(d)}))
    first = os.path.join(path, sorted(f for f in os.listdir(path) if f.endswith(".dqmr"))[0])
    with open(first, "rb+") as f:
        f.truncate(os.path.getsize(first) // 2)
    for mode in ("raise", "recover"):
        with pytest.raises(CorruptStateException):
            ColumnarMetricsRepository(path, on_torn_segment=mode)


# -- queries are scans ---------------------------------------------------------


def _dict_heavy_history(repo, n_saves=64, pkg="port"):
    vals = [0.25, 0.5, 0.75, 1.0]
    for d in range(n_saves):
        repo.save(_scalar_result(
            d, {"tenant": f"t{d % 4}"},
            {c: vals[(d + i) % 4] for i, c in enumerate("abcd")}, pkg=pkg))
    return repo


def test_query_is_one_fetch_scan():
    """The port twin of test_query_is_plan_linted_one_fetch_scan (the
    port has no plan lint yet): one fused scan, one device fetch."""
    repo = _dict_heavy_history(ColumnarMetricsRepository())
    query = RepositoryQuery(metric_name="Completeness", after=8, before=55,
                            aggregates=("count", "mean", "min", "max", "sum"))
    queries_before, passes_before = REPO_STATS.queries, REPO_STATS.query_scan_passes
    scans, fetches = SCAN_STATS.scan_passes, SCAN_STATS.device_fetches
    result = run_repository_query(repo, query)
    assert SCAN_STATS.device_fetches - fetches == 1
    assert SCAN_STATS.scan_passes - scans == 1
    assert SCAN_STATS.last_scan_fetches == 1
    assert REPO_STATS.queries == queries_before + 1
    assert REPO_STATS.query_scan_passes == passes_before + 1
    assert result.rows == (55 - 8 + 1) * 4
    assert result.aggregates["count"] == float(result.rows)


QUERIES = [
    dict(metric_name="Completeness"),
    dict(metric_name="Completeness", instance="b"),
    dict(analyzers="Completeness('a')", after=10),
    dict(tag_values={"tenant": "t2"}, before=50),
    dict(metric_name="Size", aggregates=("count", "max")),
    dict(tag_values={"tenant": "nope"}),
    dict(metric_name="Completeness", after=5, before=60,
         aggregates=("count", "mean", "min", "max", "sum", "stddev", "completeness")),
]


def _query(spec, pkg):
    spec = dict(spec)
    if "analyzers" in spec:
        spec["analyzers"] = [eval(spec["analyzers"], vars(PKGS[pkg][0]))]
    mod = port_repo if pkg == "port" else ref_repo
    return mod.RepositoryQuery(**spec)


def test_query_bit_identical_to_loader_side_baseline():
    """Columnar scan == loader-side iteration == decoded scan, bit for
    bit; and within the bounds of the module doc of the reference's query
    over the same saves."""
    import deequ_tpu.repository.query as ref_query

    repo = _dict_heavy_history(ColumnarMetricsRepository())
    ref_hist = _dict_heavy_history(ref_repo.ColumnarMetricsRepository(), pkg="ref")
    for spec in QUERIES:
        query = _query(spec, "port")
        fused = run_repository_query(repo, query)
        decoded = run_repository_query(repo, query, encoded_ingest=False)
        baseline = loader_side_aggregates(repo, query)
        assert fused.rows == baseline.rows == decoded.rows, spec
        assert set(fused.aggregates) == set(baseline.aggregates) == set(decoded.aggregates)
        for name, value in fused.aggregates.items():
            assert _bits(value) == _bits(baseline.aggregates[name]), (spec, name)
            assert _bits(value) == _bits(decoded.aggregates[name]), (spec, name)
        want = ref_query.run_repository_query(ref_hist, _query(spec, "ref"))
        assert fused.rows == want.rows
        assert set(fused.aggregates) == set(want.aggregates), spec
        for name, value in fused.aggregates.items():
            w, rel = want.aggregates[name], QUERY_REL[name]
            assert abs(value - w) <= rel * max(abs(value), abs(w)), (spec, name, value, w)


def test_query_empty_window_fails_typed_not_silent():
    repo = _dict_heavy_history(ColumnarMetricsRepository(), n_saves=8)
    result = run_repository_query(repo, RepositoryQuery(metric_name="Completeness", after=1000))
    assert result.rows == 0
    assert result.aggregates.get("count") == 0.0
    assert "mean" not in result.aggregates
    assert result.metrics["mean"].value.is_failure


def test_encoded_query_stages_2x_fewer_bytes(monkeypatch):
    """The history's date and value planes ride int16 codes: at least 2x
    fewer staged bytes than the decoded run of the same query, with
    bit-identical aggregates; DEEQU_TORCH_ENCODED_INGEST=0 is the decoded
    run's switch."""
    repo = _dict_heavy_history(ColumnarMetricsRepository(), n_saves=96)
    query = RepositoryQuery(metric_name="Completeness")
    runs = {}
    for label, kw, env in (("encoded", {"encoded_ingest": True}, None),
                           ("decoded", {"encoded_ingest": False}, None),
                           ("env_off", {}, "0")):
        if env is not None:
            monkeypatch.setenv("DEEQU_TORCH_ENCODED_INGEST", env)
        packed, encoded = SCAN_STATS.bytes_packed, SCAN_STATS.encoded_scan_passes
        result = run_repository_query(repo, query, **kw)
        runs[label] = (SCAN_STATS.bytes_packed - packed,
                       SCAN_STATS.encoded_scan_passes - encoded, result)
    assert runs["encoded"][0] * 2 <= runs["decoded"][0] == runs["env_off"][0]
    assert (runs["encoded"][1], runs["decoded"][1], runs["env_off"][1]) == (1, 0, 0)
    for name, value in runs["encoded"][2].aggregates.items():
        assert _bits(value) == _bits(runs["decoded"][2].aggregates[name])
    monkeypatch.setenv("DEEQU_TORCH_ENCODED_INGEST", "yes")
    with pytest.raises(EnvConfigError, match="DEEQU_TORCH_ENCODED_INGEST"):
        run_repository_query(repo, query)


# -- anomaly strategies through the loader -------------------------------------


def test_history_from_loader_cross_backend_parity(tmp_path):
    from deequ_tpu_torch.anomaly import AnomalyDetector, DataPoint
    from deequ_tpu_torch.anomaly.history import history_from_loader
    from deequ_tpu_torch.anomaly.strategies import (
        OnlineNormalStrategy,
        RelativeRateOfChangeStrategy,
    )

    backends = [_make_repo(kind, tmp_path) for kind in BACKENDS]
    rng = np.random.default_rng(99)
    analyzer = Completeness("x")
    for d in range(24):
        v = 0.9 + 0.01 * float(rng.standard_normal())
        for repo in backends:
            repo.save(_scalar_result(d, {"env": "p"}, {"x": v}))
    histories = [history_from_loader(repo.load(), analyzer) for repo in backends]
    for other in histories[1:]:
        assert [(p.time, _bits(p.metric_value)) for p in other] == \
            [(p.time, _bits(p.metric_value)) for p in histories[0]]
    for strategy in (
        RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
        OnlineNormalStrategy(lower_deviation_factor=3.0, upper_deviation_factor=3.0),
    ):
        verdicts = [
            [i for i, _ in AnomalyDetector(strategy).is_new_point_anomalous(
                h, DataPoint(100, 0.2)).anomalies]
            for h in histories
        ]
        assert all(v == verdicts[0] for v in verdicts) and verdicts[0] == [100]


def test_anomaly_check_runs_unmodified_on_columnar(df_with_numeric_values):
    import deequ_tpu_torch
    from deequ_tpu_torch.anomaly.strategies import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.verification import AnomalyCheckConfig

    table = port_table(df_with_numeric_values)
    repo = ColumnarMetricsRepository()
    for day in range(1, 5):
        (deequ_tpu_torch.VerificationSuite.on_data(table).use_repository(repo)
         .save_or_append_result(ResultKey(day)).add_required_analyzer(Size()).run())
    statuses = []
    for key, data in ((10, table), (11, table.head(1))):
        result = (
            deequ_tpu_torch.VerificationSuite.on_data(data).use_repository(repo)
            .save_or_append_result(ResultKey(key))
            .add_anomaly_check(
                RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
                Size(), AnomalyCheckConfig(deequ_tpu_torch.CheckLevel.WARNING, "size anomaly"))
            .run()
        )
        statuses.append(result.status.value)
    assert statuses == ["Success", "Warning"]


# -- the online monitor --------------------------------------------------------


def _normal_strategy(pkg="port"):
    import deequ_tpu.anomaly.strategies as ref_strategies
    import deequ_tpu_torch.anomaly.strategies as port_strategies

    mod = port_strategies if pkg == "port" else ref_strategies
    return mod.OnlineNormalStrategy(lower_deviation_factor=3.0, upper_deviation_factor=3.0)


def _stream(n, spike_at=()):
    rng = np.random.default_rng(7)
    out = []
    for d in range(n):
        v = 0.95 + 0.002 * float(rng.standard_normal())
        out.append((d, 0.2 if d in spike_at else v))
    return out


def test_monitor_alerts_at_save_time():
    """The port twin of test_monitor_alerts_at_save_time_and_in_execution_report
    (the port's registry report waits for obs/): the alert lands in the
    ledger and MONITOR_STATS, the saves in REPO_STATS."""
    monitor = QualityMonitor()
    monitor.watch(_normal_strategy(), metric_name="Completeness", instance="x",
                  name="completeness-x", warmup=15)
    repo = ColumnarMetricsRepository(monitor=monitor)
    emitted, saves = MONITOR_STATS.alerts_emitted, REPO_STATS.saves
    for d, v in _stream(40, spike_at=(30,)):
        repo.save(_scalar_result(d, {"t": "a"}, {"x": v}))
    assert [a.time for a in monitor.alerts] == [30]
    alert = monitor.alerts[0]
    assert alert.rule == "completeness-x"
    assert alert.value == pytest.approx(0.2)
    assert "OnlineNormal" in alert.detail
    assert MONITOR_STATS.alerts_emitted - emitted == 1
    assert REPO_STATS.saves - saves == 40


def test_monitor_disabled_by_env(monkeypatch):
    monkeypatch.setenv("DEEQU_TORCH_MONITOR", "0")
    monitor = QualityMonitor()
    monitor.watch(_normal_strategy(), metric_name="Completeness")
    repo = ColumnarMetricsRepository(monitor=monitor)
    for d, v in _stream(40, spike_at=(30,)):
        repo.save(_scalar_result(d, {"t": "a"}, {"x": v}))
    assert monitor.alerts == []
    monkeypatch.setenv("DEEQU_TORCH_MONITOR", "off")
    with pytest.raises(EnvConfigError, match="DEEQU_TORCH_MONITOR"):
        QualityMonitor.enabled()


def _register(monitor, pkg="port"):
    monitor.watch(_normal_strategy(pkg), metric_name="Completeness", instance="x",
                  name="watch-x", warmup=15)
    monitor.watch(_normal_strategy(pkg), metric_name="Size", name="watch-size", warmup=15)


def test_monitor_kill_and_resume_bit_identical(tmp_path):
    stream = _stream(48, spike_at=(25, 40))
    ref_mon = QualityMonitor()
    _register(ref_mon)
    repo_ref = ColumnarMetricsRepository(monitor=ref_mon)
    for d, v in stream:
        repo_ref.save(_scalar_result(d, {"t": "a"}, {"x": v}))

    state_dir = str(tmp_path / "monitor")
    m1 = QualityMonitor(state_dir=state_dir, checkpoint_every=1)
    _register(m1)
    repo = ColumnarMetricsRepository(monitor=m1)
    for d, v in stream[:30]:
        repo.save(_scalar_result(d, {"t": "a"}, {"x": v}))
    del m1

    m2 = QualityMonitor(state_dir=state_dir, checkpoint_every=1)
    _register(m2)
    m2.resume()
    repo.monitor = m2
    stale = MONITOR_STATS.monitor_stale_points
    assert m2.catch_up(repo) == 30
    assert MONITOR_STATS.monitor_stale_points > stale
    for d, v in stream[30:]:
        repo.save(_scalar_result(d, {"t": "a"}, {"x": v}))
    assert m2.state_blob()["states"] == ref_mon.state_blob()["states"]
    assert [(a.rule, a.time) for a in m2.alerts] == [(a.rule, a.time) for a in ref_mon.alerts]
    assert [a.time for a in m2.alerts if a.rule == "watch-x"] == [25, 40]


def _hw(pkg="port"):
    import deequ_tpu.anomaly.seasonal as ref_seasonal
    import deequ_tpu_torch.anomaly.seasonal as port_seasonal

    mod = port_seasonal if pkg == "port" else ref_seasonal
    return mod.HoltWinters(mod.MetricInterval.DAILY, mod.SeriesSeasonality.WEEKLY)


HW_SERIES = [10.0 + (d % 7) + 0.01 * d + (50.0 if d == 17 else 0.0) for d in range(21)]


def test_monitor_holt_winters_carried_forward_matches_batch(tmp_path):
    """The Holt-Winters state carried forward survives a kill-and-resume
    bit for bit; it arms (one fit, here the plain version on the CPU) at
    2p points, and its parameters are within 1e-12 of the reference
    monitor's on the same saves."""
    ref_mon = QualityMonitor()
    ref_mon.watch(_hw(), metric_name="Completeness", name="hw")
    repo_ref = ColumnarMetricsRepository(monitor=ref_mon)
    for d, v in enumerate(HW_SERIES):
        repo_ref.save(_scalar_result(d, {}, {"x": v}))

    state_dir = str(tmp_path / "hw-monitor")
    m1 = QualityMonitor(state_dir=state_dir, checkpoint_every=1)
    m1.watch(_hw(), metric_name="Completeness", name="hw")
    repo = ColumnarMetricsRepository(monitor=m1)
    for d, v in enumerate(HW_SERIES[:16]):
        repo.save(_scalar_result(d, {}, {"x": v}))
    del m1
    m2 = QualityMonitor(state_dir=state_dir, checkpoint_every=1)
    m2.watch(_hw(), metric_name="Completeness", name="hw")
    m2.resume()
    repo.monitor = m2
    m2.catch_up(repo)
    for d, v in enumerate(HW_SERIES[16:], start=16):
        repo.save(_scalar_result(d, {}, {"x": v}))
    assert m2.state_blob()["states"] == ref_mon.state_blob()["states"]
    assert [a.time for a in m2.alerts] == [a.time for a in ref_mon.alerts]
    assert 17 in [a.time for a in m2.alerts]

    jax_mon = ref_repo.QualityMonitor()
    jax_mon.watch(_hw("ref"), metric_name="Completeness", name="hw")
    jax_repo = ref_repo.ColumnarMetricsRepository(monitor=jax_mon)
    for d, v in enumerate(HW_SERIES):
        jax_repo.save(_scalar_result(d, {}, {"x": v}, pkg="ref"))
    ours = next(iter(m2.state_blob()["states"].values()))["blob"]
    theirs = next(iter(jax_mon.state_blob()["states"].values()))["blob"]
    for x, y in zip(ours["abg"], theirs["abg"]):
        assert abs(float.fromhex(x) - float.fromhex(y)) <= 1e-12
    assert [a.time for a in m2.alerts] == [a.time for a in jax_mon.alerts]


# -- cross-package reads -------------------------------------------------------


def _history(pkg, n=12):
    rng = np.random.default_rng(21)
    return [
        _scalar_result(d, {"tenant": f"t{d % 3}"},
                       {"x": float(rng.random()), "y": float("nan") if d == 5 else 0.5},
                       pkg=pkg)
        for d in range(n)
    ]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_filesystem_repository_reads_across_packages(tmp_path, writer):
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "metrics.json")
    w = PKGS[writer][2].FileSystemMetricsRepository(path)
    for r in _history(writer):
        w.save(r)
    r = PKGS[reader][2].FileSystemMetricsRepository(path)
    _assert_results_bit_identical(r.load().get(), w.load().get())
    _assert_results_bit_identical(r.load().with_tag_values({"tenant": "t1"}).get(),
                                  w.load().with_tag_values({"tenant": "t1"}).get())


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_columnar_repository_reads_across_packages(tmp_path, writer):
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "segments")
    w = PKGS[writer][2].ColumnarMetricsRepository(path, segment_rows=10)
    for r in _history(writer, n=20):
        w.save(r)
    for r in _history(writer, n=3):  # superseded results for compaction
        w.save(r)
    w.compact()
    w.save(_history(writer, n=21)[-1])
    r = PKGS[reader][2].ColumnarMetricsRepository(path)
    _assert_results_bit_identical(r.load().get(), w.load().get())
    an = PKGS[reader][0]
    got = r.load().for_analyzers([an.Completeness("x")]).after(4).get()
    want = w.load().for_analyzers([PKGS[writer][0].Completeness("x")]).after(4).get()
    _assert_results_bit_identical(got, want)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_monitor_checkpoint_resumes_across_packages(tmp_path, writer):
    """One package's monitor runs 30 saves and is killed; the other
    resumes from its checkpoint, catches up and takes the rest: states and
    alerts equal the writer's uninterrupted run."""
    reader = "port" if writer == "ref" else "ref"
    stream = _stream(48, spike_at=(25, 40))
    whole = PKGS[writer][2].QualityMonitor()
    _register(whole, writer)
    whole_repo = PKGS[writer][2].ColumnarMetricsRepository(monitor=whole)
    for d, v in stream:
        whole_repo.save(_scalar_result(d, {"t": "a"}, {"x": v}, pkg=writer))

    state_dir = str(tmp_path / "monitor")
    m1 = PKGS[writer][2].QualityMonitor(state_dir=state_dir)
    _register(m1, writer)
    repo = PKGS[writer][2].ColumnarMetricsRepository(str(tmp_path / "repo"), monitor=m1)
    for d, v in stream[:30]:
        repo.save(_scalar_result(d, {"t": "a"}, {"x": v}, pkg=writer))
    del m1, repo

    m2 = PKGS[reader][2].QualityMonitor(state_dir=state_dir)
    _register(m2, reader)
    m2.resume()
    repo2 = PKGS[reader][2].ColumnarMetricsRepository(str(tmp_path / "repo"), monitor=m2)
    assert m2.catch_up(repo2) == 30
    for d, v in stream[30:]:
        repo2.save(_scalar_result(d, {"t": "a"}, {"x": v}, pkg=reader))
    assert m2.state_blob()["states"] == whole.state_blob()["states"]
    assert [a.as_dict() for a in m2.alerts] == [a.as_dict() for a in whole.alerts]


# -- the entry points ----------------------------------------------------------


def test_verification_run_saves_after_evaluating_and_reuses(df_with_numeric_values):
    """run() appends its metrics after its checks are evaluated, a second
    run reusing the key computes nothing, and the stream appends each
    batch under its key."""
    import deequ_tpu_torch
    from deequ_tpu_torch.analyzers.builder import AnalysisRunBuilder

    table = port_table(df_with_numeric_values)
    repo = InMemoryMetricsRepository()
    check = deequ_tpu_torch.Check(deequ_tpu_torch.CheckLevel.ERROR, "c").has_size(lambda n: n == 6)
    first = (deequ_tpu_torch.VerificationSuite.on_data(table).add_check(check)
             .use_repository(repo).save_or_append_result(ResultKey(1)).run())
    assert first.status.value == "Success"
    stored = repo.load_by_key(ResultKey(1)).analyzer_context.metric_map
    assert stored[Size()].value.get() == 6.0
    scans = SCAN_STATS.scan_passes
    again = (deequ_tpu_torch.VerificationSuite.on_data(table).add_check(check)
             .use_repository(repo).reuse_existing_results_for_key(ResultKey(1), True).run())
    assert SCAN_STATS.scan_passes == scans
    assert again.metrics[Size()].value.get() == 6.0
    ctx = (AnalysisRunBuilder(table).add_analyzer(Mean("att1")).use_repository(repo)
           .save_or_append_result(ResultKey(1)).run())
    assert ctx.metric_map[Mean("att1")].value.get() == 3.5
    assert set(repo.load_by_key(ResultKey(1)).analyzer_context.metric_map) == {Size(), Mean("att1")}

    stream = deequ_tpu_torch.IncrementalVerificationStream(
        checks=[check], metrics_repository=repo, window=2)
    out = []
    for key in (ResultKey(2), ResultKey(3), ResultKey(4)):
        out += stream.submit(table, result_key=key)
    out += stream.close()
    assert [k for k, _ in out] == [ResultKey(2), ResultKey(3), ResultKey(4)]
    for key in (2, 3, 4):
        assert repo.load_by_key(ResultKey(key)).analyzer_context.metric_map[Size()].value.get() == 6.0


def _monitor_side(pkg):
    """One package's (package, QualityMonitor, ColumnarMetricsRepository)."""
    import importlib

    name = "deequ_tpu_torch" if pkg == "port" else "deequ_tpu"
    return (importlib.import_module(name),
            importlib.import_module(name + ".repository.monitor").QualityMonitor,
            importlib.import_module(name + ".repository").ColumnarMetricsRepository)


def test_monitor_alerts_in_execution_report():
    """The execution-report half of the reference's
    test_monitor_alerts_at_save_time_and_in_execution_report: the alert and
    the saves reach the registry's ``repository`` section, which reads
    MONITOR_STATS and REPO_STATS through; the reference's section moves
    alike over the same stream."""
    moved = {}
    for pkg in ("ref", "port"):
        package, Monitor, Repository = _monitor_side(pkg)
        monitor = Monitor()
        monitor.watch(_normal_strategy(pkg), metric_name="Completeness", instance="x",
                      name="completeness-x", warmup=15)
        repo = Repository(monitor=monitor)
        before = package.execution_report()["repository"]
        for d, v in _stream(40, spike_at=(30,)):
            repo.save(_scalar_result(d, {"t": "a"}, {"x": v}, pkg=pkg))
        report = package.execution_report()["repository"]
        moved[pkg] = (report["active"], report["alerts_emitted"] - before["alerts_emitted"],
                      report["saves"] - before["saves"], sorted(report),
                      [(a.rule, a.time) for a in monitor.alerts])
        if pkg == "port":
            assert report["alerts_emitted"] == MONITOR_STATS.alerts_emitted
    assert moved["port"][:3] == (True, 1, 40)
    assert moved["port"][4] == [("completeness-x", 30)]
    assert moved["port"] == moved["ref"]


def test_monitor_at_serving_resolve_seam():
    """VerificationService(monitor=...): resolved suites feed the same
    watch rules repository saves do, the serving stream position as the
    time axis — the alerts the reference's service raises on the same
    stream."""
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from deequ_tpu.parallel.mesh import use_mesh as ref_use_mesh
    from tests.torch_parity import ref_column

    def table(v, pkg):
        ref = RefTable([ref_column("x", "fractional", np.full(64, v), np.ones(64, bool))])
        return ref if pkg == "ref" else port_table(ref)

    alerts = {}
    for pkg, scope in (("ref", lambda: ref_use_mesh(None)), ("port", contextlib.nullcontext)):
        package, Monitor, _ = _monitor_side(pkg)
        serve = __import__(package.__name__ + ".serve", fromlist=["VerificationService"])
        an = PKGS[pkg][0]
        monitor = Monitor()
        monitor.watch(_normal_strategy(pkg), metric_name="Mean", name="mean-x")
        with scope():
            service = serve.VerificationService(monitor=monitor, coalesce_window=0.0)
            try:
                for i in range(25):
                    service.submit(table(100.0 if i != 20 else 5.0, pkg),
                                   required_analyzers=[an.Mean("x")],
                                   tenant="t0").result(timeout=120)
            finally:
                service.stop()
        alerts[pkg] = [(a.rule, a.time) for a in monitor.alerts]
    assert alerts["port"] == [("mean-x", 20)]
    assert alerts["port"] == alerts["ref"]


def test_monitor_alert_is_an_instant_event_on_the_recording():
    """An alert emitted while a recorder is armed is a ``quality_alert``
    instant event carrying the rule and the point, with the arguments the
    reference's event carries."""
    import importlib

    events = {}
    for pkg in ("ref", "port"):
        package, Monitor, Repository = _monitor_side(pkg)
        obs = importlib.import_module(package.__name__ + ".obs")
        monitor = Monitor()
        monitor.watch(_normal_strategy(pkg), metric_name="Completeness", instance="x",
                      name="completeness-x", warmup=15)
        repo = Repository(monitor=monitor)
        rec = obs.FlightRecorder()
        with obs.recording_scope(rec):
            for d, v in _stream(40, spike_at=(30,)):
                repo.save(_scalar_result(d, {"t": "a"}, {"x": v}, pkg=pkg))
        events[pkg] = [(r.kind, r.args) for r in rec.records() if r.name == "quality_alert"]
    assert len(events["port"]) == 1
    kind, args = events["port"][0]
    assert kind == "instant" and args["rule"] == "completeness-x" and args["time"] == 30
    assert events["port"] == events["ref"]

