"""Out-of-core streams in the port (``deequ_tpu_torch/data/source.py``,
``data/streaming.py``, the streaming route of ``ops/scan_engine.py``), on
the CPU.

- Twins of the 24 tests of tests/test_streaming.py, run through
  ``deequ_tpu_torch``: a StreamingTable gives the materialised table's
  metrics (the monoid fold across batches is the fold across partitions);
  Parquet and CSV streams, the CSV schema inference, the reader thread, the
  KLL compaction in the port's gathered layout ((chunks, T) and
  (chunks, K, T)), the tree fold, Histogram on a stream. The twin of the
  Size-only test reads the stream through a retrying handle as well as
  through the resilient loop (``on_batch_error="skip"``, whose own twins
  are tests/test_torch_resilience.py); the 1B-row proof harness becomes its scaled
  port-side check (segmented incremental runs == one streaming pass) and
  imports nothing under ``benchmarks/``.
- Port-only: a stream cut at the in-memory run's chunk rows gives its bits
  on every metric; a stream of monoid ops fetches once; a stream longer
  than the fold's capacity drains its gather leaves to the host, keeps the
  elementwise folds' bits, and keeps its KLL gather bounded by compaction
  there; a column that gains nulls partway through a stream; a retried
  read gives a clean read's batches, and a read that keeps failing, or
  fails otherwise, raises; a generator source's chunks follow its first
  batch; ``persist()`` raises TypeError; a group budget that spills gives
  the metrics of the run without one (the spill twins are
  tests/test_torch_spill.py).
- Parity with the reference: one Parquet and one CSV file written from a
  numpy seed, streamed through both packages' runners (the reference on
  one device, ``use_mesh(None)``): counts, completeness, min/max, HLL
  estimates (a function of the registers) and group statistics exact, sums
  and means within tests/torch_parity.py's bounds, quantiles within the
  KLL rank error of numpy.

The mesh/no-mesh matrix: every test here runs twice, over the port's
8-member virtual mesh on the CPU and with no mesh
(``torch_parity.port_mesh_mode``), as the reference's suite runs under
its 8-device mesh and without it.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.data.io as ref_io
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import (
    Check,
    CheckLevel,
    StreamingTable,
    VerificationSuite,
    stream_table,
    use_device,
)
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLSketch,
    Maximum,
    Mean,
    Minimum,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.io import (
    read_csv,
    stream_csv,
    stream_parquet,
    write_parquet,
    write_parquet_stream,
)
from deequ_tpu_torch.data.source import (
    BatchSource,
    GeneratorBatchSource,
    ParquetBatchSource,
)
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType, Field, Schema
from deequ_tpu_torch.ops import scan_engine
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.exceptions import RetryExhaustedException
from deequ_tpu_torch.resilience.retry import RetryPolicy
from torch_parity import assert_metric_parity, parity_env, port_table, port_mesh_mode  # noqa: F401

# every test runs over the port's 8-member virtual mesh and with none
pytestmark = [pytest.mark.torch_port, pytest.mark.usefixtures("port_mesh_mode")]


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mixed_table():
    rng = np.random.default_rng(11)
    n = 30_000
    v = rng.normal(10.0, 3.0, n)
    holes = set(rng.integers(0, n, n // 50).tolist())
    return ColumnarTable.from_pydict({
        "id": list(range(n)),
        "v": [None if i in holes else float(x) for i, x in enumerate(v)],
        "cat": [f"c{i % 13}" for i in range(n)],
        "email": ["a@b.com" if i % 3 == 0 else "nope" for i in range(n)],
    })


ANALYZERS = [
    Size(),
    Completeness("v"),
    Mean("v"),
    Sum("v"),
    Minimum("v"),
    Maximum("v"),
    StandardDeviation("v"),
    ApproxCountDistinct("id"),
    DataType("email"),
    PatternMatch("email", r"^[a-z]+@[a-z]+\.[a-z]+$"),
    Uniqueness(["id"]),
    Distinctness(["cat"]),
    CountDistinct(["cat"]),
    Entropy("cat"),
    MutualInformation("cat", "email"),
]


def _values(ctx):
    out = {}
    for a, m in ctx.metric_map.items():
        assert m.value.is_success, (a, m.value)
        v = m.value.get()
        out[repr(a)] = v if isinstance(v, float) else repr(v)
    return out


def _bits(ctx, analyzers):
    """Each metric's value: a float by its bits, anything else by repr."""
    out = []
    for a in analyzers:
        m = ctx.metric(a)
        assert m.value.is_success, (a, m.value)
        v = m.value.get()
        out.append(np.float64(v).view(np.int64) if isinstance(v, float) else repr(v))
    return out


def _assert_close(want: dict, got: dict, rel: float = 1e-9) -> None:
    assert set(want) == set(got)
    for k in want:
        if isinstance(want[k], float):
            assert want[k] == pytest.approx(got[k], rel=rel, nan_ok=True), k
        else:
            assert want[k] == got[k], k


# -- twins of tests/test_streaming.py ------------------------------------------


def test_streamed_equals_materialized(mixed_table):
    stream = stream_table(mixed_table, batch_rows=7_000)  # uneven batches
    _assert_close(_values(AnalysisRunner.do_analysis_run(mixed_table, ANALYZERS)),
                  _values(AnalysisRunner.do_analysis_run(stream, ANALYZERS)))


def test_streamed_histogram_and_kll(mixed_table):
    stream = stream_table(mixed_table, batch_rows=9_000)
    h_mem = Histogram("cat").calculate(mixed_table).value.get()
    h_stream = Histogram("cat").calculate(stream).value.get()
    assert h_mem.values == h_stream.values
    assert h_mem.number_of_bins == h_stream.number_of_bins

    k_stream = KLLSketch("v").calculate(stream)
    assert k_stream.value.is_success
    # the bucket counts hold every non-null row
    assert sum(b.count for b in k_stream.value.get().buckets) == mixed_table["v"].num_valid


def test_parquet_round_trip_and_stream(tmp_path, mixed_table):
    path = str(tmp_path / "t.parquet")
    write_parquet(mixed_table, path, row_group_rows=8_192)
    stream = stream_parquet(path, batch_rows=6_000)
    assert stream.num_rows == mixed_table.num_rows
    assert set(stream.column_names) == set(mixed_table.column_names)
    _assert_close(_values(AnalysisRunner.do_analysis_run(mixed_table, ANALYZERS)),
                  _values(AnalysisRunner.do_analysis_run(stream, ANALYZERS)))


def test_write_parquet_stream_bounded(tmp_path):
    """write_parquet_stream then stream_parquet: a dataset larger than any
    one batch, never materialised, then analysed."""
    path = str(tmp_path / "big.parquet")
    n_batches, rows = 10, 5_000

    def gen():
        rng = np.random.default_rng(0)
        for i in range(n_batches):
            yield ColumnarTable.from_pydict({
                "x": list(rng.normal(float(i), 1.0, rows)),
                "k": list(range(i * rows, (i + 1) * rows)),
            })

    written = write_parquet_stream(gen(), path)
    assert written == n_batches * rows
    ctx = AnalysisRunner.do_analysis_run(
        stream_parquet(path, batch_rows=4_000), [Size(), Mean("x"), Uniqueness(["k"])]
    )
    vals = _values(ctx)
    assert vals[repr(Size())] == written
    assert vals[repr(Uniqueness(["k"]))] == 1.0
    # the mean of batch means 0..9 (equal batch sizes)
    assert vals[repr(Mean("x"))] == pytest.approx(4.5, abs=0.05)


def test_streaming_table_never_materializes(mixed_table):
    """Whole-column access on a StreamingTable raises instead of reading
    the stream."""
    stream = stream_table(mixed_table)
    col = stream["v"]
    assert col.dtype.name == "FRACTIONAL"
    with pytest.raises(AttributeError, match="never materialized"):
        _ = col.values
    with pytest.raises(TypeError, match="cannot be persisted"):
        stream.persist()


def test_streaming_verification_suite(mixed_table):
    stream = stream_table(mixed_table, batch_rows=8_000)
    check = (
        Check(CheckLevel.ERROR, "stream")
        .has_size(lambda n: n == mixed_table.num_rows)
        .is_complete("id")
        .is_unique("id")
        .has_mean("v", lambda m: 9.5 < m < 10.5)
        .has_number_of_distinct_values("cat", lambda n: n == 13)
    )
    result = VerificationSuite.on_data(stream).add_check(check).run()
    assert result.status.name == "SUCCESS"


def test_streaming_profiler(tmp_path):
    """The profiler's three passes over a Parquet stream: numeric
    statistics, inferred types (a string column of numbers cast a batch),
    the histograms of low-cardinality columns."""
    from deequ_tpu_torch.profiles import ColumnProfiler

    n = 10_000
    rng = np.random.default_rng(5)
    t = ColumnarTable.from_pydict({
        "num": list(rng.normal(5.0, 1.0, n)),
        "numstr": [str(i % 997) for i in range(n)],
        "cat": [f"g{i % 7}" for i in range(n)],
    })
    path = str(tmp_path / "p.parquet")
    write_parquet(t, path, row_group_rows=2_048)
    profiles_mem = ColumnProfiler.profile(t)
    profiles_stream = ColumnProfiler.profile(stream_parquet(path, batch_rows=3_000))
    assert profiles_stream.num_records == n
    for name in ("num", "numstr", "cat"):
        pm, ps = profiles_mem.profiles[name], profiles_stream.profiles[name]
        assert pm.data_type == ps.data_type, name
        assert pm.completeness == ps.completeness, name
        assert pm.approximate_num_distinct_values == ps.approximate_num_distinct_values, name
    # numstr was inferred Integral: a numeric profile with its statistics
    assert profiles_stream.profiles["numstr"].mean == pytest.approx(
        profiles_mem.profiles["numstr"].mean, rel=1e-9)
    assert (profiles_stream.profiles["cat"].histogram.values
            == profiles_mem.profiles["cat"].histogram.values)


def test_empty_stream():
    t = ColumnarTable.from_pydict({"x": [1.0, 2.0]}).head(0)
    ctx = AnalysisRunner.do_analysis_run(stream_table(t), [Size(), Completeness("x")])
    assert ctx.metric_map[Size()].value.get() == 0.0


def test_size_only_stream_counts_rows():
    """A lone Size() prunes the read to no column, and a batch of no column
    cannot carry its row count: the streaming scan reads one column, and so
    does the resilient loop (on_batch_error="skip"); a retrying handle too."""
    t = ColumnarTable.from_pydict({"x": [float(i) for i in range(97)]})
    ctx = AnalysisRunner.do_analysis_run(stream_table(t, 25), [Size()])
    assert ctx.metric_map[Size()].value.get() == 97.0
    ctx = AnalysisRunner.do_analysis_run(stream_table(t, 25).with_retry(), [Size()])
    assert ctx.metric_map[Size()].value.get() == 97.0
    ctx = AnalysisRunner.do_analysis_run(stream_table(t, 25), [Size()], on_batch_error="skip")
    assert ctx.metric_map[Size()].value.get() == 97.0


def test_streaming_incremental_states(mixed_table):
    """States saved from a streamed run merge with later batches as a
    materialised run's do."""
    from deequ_tpu_torch.states import InMemoryStateProvider

    half = mixed_table.num_rows // 2
    rows = np.arange(mixed_table.num_rows)
    first, second = mixed_table.filter_rows(rows < half), mixed_table.filter_rows(rows >= half)
    analyzers = [Size(), Mean("v"), Uniqueness(["id"])]
    provider = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(stream_table(first, batch_rows=5_000), analyzers,
                                   save_states_with=provider)
    ctx = AnalysisRunner.do_analysis_run(stream_table(second, batch_rows=5_000), analyzers,
                                         aggregate_with=provider)
    full = AnalysisRunner.do_analysis_run(mixed_table, analyzers)
    for a in analyzers:
        assert ctx.metric_map[a].value.get() == pytest.approx(
            full.metric_map[a].value.get(), rel=1e-9), a


def test_stream_csv_matches_read_csv(tmp_path):
    path = str(tmp_path / "t.csv")
    rng = np.random.default_rng(8)
    with open(path, "w") as f:
        f.write("id,score,grade\n")
        for i in range(20_000):
            score = "" if i % 97 == 0 else f"{rng.normal(70, 10):.4f}"
            f.write(f"{i},{score},g{i % 5}\n")
    analyzers = [Size(), Completeness("score"), Mean("score"), Uniqueness(["id"])]
    mem = AnalysisRunner.do_analysis_run(read_csv(path), analyzers)
    stream = AnalysisRunner.do_analysis_run(stream_csv(path, batch_rows=3_000), analyzers)
    for a in analyzers:
        assert stream.metric_map[a].value.get() == pytest.approx(
            mem.metric_map[a].value.get(), rel=1e-9), a


def test_stream_csv_null_and_widening_semantics(tmp_path):
    """Only the empty cell is null ('NA' is data), and a widening value late
    in the file does not break the stream."""
    path = str(tmp_path / "w.csv")
    with open(path, "w") as f:
        f.write("name,score\n")
        for i in range(50_000):
            f.write(f"user{i},{i}\n")
        f.write(",NA\n")
        f.write("z,3.5\n")
    analyzers = [Size(), Completeness("name"), Completeness("score")]
    mem = AnalysisRunner.do_analysis_run(read_csv(path), analyzers)
    stream = AnalysisRunner.do_analysis_run(stream_csv(path, batch_rows=8_000), analyzers)
    for a in analyzers:
        assert stream.metric_map[a].value.get() == pytest.approx(
            mem.metric_map[a].value.get(), rel=1e-12), a
    # 'NA' makes the column a string column, as read_csv infers it
    assert stream_csv(path, batch_rows=8_000)["score"].dtype.name == "STRING"


def test_stream_csv_multiblock_widening(tmp_path):
    """The inference pass reads every block: a '3.5' past the first reader
    block of an int-looking column widens it to fractional."""
    path = str(tmp_path / "big.csv")
    with open(path, "w") as f:
        f.write("id,score,flag\n")
        f.write("".join(f"{i},{i % 1000},true\n" for i in range(400_000)))
        f.write("400000,3.5,false\n")
    st = stream_csv(path, batch_rows=100_000)
    assert st["score"].dtype.name == "FRACTIONAL"
    assert st["flag"].dtype.name == "BOOLEAN"
    analyzers = [Size(), Completeness("score"), Mean("score")]
    mem = AnalysisRunner.do_analysis_run(read_csv(path), analyzers)
    stream = AnalysisRunner.do_analysis_run(st, analyzers)
    for a in analyzers:
        assert stream.metric_map[a].value.get() == pytest.approx(
            mem.metric_map[a].value.get(), rel=1e-12), a


def test_prefetch_delivers_late_exception():
    """A reader exception raised while the queue is full reaches the
    consumer, however long the consumer takes to free a slot."""
    from deequ_tpu_torch.ops.scan_engine import _prefetch

    def source():
        yield 1
        yield 2  # fills the depth-1 queue while the consumer sleeps
        raise RuntimeError("reader died")

    gen = _prefetch(source(), depth=1)
    assert next(gen) == 1
    time.sleep(1.5)
    assert next(gen) == 2
    with pytest.raises(RuntimeError, match="reader died"):
        next(gen)


def test_parquet_source_rejects_schema_mismatch(tmp_path):
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    write_parquet(ColumnarTable.from_pydict({"x": [1, 2], "y": [1.0, 2.0]}), a)
    write_parquet(ColumnarTable.from_pydict({"x": [1, 2], "y": ["s", "t"]}), b)
    ParquetBatchSource([a, a])  # identical schemas are fine
    with pytest.raises(ValueError, match="schema mismatch"):
        ParquetBatchSource([a, b])


def test_kll_midscan_compaction_bounds_gather():
    """Gathered KLL summaries fold into a bounded sketch on the host
    (the port's (chunks, T) layout); quantiles track the uncompacted fold
    and the total weight is exact."""
    from deequ_tpu_torch.analyzers.sketches import _make_kll_compact
    from deequ_tpu_torch.ops.kll_device import fold_summaries

    rng = np.random.default_rng(5)
    k = 256
    # 64 gathered chunk summaries of 64 weight-4 strata each
    items = rng.normal(50.0, 10.0, (64, 64))
    weights = np.full((64, 64), 4.0)
    result = {"items": items, "weights": weights, "count": np.float64(items.size * 4),
              "min": items.min(), "max": items.max()}
    compacted = _make_kll_compact(1, k)(result)
    assert compacted["items"].size < items.size  # bounded
    assert compacted["items"].shape[-1] == 64  # later chunks still join
    assert compacted["weights"].sum() == weights.sum()
    ref = fold_summaries(items, weights, k, 0.64)
    got = fold_summaries(compacted["items"], compacted["weights"], k, 0.64)
    assert got.count == ref.count
    for q in (0.1, 0.5, 0.9):
        assert abs(got.quantile(q) - ref.quantile(q)) < 2.0


def test_kll_multi_compact_preserves_extraction_layout():
    """A coalesced KLL op gathers (chunks, K, T) with column j at [:, j]:
    compaction keeps that layout and the trailing shape."""
    from deequ_tpu_torch.analyzers.sketches import _kll_multi_extract, _make_kll_compact
    from deequ_tpu_torch.ops.kll_device import fold_summaries

    rng = np.random.default_rng(6)
    K, T, chunks, k = 3, 32, 40, 128
    items = np.zeros((chunks, K, T))
    weights = np.full((chunks, K, T), 2.0)
    for j in range(K):
        items[:, j] = rng.normal(100.0 * (j + 1), 5.0, (chunks, T))
    result = {"items": items, "weights": weights, "count": np.full(K, chunks * T * 2.0),
              "min": items.min(axis=(0, 2)), "max": items.max(axis=(0, 2))}
    compacted = _make_kll_compact(K, k)(result)
    assert compacted["items"].shape[1:] == (K, T)
    assert compacted["items"].shape[0] < chunks
    for j in range(K):
        ex = _kll_multi_extract(compacted, j)
        sk = fold_summaries(ex["items"], ex["weights"], k, 0.64)
        assert abs(sk.quantile(0.5) - 100.0 * (j + 1)) < 5.0
        assert sk.count == chunks * T * 2


def test_kll_compaction_in_streaming_scan(tmp_path, monkeypatch):
    """A many-chunk Parquet stream whose fold drains every 4 chunks
    compacts its KLL gather there (the threshold lowered to force it);
    the quantiles track the uncompacted scan."""
    import dataclasses

    from deequ_tpu_torch.analyzers.sketches import _kll_scan_op, _kll_state_from_result

    rng = np.random.default_rng(7)
    n = 60_000
    path = str(tmp_path / "v.parquet")
    write_parquet(ColumnarTable.from_pydict({"v": rng.normal(0.0, 1.0, n).tolist()}), path)

    def scan(threshold):
        op = _kll_scan_op("v", 256)
        if threshold is not None:
            op = dataclasses.replace(op, compact_threshold=threshold)
        (result,) = scan_engine.run_scan(stream_parquet(path, batch_rows=2_000), [op], "cpu",
                                         chunk_rows=2_000)
        return _kll_state_from_result(result, 256, 0.64)

    monkeypatch.setattr(scan_engine, "STREAM_FOLD_CAPACITY", 4)
    SCAN_STATS.reset()
    compacted = scan(threshold=2_000)
    assert SCAN_STATS.kll_compactions > 0 and SCAN_STATS.fold_drains == 7
    plain = scan(threshold=None)
    assert compacted.sketch.count == plain.sketch.count == n
    for q in (0.05, 0.5, 0.95):
        assert abs(compacted.sketch.quantile(q) - plain.sketch.quantile(q)) < 0.1


def test_parquet_source_mismatch_scoped_to_selected_columns(tmp_path):
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    write_parquet(ColumnarTable.from_pydict({"x": [1, 2], "y": [1.0, 2.0]}), a)
    write_parquet(ColumnarTable.from_pydict({"y": ["s"], "x": [3]}), b)
    src = ParquetBatchSource([a, b], columns=["x"])  # 'y' differs but is not read
    assert sum(batch.num_rows for batch in src.batches()) == 3
    with pytest.raises(ValueError, match="schema mismatch"):
        ParquetBatchSource([a, b])


def test_kll_compact_all_null_column_bounded():
    """An all-null column keeps no padding through compaction."""
    from deequ_tpu_torch.analyzers.sketches import _make_kll_compact

    result = {"items": np.zeros((100, 100)), "weights": np.zeros((100, 100)),
              "count": np.float64(0), "min": np.inf, "max": -np.inf}
    compacted = _make_kll_compact(1, 256)(result)
    assert compacted["items"].size == 0
    assert compacted["weights"].size == 0


def test_stream_csv_bool_mixed_literal_parity(tmp_path):
    """A column mixing '1' and 'true' is BOOLEAN for read_csv and for
    stream_csv alike."""
    p = tmp_path / "mixed_bool.csv"
    p.write_text("\n".join(["b"] + ["true", "1", "false", "0", "TRUE"] * 200) + "\n")
    table, stream = read_csv(str(p)), stream_csv(str(p))
    assert table.schema["b"].dtype == DType.BOOLEAN
    assert stream.schema["b"].dtype == DType.BOOLEAN
    analyzers = [Size(), Completeness("b")]
    assert (_values(AnalysisRunner.do_analysis_run(stream, analyzers))
            == _values(AnalysisRunner.do_analysis_run(table, analyzers)))


def _segment_source(total_rows: int, batch_rows: int, row_offset: int, seed: int):
    """A generator source whose batch k is made from seed + its global
    batch index, so a segment's stream and the one-pass stream hold the
    same bytes."""
    schema = Schema([Field("v", DType.FRACTIONAL)])

    def factory():
        for start in range(0, total_rows, batch_rows):
            n = min(batch_rows, total_rows - start)
            rng = np.random.default_rng(seed + (row_offset + start) // batch_rows)
            yield ColumnarTable([Column("v", DType.FRACTIONAL,
                                        values=rng.normal(100.0, 5.0, n))])

    return GeneratorBatchSource(schema, factory, num_rows=total_rows)


def test_billion_row_proof_harness_scaled():
    """The out-of-core loop of benchmarks/billion_row_proof.py, scaled:
    segments of a generated stream run with their states chained
    (aggregate_with/save_states_with) and their metrics saved to a
    repository; the last segment's chained metrics equal one streaming pass
    over the whole dataset."""
    from deequ_tpu_torch.repository import AnalysisResult, ResultKey
    from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository
    from deequ_tpu_torch.states import InMemoryStateProvider

    total, segments, batch_rows = 400_000, 4, 50_000
    seg_rows = total // segments
    analyzers = [Size(), Completeness("v"), Mean("v"), StandardDeviation("v"),
                 Minimum("v"), Maximum("v")]
    repo, states = InMemoryMetricsRepository(), InMemoryStateProvider()
    for seg in range(segments):
        ctx = AnalysisRunner.do_analysis_run(
            StreamingTable(_segment_source(seg_rows, batch_rows, seg * seg_rows, 1000)),
            analyzers, aggregate_with=states, save_states_with=states)
        repo.save(AnalysisResult(ResultKey(seg, {"proof": "scaled"}), ctx))
    final = repo.load_by_key(ResultKey(segments - 1, {"proof": "scaled"})).analyzer_context
    once = AnalysisRunner.do_analysis_run(
        StreamingTable(_segment_source(total, batch_rows, 0, 1000)), analyzers)
    assert final.metric_map[Size()].value.get() == total
    for a in analyzers:
        want = once.metric_map[a].value.get()
        assert abs(final.metric_map[a].value.get() - want) <= 1e-9 * max(1.0, abs(want)), a


def test_stream_state_folding_is_tree_shaped():
    """B batch states merge B - 1 times into a tree of depth log2(B), never
    into a whole-size accumulator a batch."""
    from deequ_tpu_torch.analyzers.base import StreamStateFolder

    class Spy:
        merges = 0

        def __init__(self, depth=0):
            self.depth = depth

        def sum(self, other):
            Spy.merges += 1
            return Spy(max(self.depth, other.depth) + 1)

    folder = StreamStateFolder()
    for _ in range(64):
        folder.add(Spy())
    out = folder.result()
    assert Spy.merges == 63
    assert out.depth == 6
    folder2 = StreamStateFolder()
    folder2.add(None)  # an all-null batch adds no state
    assert folder2.result() is None


def test_histogram_on_stream_equals_materialized(mixed_table):
    h = Histogram("cat")
    mem = h.calculate(mixed_table).value.get()
    stream = h.calculate(stream_table(mixed_table, batch_rows=7_000)).value.get()
    assert mem.number_of_bins == stream.number_of_bins
    assert ({k: v.absolute for k, v in mem.values.items()}
            == {k: v.absolute for k, v in stream.values.items()})


# -- port-only ---------------------------------------------------------------------


def _in_memory_run(table, analyzers, chunk: int):
    """An in-memory run whose scan cuts the table at ``chunk`` rows (the
    chunk rule's floor, 2^18 rows, is above these tables' sizes)."""
    real = scan_engine._auto_chunk_rows
    scan_engine._auto_chunk_rows = lambda cols, *args, **kwargs: chunk
    try:
        return AnalysisRunner.do_analysis_run(table, analyzers)
    finally:
        scan_engine._auto_chunk_rows = real


def _smoke_analyzers():
    return [
        Size(), Completeness("f0"), Mean("f0"), Sum("f1"), Minimum("f2"), Maximum("f3"),
        StandardDeviation("f0"), StandardDeviation("f3"),
        port_analyzers.Correlation("f0", "f1"),
        port_analyzers.Compliance("f2 big", "f2 > 25", where="status = 'S1'"),
        ApproxCountDistinct("customer_id"), ApproxCountDistinct("region"),
        ApproxQuantile("f0", 0.5), port_analyzers.ApproxQuantiles("f1", (0.1, 0.9)),
        KLLSketch("f2"),
        PatternMatch("region", r"R00[0-4].*"),
        Uniqueness(["id"]), Uniqueness(["customer_id"]),
        port_analyzers.UniqueValueRatio(["customer_id"]),
        Distinctness(["status"]), CountDistinct(["customer_id"]), Entropy("region"),
        MutualInformation("status", "region"), Histogram("status"),
    ]


@pytest.mark.parametrize("rows,chunk", [(40_000, 9_000), (25_000, 25_000)])
def test_stream_at_chunk_rows_gives_in_memory_bits(parity_env, rows, chunk):
    """A stream whose batch rows are the in-memory run's chunk rows gives
    that run's bits on every metric: the same chunks, the same per-chunk
    partials in the same flat layout, folded in the same order; the
    grouping's frequency table, folded a batch, holds the in-memory
    counts (its entropy sums them in the same key order)."""
    from torch_parity import smoke_schema_table

    table = port_table(smoke_schema_table(rows, seed=3))
    analyzers = _smoke_analyzers()
    mem = _in_memory_run(table, analyzers, chunk)
    SCAN_STATS.reset()
    streamed = AnalysisRunner.do_analysis_run(stream_table(table, batch_rows=chunk), analyzers)
    assert SCAN_STATS.chunks_staged == -(-rows // chunk)
    assert _bits(streamed, analyzers) == _bits(mem, analyzers)


def test_monoid_stream_fetches_once_over_many_chunks(monkeypatch):
    """A stream of monoid ops (no gather leaf) folds every chunk on the
    device and fetches once, however many chunks it has — past the fold's
    capacity too; the double buffer staged every chunk after the first
    behind its predecessor."""
    monkeypatch.setattr(scan_engine, "STREAM_FOLD_CAPACITY", 4)
    rng = np.random.default_rng(1)
    t = ColumnarTable([Column("x", DType.FRACTIONAL, values=rng.normal(size=25_000),
                              mask=rng.random(25_000) > 0.1)])
    analyzers = [Size(), Completeness("x"), Mean("x"), Sum("x"), Minimum("x"), Maximum("x")]
    SCAN_STATS.reset()
    AnalysisRunner.do_analysis_run(stream_table(t, batch_rows=1_000), analyzers)
    assert SCAN_STATS.device_fetches == 1 and SCAN_STATS.last_scan_fetches == 1
    assert SCAN_STATS.fold_drains == 0
    assert SCAN_STATS.chunks_staged == 25
    assert SCAN_STATS.ingest_overlap_frac == 24 / 25


def test_gather_drains_keep_in_memory_bits(monkeypatch):
    """A stream of more chunks than the fold holds drains its gather
    leaves (per-chunk moments) every capacity chunks, one fetch each; the
    elementwise accumulator keeps folding on the device, so every metric
    keeps the in-memory run's bits."""
    rng = np.random.default_rng(2)
    t = ColumnarTable([Column("x", DType.FRACTIONAL, values=rng.normal(1e6, 1.0, 20_000)),
                       Column("y", DType.FRACTIONAL, values=rng.normal(size=20_000))])
    analyzers = [Size(), Mean("x"), Sum("y"), StandardDeviation("x"),
                 port_analyzers.Correlation("x", "y")]
    mem = _in_memory_run(t, analyzers, 1_000)
    monkeypatch.setattr(scan_engine, "STREAM_FOLD_CAPACITY", 6)
    SCAN_STATS.reset()
    streamed = AnalysisRunner.do_analysis_run(stream_table(t, batch_rows=1_000), analyzers)
    assert SCAN_STATS.fold_drains == 3  # 20 chunks: drains at 6, 12 and 18
    assert SCAN_STATS.device_fetches == 4
    assert _bits(streamed, analyzers) == _bits(mem, analyzers)


def test_long_stream_keeps_kll_gather_bounded(monkeypatch):
    """Scaled down (200 chunks through a fold of 8, the threshold at four
    chunks' summaries): the host KLL gather is compacted at the drains and
    stays bounded instead of growing a chunk at a time; every row keeps its
    weight, and the median is within the rank error."""
    import dataclasses

    from deequ_tpu_torch.analyzers.sketches import _kll_scan_op, _kll_state_from_result
    from deequ_tpu_torch.ops.kll_device import strata_capacity

    monkeypatch.setattr(scan_engine, "STREAM_FOLD_CAPACITY", 8)
    rows, batch, k = 400_000, 2_000, 256
    per_chunk = k + strata_capacity(batch, k)  # one chunk's summary values
    source = _segment_source(rows, batch, 0, 77)
    held = []
    real_add = scan_engine._StreamGather.add

    def add(self, parts, final):
        real_add(self, parts, final)
        held.append(max(leaf.size for block in self.blocks for leaf in block.values()))

    monkeypatch.setattr(scan_engine._StreamGather, "add", add)
    op = dataclasses.replace(_kll_scan_op("v", k), compact_threshold=4 * per_chunk)
    SCAN_STATS.reset()
    (result,) = scan_engine.run_scan(StreamingTable(source), [op], "cpu")
    assert SCAN_STATS.fold_drains == rows // batch // 8 - 1
    assert SCAN_STATS.kll_midscan_compactions >= SCAN_STATS.fold_drains - 1
    # never more than a compacted sketch and one drain's block
    assert max(held) <= 4 * per_chunk + 8 * per_chunk
    state = _kll_state_from_result(result, k, 0.64)
    assert state.sketch.count == rows
    values = np.sort(np.concatenate([b["v"].values for b in source.batches()]))
    rank = np.searchsorted(values, state.sketch.quantile(0.5)) / rows
    assert abs(rank - 0.5) <= 0.01


def test_nulls_appearing_midstream_keep_bits():
    """A column with no null in its first batches and nulls later packs
    without a mask row, then with one; the chunks' partials keep one flat
    layout and the bits of the in-memory run, whose chunks all carry the
    mask row."""
    rng = np.random.default_rng(3)
    values = rng.normal(size=12_000)
    mask = np.ones(12_000, dtype=bool)
    mask[9_500:9_600] = False
    t = ColumnarTable([Column("x", DType.FRACTIONAL, values=values, mask=mask)])
    analyzers = [Size(), Completeness("x"), Mean("x"), StandardDeviation("x"),
                 Minimum("x"), ApproxQuantile("x", 0.3)]
    mem = _in_memory_run(t, analyzers, 3_000)
    streamed = AnalysisRunner.do_analysis_run(stream_table(t, batch_rows=3_000), analyzers)
    assert _bits(streamed, analyzers) == _bits(mem, analyzers)


class _FlakySource(BatchSource):
    """A table source whose batch 2 fails its first read with an OSError."""

    def __init__(self, table, batch_rows):
        from deequ_tpu_torch.data.source import TableBatchSource

        self.inner = TableBatchSource(table, batch_rows)
        self._batch_rows = batch_rows
        self.failures = 0

    @property
    def schema(self):
        return self.inner.schema

    @property
    def num_rows(self):
        return self.inner.num_rows

    def batches(self, columns=None, batch_rows=None):
        yield from self.batches_from(0, columns, batch_rows)

    def batches_from(self, start=0, columns=None, batch_rows=None):
        for i, batch in enumerate(self.inner.batches_from(start, columns, batch_rows), start):
            if i == 2 and self.failures == 0:
                self.failures += 1
                raise OSError("transient read error")
            yield batch


def test_retried_read_gives_the_clean_reads_bits(mixed_table):
    """A transient error reopens the read at the failing batch: the same
    batches in the same order, so the clean read's bits."""
    analyzers = ANALYZERS + [ApproxQuantile("v", 0.5)]
    clean = AnalysisRunner.do_analysis_run(stream_table(mixed_table, 4_000), analyzers)
    flaky = _FlakySource(mixed_table, 4_000)
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
    retried = AnalysisRunner.do_analysis_run(StreamingTable(flaky), analyzers,
                                             retry_policy=policy)
    assert flaky.failures == 1
    assert _bits(retried, analyzers) == _bits(clean, analyzers)
    with pytest.raises(OSError):
        list(StreamingTable(_FlakySource(mixed_table, 4_000)).batches())


def test_persist_of_a_stream_raises_type_error(mixed_table):
    stream = stream_table(mixed_table, 5_000)
    with pytest.raises(TypeError, match="cannot be persisted"):
        stream.persist()
    with pytest.raises(TypeError, match="cannot be persisted"):
        stream.persist("cpu")
    assert stream.unpersist() is stream and not stream.is_persisted


def test_spilling_group_budget_raises_not_yet_ported(mixed_table):
    """Spill is ported (the name is kept from when it was not): a grouping
    state that passes its group memory budget's spill threshold spills
    sorted runs and gives the unbudgeted metrics; one that stays below
    folds in memory and spills nothing."""
    stream = stream_table(mixed_table, 5_000)
    small = stream.with_group_memory_budget(64 << 10)
    want = AnalysisRunner.do_analysis_run(stream, [Uniqueness(["id"])])
    SCAN_STATS.reset()
    got = AnalysisRunner.do_analysis_run(small, [Uniqueness(["id"])])
    assert SCAN_STATS.spill_runs >= 2
    assert got.metric(Uniqueness(["id"])).value.get() == want.metric(Uniqueness(["id"])).value.get()
    hist = Histogram("id")
    assert hist.calculate(small).value.get() == hist.calculate(stream).value.get()
    roomy = stream.with_group_memory_budget(64 << 20)
    SCAN_STATS.reset()
    ctx = AnalysisRunner.do_analysis_run(roomy, [Uniqueness(["id"]), CountDistinct(["cat"])])
    assert ctx.metric(Uniqueness(["id"])).value.get() == 1.0
    assert ctx.metric(CountDistinct(["cat"])).value.get() == 13.0
    assert SCAN_STATS.spill_runs == 0


class _BrokenSource(_FlakySource):
    """A table source whose batch 2 fails every read with ``error``."""

    def __init__(self, table, batch_rows, error):
        super().__init__(table, batch_rows)
        self.error = error

    def batches_from(self, start=0, columns=None, batch_rows=None):
        for i, batch in enumerate(self.inner.batches_from(start, columns, batch_rows), start):
            if i == 2:
                self.failures += 1
                raise self.error
            yield batch


@pytest.mark.parametrize("error,raised,reads", [
    (OSError("gone"), RetryExhaustedException, 3),
    (ValueError("a bug, not the storage"), ValueError, 1),
    (RetryExhaustedException("batch 2 read", 3, OSError("gone")), RetryExhaustedException, 1),
], ids=["retries_run_out", "not_retryable", "inner_layer_exhausted"])
def test_retried_read_that_keeps_failing_raises(mixed_table, error, raised, reads):
    """A batch that fails every read raises RetryExhaustedException once
    the policy's attempts are spent, each attempt a reopen at that batch;
    an error the policy does not retry, or one an inner retry layer has
    already given up on, propagates after one read."""
    source = _BrokenSource(mixed_table, 4_000, error)
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
    seen = []
    with pytest.raises(raised):
        for batch in StreamingTable(source).with_retry(policy).batches():
            seen.append(batch.num_rows)
    assert source.failures == reads
    assert seen == [4_000, 4_000]


def test_generator_source_chunks_follow_its_first_batch():
    """A generator source states no batch size: the scan cuts its chunks
    at its first batch's rows (below the 128 MiB rule), so a stream of
    1,000-row batches stages one chunk a batch and gives the bits of an
    in-memory run cut at 1,000 rows."""
    rng = np.random.default_rng(5)
    values, mask = rng.normal(size=7_500), rng.random(7_500) > 0.05
    table = ColumnarTable([Column("x", DType.FRACTIONAL, values=values, mask=mask)])
    schema = Schema([Field("x", DType.FRACTIONAL)])

    def factory():
        for start in range(0, 7_500, 1_000):
            yield table.filter_rows((np.arange(7_500) >= start) & (np.arange(7_500) < start + 1_000))

    source = GeneratorBatchSource(schema, factory)
    assert StreamingTable(source).preferred_batch_rows is None
    analyzers = [Size(), Mean("x"), StandardDeviation("x"), ApproxQuantile("x", 0.5)]
    SCAN_STATS.reset()
    streamed = AnalysisRunner.do_analysis_run(StreamingTable(source), analyzers)
    assert SCAN_STATS.chunks_staged == 8
    assert _bits(streamed, analyzers) == _bits(_in_memory_run(table, analyzers, 1_000),
                                               analyzers)


def test_prefetch_reader_stops_when_the_consumer_leaves():
    from deequ_tpu_torch.ops.scan_engine import _prefetch

    produced = []

    def source():
        for i in range(1_000):
            produced.append(i)
            yield i

    gen = _prefetch(source(), depth=2)
    assert next(gen) == 0
    gen.close()
    time.sleep(0.5)
    settled = len(produced)
    time.sleep(0.3)
    assert len(produced) == settled < 10
    assert not any(t.name == "deequ-torch-prefetch" and t.is_alive()
                   for t in threading.enumerate())


# -- parity with the reference: a Parquet file and a CSV file ---------------------


def _parity_table(rows: int, seed: int) -> ColumnarTable:
    rng = np.random.default_rng(seed)
    return ColumnarTable([
        Column("x", DType.FRACTIONAL, values=rng.normal(50.0, 7.0, rows),
               mask=rng.random(rows) > 0.02),
        Column("y", DType.FRACTIONAL, values=rng.gamma(2.0, 3.0, rows)),
        Column("k", DType.INTEGRAL, values=rng.integers(0, 40, rows)),
        Column("s", DType.STRING, codes=rng.integers(-1, 12, rows).astype(np.int32),
               dictionary=np.array([f"s{i:02d}" for i in range(12)], dtype=object)),
    ])


def _parity_analyzers(pkg):
    return [
        pkg.Size(), pkg.Completeness("x"), pkg.Completeness("s"),
        pkg.Minimum("x"), pkg.Maximum("y"), pkg.Sum("y"), pkg.Mean("x"),
        pkg.StandardDeviation("y"), pkg.Correlation("x", "y"),
        pkg.ApproxCountDistinct("k"), pkg.ApproxCountDistinct("s"),
        pkg.Uniqueness(["k"]), pkg.Entropy("s"), pkg.CountDistinct(["s"]),
        pkg.Histogram("k"),
    ]


def _quantiles_within_rank_error(port_ctx, ref_ctx, values, pkg_port, pkg_ref):
    """Each package's median of x within the KLL rank error of numpy."""
    s = np.sort(values)
    for ctx, pkg in ((port_ctx, pkg_port), (ref_ctx, pkg_ref)):
        q = ctx.metric_map[pkg.ApproxQuantile("x", 0.5)].value.get()
        lo, hi = np.searchsorted(s, q, "left"), np.searchsorted(s, q, "right")
        target = 0.5 * len(s)
        err = 0.0 if lo <= target <= hi else min(abs(lo - target), abs(hi - target)) / len(s)
        assert err <= 0.01, (pkg.__name__, q, err)


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_file_stream_parity_with_reference(parity_env, monkeypatch, tmp_path, fmt):
    """The reference under DEEQU_TPU_COMPUTE=f64: its default (hi, lo)
    pairs put Minimum/Maximum up to 2^-48 off the data value (ROADMAP
    queue 3); the port's are held to numpy as well."""
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    table = _parity_table(30_000, seed=9)
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "parquet":
        write_parquet(table, path, row_group_rows=4_096)
        port_stream = stream_parquet(path, batch_rows=5_000)
        ref_stream = ref_io.stream_parquet(path, batch_rows=5_000)
    else:
        with open(path, "w") as f:
            f.write("x,y,k,s\n")
            for row in zip(*(table[c].to_pylist() for c in ("x", "y", "k", "s"))):
                f.write(",".join("" if v is None else repr(v) if isinstance(v, float)
                                 else str(v) for v in row) + "\n")
        port_stream = stream_csv(path, batch_rows=5_000)
        ref_stream = ref_io.stream_csv(path, batch_rows=5_000)
    port_an = _parity_analyzers(port_analyzers) + [port_analyzers.ApproxQuantile("x", 0.5)]
    ref_an = _parity_analyzers(ref_analyzers) + [ref_analyzers.ApproxQuantile("x", 0.5)]
    port_ctx = AnalysisRunner.do_analysis_run(port_stream, port_an)
    with use_mesh(None):
        ref_ctx = RefRunner.do_analysis_run(ref_stream, ref_an)
    for p, r in zip(port_an[:-1], ref_an[:-1]):
        if isinstance(p, port_analyzers.Histogram):
            want, got = ref_ctx.metric_map[r].value.get(), port_ctx.metric_map[p].value.get()
            assert {k: v.absolute for k, v in want.values.items()} == {
                k: v.absolute for k, v in got.values.items()}
            continue
        assert_metric_parity(ref_ctx.metric_map[r], port_ctx.metric_map[p])
    x, y = table["x"], table["y"]
    assert port_ctx.metric_map[port_an[3]].value.get() == x.values[x.mask].min()
    assert port_ctx.metric_map[port_an[4]].value.get() == y.values.max()
    _quantiles_within_rank_error(port_ctx, ref_ctx, x.values[x.mask],
                                 port_analyzers, ref_analyzers)
