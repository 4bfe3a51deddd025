"""Saved, merged and streamed analyzer states in the port, against the
reference on the CPU.

- Twins of tests/test_incremental.py, run through ``deequ_tpu_torch``:
  incremental == batch, ``run_on_aggregated_states``, the partition
  update, the filesystem round trip, KLL incremental, the pipelined stream
  == the serial loop bit for bit (with string columns, with an outlier
  batch that falls back, with batches the group path refuses), the
  multi-chunk refusal and the group path engaging (one scan pass a
  group). The streaming-and-mixed-schema test's two halves are twinned
  apart: batches that are StreamingTables (their scans run at once when
  their group dispatches, never in the group scan) and mixed schemas.
- Across packages: states the reference saves to a
  ``FileSystemStateProvider`` directory merge into the port's run over
  the next batch (and the reverse) to the reference's all-data metrics
  within docs/numerics.md's bounds; both packages name every analyzer's
  state file alike.
- A grouping set whose states are saved or merged materialises its
  frequency table and never takes the count-statistics shortcut.
- Twins of the flows of examples/update_metrics_on_partitioned_data_example.py,
  incremental_metrics_example.py and pipelined_incremental_example.py
  (without its anomaly check and repository, which wait for their slice),
  through both packages.

The mesh/no-mesh matrix: every test here runs twice, over the port's
8-member virtual mesh on the CPU and with no mesh
(``torch_parity.port_mesh_mode``), as the reference's suite runs under
its 8-device mesh and without it; over the mesh the group path stays off
(``group_scannable`` declines), and the group-path holds read the mode.
"""

import math
import os

import numpy as np
import pytest

import deequ_tpu
import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.states as ref_states
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.analyzers.runner import AnalyzerContext as RefContext
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    Completeness,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.incremental import IncrementalAnalysisStream
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.analyzers.runner import AnalyzerContext as PortContext
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.ops.scan_engine import MAX_CHUNK_ROWS, SCAN_STATS, group_scannable
from deequ_tpu_torch.parallel.mesh import current_mesh
from deequ_tpu_torch.parallel.mesh import use_mesh as port_use_mesh
from deequ_tpu_torch.states import (
    FileSystemStateProvider,
    InMemoryStateProvider,
    state_file_name,
)
from torch_parity import assert_metric_parity, parity_env, port_table, port_mesh_mode  # noqa: F401

# every test runs over the port's 8-member virtual mesh and with none
pytestmark = [pytest.mark.torch_port, pytest.mark.usefixtures("port_mesh_mode")]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


INITIAL = {"id": [1.0, 2.0, 3.0, 4.0], "cat": ["a", "b", "a", None],
           "val": [10.0, 20.0, None, 40.0]}
DELTA = {"id": [5.0, 6.0, 7.0], "cat": ["c", "a", "b"], "val": [50.0, None, 70.0]}


@pytest.fixture
def initial():
    return ColumnarTable.from_pydict(INITIAL)


@pytest.fixture
def delta():
    return ColumnarTable.from_pydict(DELTA)


def _analyzers(pkg):
    """tests/test_incremental.py's ANALYZERS, built in ``pkg``."""
    return [
        pkg.Size(), pkg.Completeness("val"), pkg.Minimum("id"), pkg.Maximum("id"),
        pkg.Mean("val"), pkg.Sum("val"), pkg.StandardDeviation("id"),
        pkg.DataType("cat"), pkg.Uniqueness(("cat",)), pkg.Distinctness(("cat",)),
        pkg.CountDistinct(("cat",)), pkg.Entropy("cat"), pkg.ApproxCountDistinct("cat"),
    ]


ANALYZERS = _analyzers(port_analyzers)


def _values(ctx):
    out = {}
    for analyzer, metric in ctx.metric_map.items():
        if metric.value.is_success:
            v = metric.value.get()
            out[repr(analyzer)] = v if isinstance(v, float) else repr(v)
        else:
            out[repr(analyzer)] = "FAILURE"
    return out


def _assert_close(want: dict, got: dict) -> None:
    for key in want:
        w, g = want[key], got[key]
        if isinstance(w, float) and isinstance(g, float):
            assert math.isclose(w, g, rel_tol=1e-9, abs_tol=1e-9), (key, w, g)
        else:
            assert w == g, (key, w, g)


# -- twins of tests/test_incremental.py -------------------------------------


def test_incremental_equals_batch(initial, delta):
    states = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(initial, ANALYZERS, save_states_with=states)
    incremental = AnalysisRunner.do_analysis_run(delta, ANALYZERS, aggregate_with=states)
    batch = AnalysisRunner.do_analysis_run(initial.concat(delta), ANALYZERS)
    _assert_close(_values(batch), _values(incremental))


def test_run_on_aggregated_states(initial, delta):
    states_a, states_b = InMemoryStateProvider(), InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(initial, ANALYZERS, save_states_with=states_a)
    AnalysisRunner.do_analysis_run(delta, ANALYZERS, save_states_with=states_b)
    from_states = AnalysisRunner.run_on_aggregated_states(
        initial.schema, ANALYZERS, [states_a, states_b]
    )
    batch = AnalysisRunner.do_analysis_run(initial.concat(delta), ANALYZERS)
    _assert_close(_values(batch), _values(from_states))


def test_partition_update_workflow(initial, delta):
    parts = {"p1": InMemoryStateProvider(), "p2": InMemoryStateProvider()}
    analyzers = [Size(), Mean("val")]
    AnalysisRunner.do_analysis_run(initial, analyzers, save_states_with=parts["p1"])
    AnalysisRunner.do_analysis_run(delta, analyzers, save_states_with=parts["p2"])
    combined = AnalysisRunner.run_on_aggregated_states(
        initial.schema, analyzers, list(parts.values())
    )
    assert combined.metric_map[Size()].value.get() == 7.0
    new_delta = ColumnarTable.from_pydict({"id": [8.0], "cat": ["z"], "val": [100.0]})
    AnalysisRunner.do_analysis_run(new_delta, analyzers, save_states_with=parts["p2"])
    updated = AnalysisRunner.run_on_aggregated_states(
        initial.schema, analyzers, list(parts.values())
    )
    assert updated.metric_map[Size()].value.get() == 5.0
    assert math.isclose(updated.metric_map[Mean("val")].value.get(),
                        (10.0 + 20.0 + 40.0 + 100.0) / 4)


def test_state_roundtrip_filesystem(tmp_path, initial):
    fs = FileSystemStateProvider(str(tmp_path / "states"))
    AnalysisRunner.do_analysis_run(initial, ANALYZERS, save_states_with=fs)
    from_states = AnalysisRunner.run_on_aggregated_states(initial.schema, ANALYZERS, [fs])
    direct = AnalysisRunner.do_analysis_run(initial, ANALYZERS)
    assert _values(from_states) == _values(direct)
    assert len(os.listdir(tmp_path / "states")) == len(ANALYZERS)


def test_kll_incremental(initial, delta):
    states = InMemoryStateProvider()
    analyzers = [KLLSketch("id")]
    AnalysisRunner.do_analysis_run(initial, analyzers, save_states_with=states)
    inc = AnalysisRunner.do_analysis_run(delta, analyzers, aggregate_with=states)
    dist = inc.metric_map[KLLSketch("id")].value.get()
    assert sum(b.count for b in dist.buckets) == 7
    assert dist.buckets[0].low_value == 1.0
    assert dist.buckets[-1].high_value == 7.0


def _run_stream(batches, analyzers, window, states=True):
    provider = InMemoryStateProvider() if states else None
    stream = IncrementalAnalysisStream(
        analyzers, aggregate_with=provider, save_states_with=provider, window=window
    )
    piped = {}
    for b, batch in enumerate(batches):
        for tag, ctx in stream.submit(batch, tag=b):
            piped[tag] = ctx
    for tag, ctx in stream.close():
        piped[tag] = ctx
    assert sorted(piped) == list(range(len(batches)))
    return piped, provider


def _run_serial(batches, analyzers, states=True):
    provider = InMemoryStateProvider() if states else None
    return [
        AnalysisRunner.do_analysis_run(
            batch, analyzers, aggregate_with=provider, save_states_with=provider
        )
        for batch in batches
    ], provider


def _assert_bit_identical(serial, piped, analyzers):
    for b, ctx in enumerate(serial):
        for a in analyzers:
            want = ctx.metric_map[a].value.get()
            got = piped[b].metric_map[a].value.get()
            assert got == want, (b, a, got, want)


def test_pipelined_stream_equals_serial():
    rng = np.random.default_rng(21)
    batches = []
    for b in range(7):
        batches.append(ColumnarTable([
            Column("v", DType.FRACTIONAL, values=rng.normal(50.0 + b, 5.0, 5000),
                   mask=rng.random(5000) > 0.02),
            Column("c", DType.STRING, codes=rng.integers(0, 40, 5000).astype(np.int32),
                   dictionary=np.array([f"x{i}" for i in range(40)], dtype=object)),
        ]))
    analyzers = [Size(), Completeness("v"), Mean("v"), StandardDeviation("v"),
                 Maximum("v"), ApproxCountDistinct("c"), Uniqueness(("c",))]
    serial, serial_states = _run_serial(batches, analyzers)
    SCAN_STATS.reset()
    piped, stream_states = _run_stream(batches, analyzers, window=3)
    # groups of 3, 3, the last batch alone; over a mesh every batch takes
    # its own sharded scan (group_scannable declines)
    assert SCAN_STATS.group_scan_passes == (2 if current_mesh() is None else 0)
    _assert_bit_identical(serial, piped, analyzers)
    for a in analyzers:  # the state chains end equal too
        assert stream_states.load(a) == serial_states.load(a)


def test_pipelined_stream_mixed_schemas_falls_back():
    """Groups the fast path cannot take — a batch without the scanned
    column, a batch whose string column is numeric — still equal the
    serial loop; the groups that can take it do."""
    rng = np.random.default_rng(4)
    tables = []
    for b in range(6):
        vals = rng.normal(10.0 + b, 1.0, 3000)
        cols = [Column("v", DType.FRACTIONAL, values=vals)]
        if b == 3:
            cols.append(Column("s", DType.FRACTIONAL, values=vals * 2))
        else:
            cols.append(Column("s", DType.STRING,
                               codes=rng.integers(0, 6, 3000).astype(np.int32),
                               dictionary=np.array(list("abcdef"), dtype=object)))
        if b == 4:
            cols = cols[1:]
        tables.append(ColumnarTable(cols))
    analyzers = [Size(), Mean("v"), Completeness("s")]
    serial, _ = _run_serial(tables, analyzers)
    SCAN_STATS.reset()
    piped, _ = _run_stream(tables, analyzers, window=2)
    # batches 0-1; 2-3 and 4-5 fall back (all of them over a mesh)
    assert SCAN_STATS.group_scan_passes == (1 if current_mesh() is None else 0)
    for b in range(6):
        for a in analyzers:
            want, got = serial[b].metric_map[a].value, piped[b].metric_map[a].value
            assert want.is_success == got.is_success, (b, a)
            if want.is_success:
                assert got.get() == want.get(), (b, a)
            else:
                assert str(got.exception) == str(want.exception), (b, a)


def _string_batches(seed: int, count: int):
    rng = np.random.default_rng(seed)
    return [
        ColumnarTable([
            Column("v", DType.FRACTIONAL, values=rng.normal(10.0 + b, 1.0, 3000)),
            Column("s", DType.STRING, codes=rng.integers(0, 6, 3000).astype(np.int32),
                   dictionary=np.array(list("abcdef"), dtype=object)),
        ])
        for b in range(count)
    ]


def test_pipelined_stream_streaming_batches():
    """The streaming half of the reference's streaming-and-mixed-schema
    test: batches that are StreamingTables (each of 3 batches of 1,000
    rows) equal the serial loop of their own runs, states carried."""
    from deequ_tpu_torch.data.streaming import stream_table

    tables = _string_batches(4, 5)
    analyzers = [Size(), Mean("v"), Completeness("s")]
    serial, serial_states = _run_serial(
        [stream_table(t, batch_rows=1000) for t in tables], analyzers)
    piped, piped_states = _run_stream(
        [stream_table(t, batch_rows=1000) for t in tables], analyzers, window=2)
    _assert_bit_identical(serial, piped, analyzers)
    for a in analyzers:
        assert piped_states.load(a) == serial_states.load(a)


def test_streaming_batch_scans_when_its_group_dispatches():
    """A StreamingTable batch never enters the group scan: its streaming
    scan runs at once when its window fills (the reference's
    incremental.py:180-193), and its metrics drain in submission order."""
    from deequ_tpu_torch.data.streaming import stream_table

    tables = _string_batches(6, 4)
    analyzers = [Size(), Mean("v"), StandardDeviation("v")]
    ops = [a.scan_op(tables[0]) for a in analyzers]
    streams = [stream_table(t, batch_rows=1000) for t in tables]
    assert not group_scannable(streams[:2], ops)
    stream = IncrementalAnalysisStream(analyzers, window=2)
    SCAN_STATS.reset()
    assert stream.submit(streams[0], tag=0) == []
    assert SCAN_STATS.scan_passes == 0  # buffered until the window fills
    assert stream.submit(streams[1], tag=1) == []
    assert SCAN_STATS.scan_passes == 2 and SCAN_STATS.chunks_staged == 6
    assert SCAN_STATS.group_scan_passes == 0
    done = dict(stream.submit(streams[2], tag=2))
    done.update(stream.submit(streams[3], tag=3))
    done.update(stream.close())
    assert sorted(done) == [0, 1, 2, 3]
    for b, t in enumerate(tables):
        alone = AnalysisRunner.do_analysis_run(stream_table(t, batch_rows=1000), analyzers)
        for a in analyzers:
            assert done[b].metric_map[a].value.get() == alone.metric_map[a].value.get()


def test_pipelined_stream_outlier_batch_falls_back_bit_exact():
    """A batch with a value past the f32 range and the one null of the
    stream packs another layout (a mask row the others lack): the group
    path falls back, and every batch stays bit-identical."""
    rng = np.random.default_rng(2)
    batches = []
    for b in range(4):
        vals = rng.normal(1e7, 1.0, 2000)
        mask = np.ones(2000, dtype=bool)
        if b == 2:
            vals[7] = 1e39
            mask[11] = False
        batches.append(ColumnarTable([Column("v", DType.FRACTIONAL, values=vals, mask=mask)]))
    analyzers = [Size(), Mean("v"), StandardDeviation("v")]
    ops = [a.scan_op(batches[0]) for a in analyzers]
    assert not group_scannable(batches, ops)
    serial, _ = _run_serial(batches, analyzers)
    SCAN_STATS.reset()
    piped, _ = _run_stream(batches, analyzers, window=4)
    assert SCAN_STATS.group_scan_passes == 0 and SCAN_STATS.scan_passes == 4
    _assert_bit_identical(serial, piped, analyzers)


def test_group_scannable_rejects_multi_chunk_batches():
    small = ColumnarTable([Column("v", DType.FRACTIONAL, values=np.ones(1000))])
    op = Mean("v").scan_op(small)
    assert group_scannable([small, small], [op])

    class FakeBig:
        num_rows = MAX_CHUNK_ROWS + 1
        column_names = ["v"]

        def __contains__(self, name):
            return name == "v"

        def __getitem__(self, name):
            return small["v"]

    assert not group_scannable([FakeBig(), FakeBig()], [op])
    other = ColumnarTable([Column("v", DType.FRACTIONAL, values=np.ones(999))])
    assert not group_scannable([small, other], [op])  # unequal sizes


def test_group_fast_path_engages_and_matches_serial():
    rng = np.random.default_rng(31)
    batches = [
        ColumnarTable([Column("v", DType.FRACTIONAL, values=rng.normal(1.0, 2.0, 4000))])
        for _ in range(6)
    ]
    analyzers = [Size(), Mean("v"), StandardDeviation("v")]
    serial, _ = _run_serial(batches, analyzers)
    SCAN_STATS.reset()
    piped, _ = _run_stream(batches, analyzers, window=3)
    if current_mesh() is None:
        # 6 batches / window 3 = 2 group passes with one fetch each, not 6 scans
        assert SCAN_STATS.scan_passes == 2, SCAN_STATS.scan_passes
        assert SCAN_STATS.group_fetches == 2 and SCAN_STATS.device_fetches == 2
    else:
        # over a mesh the group path stays off: one sharded scan a batch
        assert SCAN_STATS.scan_passes == 6 and SCAN_STATS.group_scan_passes == 0
    _assert_bit_identical(serial, piped, analyzers)


@pytest.mark.parametrize("cap_batches", [1, 2, 5])
def test_group_scan_caps_rows_a_k1_batch_holds(monkeypatch, cap_batches):
    """A group scan resolves its batches' K1 tasks in batches of at most
    ``GROUP_K1_ROWS`` rows (at least one table), and merges the group once:
    a window of 5 batches under a cap of ``cap_batches`` tables takes
    ceil(5 / cap_batches) K1 batches, and every batch keeps its serial bits."""
    from deequ_tpu_torch.ops import masked_reduce, scan_engine

    n = 3000
    rng = np.random.default_rng(35)
    batches = [ColumnarTable([
        Column("v", DType.FRACTIONAL, values=rng.normal(2.0, 1.5, n), mask=rng.random(n) > 0.1),
    ]) for _ in range(5)]
    analyzers = [Size(), Completeness("v"), Mean("v"), StandardDeviation("v"), Minimum("v"),
                 Maximum("v"), Sum("v", where="v > 2")]
    serial, _ = _run_serial(batches, analyzers)
    calls = {"reduce_into": 0, "merge_tags": []}
    reduce_into, merge_tags = masked_reduce.reduce_into, masked_reduce.merge_tags

    def counted_reduce(*a, **k):
        calls["reduce_into"] += 1
        return reduce_into(*a, **k)

    def counted_merge(*a, caller="fold", **k):
        calls["merge_tags"].append(caller)
        return merge_tags(*a, caller=caller, **k)

    monkeypatch.setattr(scan_engine, "GROUP_K1_ROWS", cap_batches * n)
    monkeypatch.setattr(masked_reduce, "reduce_into", counted_reduce)
    monkeypatch.setattr(masked_reduce, "merge_tags", counted_merge)
    SCAN_STATS.reset()
    piped, _ = _run_stream(batches, analyzers, window=5)
    if current_mesh() is None:
        assert SCAN_STATS.group_scan_passes == 1
        assert calls["reduce_into"] == -(-5 // cap_batches)
        assert calls["merge_tags"] == ["group"]
    else:  # over a mesh each batch takes its own sharded scan
        assert SCAN_STATS.group_scan_passes == 0
    _assert_bit_identical(serial, piped, analyzers)


def test_pipelined_group_path_takes_string_columns():
    rng = np.random.default_rng(33)
    batches = []
    for b in range(6):
        card = 30 + 17 * b  # dictionaries of different sizes: padded LUTs
        dic = np.array([f"user{i}@mail.com" if i % 3 else f"bad{i}" for i in range(card)],
                       dtype=object)
        batches.append(ColumnarTable([
            Column("s", DType.STRING, codes=rng.integers(0, card, 4000).astype(np.int32),
                   dictionary=dic),
            Column("v", DType.FRACTIONAL, values=rng.normal(5.0, 1.0, 4000)),
        ]))
    analyzers = [Size(), Completeness("s"), Mean("v"),
                 PatternMatch("s", r"^[a-z0-9]+@[a-z.]+$"), MaxLength("s"), MinLength("s"),
                 ApproxCountDistinct("s"), Mean("v", where="s = 'bad3' OR v > 5")]
    serial = [AnalysisRunner.do_analysis_run(batch, analyzers) for batch in batches]
    SCAN_STATS.reset()
    piped, _ = _run_stream(batches, analyzers, window=3, states=False)
    _assert_bit_identical(serial, piped, analyzers)
    assert SCAN_STATS.scan_passes == (2 if current_mesh() is None else 6), SCAN_STATS.scan_passes


def test_stream_without_card_raises_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from deequ_tpu_torch.exceptions import DeviceUnavailableException

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = current_mesh()
    if mesh is not None:
        # a mesh asked for (on the CPU here) is where the stream runs
        with use_device(None):
            assert IncrementalAnalysisStream([Size()]).device == mesh.lead
    with use_device(None), port_use_mesh(None), pytest.raises(DeviceUnavailableException):
        IncrementalAnalysisStream([Size()])
    with pytest.raises(DeviceUnavailableException):
        deequ_tpu_torch.verification.IncrementalVerificationStream([], device="cuda")
    assert str(IncrementalAnalysisStream([Size()], device="cpu").device) == "cpu"


# -- the count-statistics shortcut ------------------------------------------


@pytest.mark.parametrize("mode", ["save", "aggregate"])
def test_grouping_states_skip_the_count_statistics_shortcut(monkeypatch, initial, mode):
    import deequ_tpu_torch.analyzers.runner as runner

    def refuse(*args, **kwargs):
        raise AssertionError("count-statistics route taken with states asked for")

    monkeypatch.setattr(runner, "group_count_stats", refuse)
    provider = InMemoryStateProvider()
    if mode == "aggregate":
        provider.persist(Uniqueness(("id",)), port_analyzers.FrequenciesAndNumRows.from_dict(
            ("id",), {(9.0,): 1}, 1))
    kwargs = {"save_states_with" if mode == "save" else "aggregate_with": provider}
    ctx = AnalysisRunner.do_analysis_run(initial, [Uniqueness(("id",))], **kwargs)
    assert ctx.metric(Uniqueness(("id",))).value.get() == 1.0
    state = provider.load(Uniqueness(("id",)))
    assert isinstance(state, port_analyzers.FrequenciesAndNumRows)
    assert state.num_rows == (4 if mode == "save" else 1)


def test_histogram_saves_its_frequency_state(initial, delta):
    states = InMemoryStateProvider()
    hist = port_analyzers.Histogram("cat")
    AnalysisRunner.do_analysis_run(initial, [hist], save_states_with=states)
    assert states.load(hist).as_dict() == {("a",): 2, ("b",): 1, ("NullValue",): 1}
    merged = AnalysisRunner.do_analysis_run(delta, [hist], aggregate_with=states)
    batch = AnalysisRunner.do_analysis_run(initial.concat(delta), [hist])
    assert merged.metric(hist).value.get() == batch.metric(hist).value.get()


def test_state_api_of_an_analyzer(initial, delta):
    a, b, target = InMemoryStateProvider(), InMemoryStateProvider(), InMemoryStateProvider()
    mean = Mean("val")
    mean.calculate(initial, save_states_with=a)
    mean.calculate(delta, save_states_with=b)
    mean.aggregate_state_to(a, b, target)
    assert target.load(mean) == port_analyzers.MeanState(190.0, 5)
    assert mean.load_state_and_compute_metric(target).value.get() == 38.0
    copy = InMemoryStateProvider()
    mean.copy_state_to(target, copy)
    assert copy.load(mean) == target.load(mean)


# -- across packages --------------------------------------------------------


def _ref_and_port(data: dict):
    ref = deequ_tpu.ColumnarTable.from_pydict(data)
    return ref, port_table(ref)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_directory_crosses_packages(tmp_path, parity_env, writer):
    """One package saves ``initial``'s states to a directory; the other
    merges them into its run over ``delta``. The merged metrics equal the
    reference's run over both, within docs/numerics.md's bounds."""
    ref_initial, port_initial = _ref_and_port(INITIAL)
    ref_delta, port_delta = _ref_and_port(DELTA)
    ref_list = _analyzers(ref_analyzers) + [ref_analyzers.KLLSketch("id"),
                                            ref_analyzers.Histogram("cat")]
    port_list = ANALYZERS + [KLLSketch("id"), port_analyzers.Histogram("cat")]
    location = str(tmp_path / "states")
    with use_mesh(None):
        if writer == "reference":
            RefRunner.do_analysis_run(ref_initial, ref_list,
                                      save_states_with=ref_states.FileSystemStateProvider(location))
            merged = AnalysisRunner.do_analysis_run(
                port_delta, port_list, aggregate_with=FileSystemStateProvider(location))
        else:
            AnalysisRunner.do_analysis_run(
                port_initial, port_list, save_states_with=FileSystemStateProvider(location))
            merged = RefRunner.do_analysis_run(
                ref_delta, ref_list, aggregate_with=ref_states.FileSystemStateProvider(location))
        want = RefRunner.do_analysis_run(ref_initial.concat(ref_delta), ref_list)
    for ref_a, port_a in zip(ref_list, port_list):
        got = merged.metric(port_a if writer == "reference" else ref_a)
        if ref_a.name == "KLLSketch":  # a merge keeps the items in merge order
            g, w = got.value.get(), want.metric(ref_a).value.get()
            assert repr(g.buckets) == repr(w.buckets) and g.parameters == w.parameters
            assert sorted(g.data[0]) == sorted(w.data[0])
        elif ref_a.name in ("Histogram", "DataType"):
            assert repr(got.value.get()) == repr(want.metric(ref_a).value.get()), ref_a
        else:
            assert_metric_parity(want.metric(ref_a), got)


def _every_analyzer_kind(pkg):
    return [
        pkg.Size(), pkg.Size(where="x > 1"), pkg.Completeness("a"),
        pkg.Compliance("n", "a > 0"), pkg.Minimum("a"), pkg.Maximum("a"), pkg.Mean("a"),
        pkg.Sum("a"), pkg.StandardDeviation("a"), pkg.Correlation("a", "b"),
        pkg.PatternMatch("s", r"^a$"), pkg.MinLength("s"), pkg.MaxLength("s"),
        pkg.DataType("s"), pkg.Uniqueness(("a",)), pkg.UniqueValueRatio(("a",)),
        pkg.Distinctness(("a", "b")), pkg.CountDistinct(("a",)), pkg.Entropy("a"),
        pkg.MutualInformation(("a", "b")), pkg.Histogram("a"),
        pkg.ApproxCountDistinct("a"), pkg.ApproxQuantile("a", 0.5),
        pkg.ApproxQuantiles("a", (0.1, 0.5)), pkg.KLLSketch("a"),
    ]


@pytest.mark.parametrize("index", range(25))
def test_both_packages_name_state_files_alike(tmp_path, index):
    ref_a = _every_analyzer_kind(ref_analyzers)[index]
    port_a = _every_analyzer_kind(port_analyzers)[index]
    assert repr(port_a) == repr(ref_a)
    ref_path = ref_states.FileSystemStateProvider(str(tmp_path))._path(ref_a)
    port_path = FileSystemStateProvider(str(tmp_path))._path(port_a)
    assert port_path == ref_path
    assert os.path.basename(port_path) == state_file_name(port_a)


# -- example flows, through both packages -----------------------------------


def _rows(pkg_context, ctx):
    return pkg_context.success_metrics_as_rows(ctx)


def _assert_rows_agree(ref_rows, port_rows):
    assert len(port_rows) == len(ref_rows)
    for r, p in zip(ref_rows, port_rows):
        assert {k: p[k] for k in ("entity", "instance", "name")} == {
            k: r[k] for k in ("entity", "instance", "name")}
        assert math.isclose(p["value"], r["value"], rel_tol=1e-12), (r, p)


def test_update_metrics_on_partitioned_data_example_parity():
    """examples/update_metrics_on_partitioned_data_example.py in both packages."""

    def flow(pkg, runner, provider_cls):
        parts = {"2024-01-01": {"sales": [1.0, 2.0, None]},
                 "2024-01-02": {"sales": [4.0, 5.0, 6.0]}}
        tables = {d: pkg.ColumnarTable.from_pydict(v) for d, v in parts.items()}
        analyzers = [pkg.analyzers.Size(), pkg.analyzers.Completeness("sales")]
        providers = {}
        for day, table in tables.items():
            providers[day] = provider_cls()
            runner.do_analysis_run(table, analyzers, save_states_with=providers[day])
        schema = tables["2024-01-01"].schema
        total = runner.run_on_aggregated_states(schema, analyzers, list(providers.values()))
        providers["2024-01-01"] = provider_cls()
        runner.do_analysis_run(pkg.ColumnarTable.from_pydict({"sales": [1.0, 2.0, 3.0, 7.0]}),
                               analyzers, save_states_with=providers["2024-01-01"])
        total2 = runner.run_on_aggregated_states(schema, analyzers, list(providers.values()))
        return total, total2

    ref = flow(deequ_tpu, RefRunner, ref_states.InMemoryStateProvider)
    port = flow(deequ_tpu_torch, AnalysisRunner, InMemoryStateProvider)
    for r, p in zip(ref, port):
        _assert_rows_agree(_rows(RefContext, r), _rows(PortContext, p))
    assert _rows(PortContext, port[1])[0]["value"] == 7.0


def test_incremental_metrics_example_parity():
    """examples/incremental_metrics_example.py in both packages."""

    def flow(pkg, runner, provider_cls):
        day1 = pkg.ColumnarTable.from_pydict(
            {"views": [10.0, 20.0, None, 40.0], "region": ["EU", "EU", "US", "US"]})
        day2 = pkg.ColumnarTable.from_pydict({"views": [50.0, 60.0], "region": ["ASIA", "EU"]})
        analyzers = [pkg.analyzers.Size(), pkg.analyzers.Mean("views"),
                     pkg.analyzers.Completeness("views")]
        states = provider_cls()
        day1_metrics = runner.do_analysis_run(day1, analyzers, save_states_with=states)
        combined = runner.do_analysis_run(day2, analyzers, aggregate_with=states)
        return day1_metrics, combined

    ref = flow(deequ_tpu, RefRunner, ref_states.InMemoryStateProvider)
    port = flow(deequ_tpu_torch, AnalysisRunner, InMemoryStateProvider)
    for r, p in zip(ref, port):
        _assert_rows_agree(_rows(RefContext, r), _rows(PortContext, p))
    assert port[1].metric(Mean("views")).value.get() == 36.0


def test_pipelined_incremental_example_parity():
    """examples/pipelined_incremental_example.py in both packages: ten
    daily batches (day 7 four times the volume), a completeness check on
    cumulative states through the pipelined verification stream, window
    4; every day's status and metrics agree, and each equals the port's
    serial loop."""
    from deequ_tpu_torch.verification import IncrementalVerificationStream

    def batches(pkg):
        rng = np.random.default_rng(0)
        out = []
        for day in range(10):
            n = 20_000 if day != 7 else 80_000
            vals = rng.normal(50.0, 10.0, n)
            mask = rng.random(n) > 0.01
            out.append(pkg.data.table.ColumnarTable(
                [pkg.data.table.Column("amount", pkg.data.table.DType.FRACTIONAL,
                                       values=vals, mask=mask)]))
        return out

    def check(pkg):
        return (pkg.Check(pkg.CheckLevel.WARNING, "daily batch quality")
                .has_completeness("amount", lambda c: c > 0.95)
                .has_size(lambda n: n < 200_000))

    def run(pkg, stream_cls, provider):
        stream = stream_cls(checks=[check(pkg)], aggregate_with=provider,
                            save_states_with=provider, window=4)
        finished = []
        for day, batch in enumerate(batches(pkg)):
            finished.extend(stream.submit(batch, result_key=day))
        finished.extend(stream.close())
        return dict(finished)

    ref = run(deequ_tpu, deequ_tpu.IncrementalVerificationStream,
              ref_states.InMemoryStateProvider())
    port = run(deequ_tpu_torch, IncrementalVerificationStream, InMemoryStateProvider())
    assert sorted(port) == list(range(10))
    for day in range(10):
        assert port[day].status.value == ref[day].status.value, day
        ref_metrics = {repr(a): m for a, m in ref[day].metrics.items()}
        for a, m in port[day].metrics.items():
            assert_metric_parity(ref_metrics[repr(a)], m)
    # cumulative rows: 140,000 by day 6, 220,000 by day 7
    assert [port[d].status.value for d in (6, 7)] == ["Success", "Warning"]
    serial_states = InMemoryStateProvider()
    for day, batch in enumerate(batches(deequ_tpu_torch)):
        serial = deequ_tpu_torch.VerificationSuite.do_verification_run(
            batch, [check(deequ_tpu_torch)], aggregate_with=serial_states,
            save_states_with=serial_states)
        assert {repr(a): m.value.get() for a, m in serial.metrics.items()} == {
            repr(a): m.value.get() for a, m in port[day].metrics.items()}
