"""The port's frequency tables, Histogram and MutualInformation against the
reference's, on the CPU.

The same seeded table goes through ``deequ_tpu`` and ``deequ_tpu_torch``
at 3,000 rows (both packages take their host route, at or below
``HOST_GROUP_LIMIT`` = 2^14 rows) and at 20,000 rows (the device route:
the histogram of ops/histogram_device.py, the top-k ranked on the device,
the sparse run-length route), with string, int, float (with NaN, which
forms ONE group, and -0.0) and boolean keys and nulls. Exact: frequency
states (by ``as_dict``), their merge, Histogram Distributions (a tied
truncation boundary, the literal "NullValue" merged with nulls, binning
UDFs, the parameter precondition); relative 1e-12: MutualInformation.
"""

import math

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.segment as ref_segment
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.segment as port_segment
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from torch_parity import port_table, ref_column

pytestmark = pytest.mark.torch_port

ROWS = (3000, 20000)  # either side of HOST_GROUP_LIMIT = 2^14


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(n: int, null_literal: bool = False) -> RefTable:
    rng = np.random.default_rng(31 + n)
    f = np.round(rng.normal(0.0, 2.0, n), 1)
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.02] = -0.0
    f[rng.random(n) < 0.05] = 3.0  # integral floats stringify as "3.0"
    words = [f"w{j:02d}" for j in range(39)]
    words.append("NullValue" if null_literal else "w39")
    return RefTable([
        ref_column("s", "string", codes=rng.integers(-1, 40, n).astype(np.int32),
                   dictionary=words),
        ref_column("i", "integral", rng.integers(-50, 250, n), rng.random(n) > 0.05),
        ref_column("f", "fractional", f, rng.random(n) > 0.1),
        ref_column("b", "boolean", rng.random(n) > 0.3, rng.random(n) > 0.2),
        ref_column("u", "integral", rng.permutation(n).astype(np.int64),
                   rng.random(n) > 0.01),
    ])


def _canon(d: dict) -> dict:
    """NaN keys compared as one value (nan != nan in a dict lookup)."""
    def cell(x):
        return "<NaN>" if isinstance(x, float) and math.isnan(x) else x

    return {tuple(cell(x) for x in k): v for k, v in d.items()}


def _assert_same_state(ref_state, port_state):
    assert port_state.columns == ref_state.columns
    assert port_state.num_rows == ref_state.num_rows
    assert _canon(port_state.as_dict()) == _canon(ref_state.as_dict())


GROUPINGS = [("s",), ("i",), ("f",), ("b",), ("u",), ("i", "s"), ("f", "b"), ("s", "u")]


@pytest.mark.parametrize("path", ["dense", "sparse"])
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("cols", GROUPINGS, ids=",".join)
def test_frequency_state_matches_reference(cols, n, path, monkeypatch):
    if path == "sparse":
        # every grouping has a key space above 2 slots
        monkeypatch.setattr(ref_segment, "DENSE_KEYSPACE_LIMIT", 2)
        monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 2)
    ref = _table(n)
    SCAN_STATS.reset()
    port = port_segment.group_counts_state(port_table(ref), cols, "cpu")
    if n > port_segment.HOST_GROUP_LIMIT and path == "dense":
        assert SCAN_STATS.hist_plain_dispatches == 1
    _assert_same_state(ref_segment.group_counts_state(ref, cols), port)


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("cols", [("s",), ("f",), ("i", "s")], ids=",".join)
def test_frequency_state_sum(cols, n):
    """The monoid: the states of two halves merged equal the whole's
    state, and the reference's merge of the same halves."""
    ref = _table(n)
    half = n // 2
    ref_a = ref.filter_rows(np.arange(n) < half)
    ref_b = ref.filter_rows(np.arange(n) >= half)
    port_a, port_b, port_all = (
        port_segment.group_counts_state(port_table(t), cols, "cpu")
        for t in (ref_a, ref_b, ref)
    )
    merged = port_a.sum(port_b)
    assert merged == port_all
    _assert_same_state(port_all, merged)
    ref_merged = ref_segment.group_counts_state(ref_a, cols).sum(
        ref_segment.group_counts_state(ref_b, cols)
    )
    _assert_same_state(ref_merged, merged)


def test_group_counts_dict_view():
    ref = _table(3000)
    port, rows = port_segment.group_counts(port_table(ref), ["b", "s"], "cpu")
    want, want_rows = ref_segment.group_counts(ref, ["b", "s"])
    assert (port, rows) == (want, want_rows)


def test_frequencies_from_dict_round_trip():
    freqs = {("a", 1): 3, ("b", None): 2, (None, 2): 1}
    state = port_analyzers.FrequenciesAndNumRows.from_dict(("x", "y"), freqs, 6)
    ref = ref_analyzers.grouping.FrequenciesAndNumRows.from_dict(("x", "y"), freqs, 6)
    assert state.as_dict() == freqs == ref.as_dict()
    assert state.num_groups == 3 and state.num_rows == 6
    with pytest.raises(TypeError):
        port_analyzers.FrequenciesAndNumRows.from_dict(("x",), {("a",): 1, (5,): 1}, 2)


def _distribution(metric):
    assert metric.value.is_success, metric
    dist = metric.value.get()
    return dist.number_of_bins, {
        k: (v.absolute, v.ratio) for k, v in dist.values.items()
    }


def _histograms(module):
    parity = lambda x: None if x is None else int(x) % 3  # noqa: E731
    return [
        module.Histogram("s"),
        module.Histogram("i"),
        module.Histogram("f"),
        module.Histogram("b"),
        module.Histogram("u"),
        # a tied truncation boundary: many values share the boundary count
        module.Histogram("s", max_detail_bins=7),
        module.Histogram("u", max_detail_bins=5),
        # binning UDFs: the state path, ties broken by the stringified key
        module.Histogram("s", binning_udf=lambda v: v[:2], max_detail_bins=3),
        module.Histogram("i", binning_udf=parity),
        module.Histogram("f", binning_udf=lambda v: math.floor(v) if v == v else -1,
                         max_detail_bins=4),
        module.Histogram("s", max_detail_bins=1001),
    ]


_HIST = {}


def _histogram_results(n, null_literal):
    key = (n, null_literal)
    if key not in _HIST:
        ref = _table(n, null_literal)
        refs, ports = _histograms(ref_analyzers), _histograms(port_analyzers)
        port_ctx = PortRunner.do_analysis_run(port_table(ref), ports, device="cpu")
        ref_ctx = RefRunner.do_analysis_run(ref, refs)
        _HIST[key] = [(ref_ctx.metric(r), port_ctx.metric(p)) for r, p in zip(refs, ports)]
    return _HIST[key]


@pytest.mark.parametrize("null_literal", [False, True], ids=["plain", "NullValue-literal"])
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("case", range(10))
def test_histogram_matches_reference(case, n, null_literal):
    ref_metric, port_metric = _histogram_results(n, null_literal)[case]
    assert _distribution(port_metric) == _distribution(ref_metric)


def test_histogram_null_literal_merges_with_nulls():
    ref = _table(20000, null_literal=True)
    codes = ref["s"].codes
    want = int((codes == 39).sum() + (codes < 0).sum())
    _, port_metric = _histogram_results(20000, True)[0]
    assert port_metric.value.get().values["NullValue"].absolute == want


@pytest.mark.parametrize("n", ROWS)
def test_histogram_tied_boundary_keeps_lower_slot(n):
    """At max_detail_bins=5 over the all-distinct 'u', every boundary
    count is 1: the five kept are the null group (if it leads) and then
    the smallest values, the reference's lower-slot-first order."""
    ref_metric, port_metric = _histogram_results(n, False)[6]
    ref_tbl = _table(n)
    u = np.sort(ref_tbl["u"].values[ref_tbl["u"].mask])
    nulls = int((~ref_tbl["u"].mask).sum())
    want = (["NullValue"] if nulls > 1 else []) + [str(v) for v in u[:5]]
    assert list(port_metric.value.get().values)[:5] == want[:5]
    assert _distribution(port_metric) == _distribution(ref_metric)


def test_histogram_detail_bins_precondition():
    ref_metric, port_metric = _histogram_results(3000, False)[10]
    assert not port_metric.value.is_success
    assert type(port_metric.value.exception).__name__ == "IllegalAnalyzerParameterException"
    assert str(port_metric.value.exception) == str(ref_metric.value.exception)


_MI = {}


@pytest.mark.parametrize("path", ["dense", "sparse"])
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("cols", [("s", "i"), ("f", "b"), ("u", "s")], ids=",".join)
def test_mutual_information_matches_reference(cols, n, path, monkeypatch):
    if path == "sparse":
        monkeypatch.setattr(ref_segment, "DENSE_KEYSPACE_LIMIT", 2)
        monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 2)
    ref = _table(n)
    ref_metric = RefRunner.do_analysis_run(
        ref, [ref_analyzers.MutualInformation(*cols)]
    ).metric(ref_analyzers.MutualInformation(*cols))
    port_metric = PortRunner.do_analysis_run(
        port_table(ref), [port_analyzers.MutualInformation(*cols)], device="cpu"
    ).metric(port_analyzers.MutualInformation(*cols))
    a, b = ref_metric.value.get(), port_metric.value.get()
    assert port_metric.name == "MutualInformation" and port_metric.instance == ",".join(cols)
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (a, b)


def test_mutual_information_needs_two_columns():
    port = PortRunner.do_analysis_run(
        port_table(_table(3000)), [port_analyzers.MutualInformation(["s"])], device="cpu"
    )
    metric = port.metric(port_analyzers.MutualInformation(["s"]))
    assert type(metric.value.exception).__name__ == "NumberOfSpecifiedColumnsException"


def test_count_stats_sets_skip_the_frequency_table(monkeypatch):
    """A grouping set of count-only analyzers takes group_count_stats; one
    holding MutualInformation takes the frequency table."""
    calls = []
    real = port_segment.group_counts_state
    monkeypatch.setattr(
        "deequ_tpu_torch.analyzers.runner.group_counts_state",
        lambda *a, **k: calls.append(a[1]) or real(*a, **k),
    )
    table = port_table(_table(3000))
    PortRunner.do_analysis_run(
        table,
        [port_analyzers.Uniqueness(["s", "i"]), port_analyzers.Entropy("s"),
         port_analyzers.MutualInformation("i", "s"), port_analyzers.Distinctness(["i", "s"])],
        device="cpu",
    )
    assert calls == [["i", "s"]]


def test_main_path_keeps_the_count_stats_route(monkeypatch):
    """chip_smoke.py's main-path check (Uniqueness, Distinctness, Entropy,
    UniqueValueRatio, CountDistinct) never builds a frequency table."""
    import importlib.util
    from pathlib import Path

    import deequ_tpu_torch

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_main", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def refuse(*args, **kwargs):
        raise AssertionError("the count-stats route built a frequency table")

    monkeypatch.setattr("deequ_tpu_torch.analyzers.runner.group_counts_state", refuse)
    monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 0)
    table = chip_smoke.make_table(3000, 0)
    with deequ_tpu_torch.use_device("cpu"):
        result = chip_smoke.build_suite(table).run()
    assert all(m.value.is_success for m in result.metrics.values())
    assert {type(a).__name__ for a in result.metrics} >= {
        "Uniqueness", "Distinctness", "Entropy", "UniqueValueRatio", "CountDistinct"}
