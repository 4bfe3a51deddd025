"""The port's count-stats grouping analyzers against the reference's, on
the CPU: Uniqueness, UniqueValueRatio, Distinctness, CountDistinct and
Entropy over int, float-with-NaN (all NaNs form ONE group) and string
columns, single- and two-column groupings, on both the dense path (the
histogram of ops/histogram_device.py) and the sparse path (a device
lexsort plus run lengths; reached cheaply by shrinking
DENSE_KEYSPACE_LIMIT on both sides). Counts, groups and singletons are
exact; Entropy is relative 1e-12."""

import numpy as np
import pytest

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.segment as ref_segment
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.segment as port_segment
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from torch_parity import assert_metric_parity, parity_env, port_table, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port


def _table():
    rng = np.random.default_rng(21)
    n = 4000
    f = np.round(rng.normal(0.0, 3.0, n), 1)
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.01] = -0.0
    return RefTable([
        ref_column("i", "integral", rng.integers(0, 600, n), rng.random(n) > 0.05),
        ref_column("u", "integral", rng.permutation(n).astype(np.int64), np.ones(n, bool)),
        ref_column("f", "fractional", f, rng.random(n) > 0.1),
        ref_column("s", "string", codes=rng.integers(-1, 40, n).astype(np.int32),
                   dictionary=[f"k{j:02d}" for j in range(40)]),
        ref_column("b", "boolean", rng.random(n) > 0.3, rng.random(n) > 0.2),
    ])


GROUPINGS = [("i",), ("u",), ("f",), ("s",), ("b",), ("i", "s"), ("f", "s"), ("u", "i")]
ANALYZERS = ("Uniqueness", "UniqueValueRatio", "Distinctness", "CountDistinct", "Entropy")
CASES = [
    (path, cols, name)
    for path in ("dense", "sparse")
    for cols in GROUPINGS
    for name in ANALYZERS
    if name != "Entropy" or len(cols) == 1
]

_RESULTS = {}


def _analyzer(module, name, cols):
    cls = getattr(module, name)
    return cls(cols[0]) if name == "Entropy" else cls(list(cols))


def _results(path, monkeypatch):
    if path not in _RESULTS:
        if path == "sparse":
            # every grouping of the table has a key space above 2 slots
            monkeypatch.setattr(ref_segment, "DENSE_KEYSPACE_LIMIT", 2)
            monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 2)
        ref = _table()
        refs = [_analyzer(ref_analyzers, n, c) for _, c, n in CASES if _ == path]
        ports = [_analyzer(port_analyzers, n, c) for _, c, n in CASES if _ == path]
        SCAN_STATS.reset()
        port_ctx = PortRunner.do_analysis_run(port_table(ref), ports, device="cpu")
        census = SCAN_STATS.snapshot()
        ref_ctx = RefRunner.do_analysis_run(ref, refs)
        _RESULTS[path] = (
            {(type(p).__name__, tuple(p.group_columns)): (ref_ctx.metric(r), port_ctx.metric(p))
             for r, p in zip(refs, ports)},
            census,
        )
    return _RESULTS[path]


@pytest.mark.parametrize(
    "path,cols,name", CASES, ids=[f"{p}-{'+'.join(c)}-{n}" for p, c, n in CASES]
)
def test_grouping_parity(parity_env, monkeypatch, path, cols, name):
    metrics, _ = _results(path, monkeypatch)
    ref_metric, port_metric = metrics[(name, cols)]
    assert ref_metric.value.is_success
    assert_metric_parity(ref_metric, port_metric)


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_grouping_route_census(parity_env, monkeypatch, path):
    """Dense sets count through the port's bincount (one dispatch per
    grouping set, its plain version on the CPU); sparse sets sort."""
    _, census = _results(path, monkeypatch)
    assert census["grouping_passes"] == len(GROUPINGS)
    assert census["hist_kernel_dispatches"] == 0
    assert census["hist_host_dispatches"] == 0
    if path == "dense":
        assert census["hist_plain_dispatches"] == len(GROUPINGS)
    else:
        assert census["hist_plain_dispatches"] == 0
        assert census["device_sort_passes"] >= len(GROUPINGS)


def test_nan_values_form_one_group(parity_env):
    """All NaNs of a float column are ONE group (torch.unique would split
    them); -0.0 and 0.0 are one group too."""
    vals = np.array([np.nan, 1.0, np.nan, -0.0, 0.0, 2.0, np.nan, 1.0])
    ref = RefTable([ref_column("f", "fractional", vals, np.ones(len(vals), bool))])
    stats = port_segment.group_count_stats(port_table(ref), ["f"], "cpu")
    assert (stats.num_rows, stats.num_groups, stats.singletons) == (8, 4, 1)


def test_host_path_below_limit_matches_device_path(parity_env, monkeypatch):
    """At or below HOST_GROUP_LIMIT rows the same statistics come from the
    host (the reference's latency regime): every dense count is a host
    dispatch, none reaches the histogram."""
    table = port_table(_table())
    device_stats = {
        cols: port_segment.group_count_stats(table, list(cols), "cpu")
        for cols in GROUPINGS
    }
    monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 1 << 20)
    SCAN_STATS.reset()
    for cols in GROUPINGS:
        assert port_segment.group_count_stats(table, list(cols), "cpu") == device_stats[cols]
    assert SCAN_STATS.hist_plain_dispatches == 0
    assert SCAN_STATS.hist_host_dispatches == len(GROUPINGS)
