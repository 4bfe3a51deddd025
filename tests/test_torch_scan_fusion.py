"""Pass accounting of the port's runner against the reference's — twins of
the grouping half of tests/test_scan_fusion.py (and its two scan-sharing
cases), each run with cross-set grouping fusion on and off
(``DEEQU_TORCH_PLAN_FUSION``): the same grouping passes either way, the
fused passes only with it on, and the same metrics as the reference's run
over the same table (tests/torch_parity.py's bounds; counts exact).

The mesh/no-mesh matrix: every test here runs twice, over the port's
8-member virtual mesh on the CPU and with no mesh
(``torch_parity.port_mesh_mode``), as the reference's suite runs under
its 8-device mesh and without it.
"""

import collections

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
from torch_parity import assert_metric_parity, port_table, ref_column, port_mesh_mode  # noqa: F401

# every test runs over the port's 8-member virtual mesh and with none
pytestmark = [pytest.mark.torch_port, pytest.mark.usefixtures("port_mesh_mode")]


@pytest.fixture(params=["fused", "unfused"])
def fusion(request, monkeypatch):
    """Cross-set fusion on ("fused") or off; True when on."""
    on = request.param == "fused"
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "1" if on else "0")
    SCAN_STATS.reset()
    return on


def _unique_columns() -> RefTable:
    return RefTable.from_pydict({
        "unique": ["1", "2", "3", "4", "5", "6"],
        "nonUnique": ["0", "0", "0", "5", "6", "7"],
        "nonUniqueWithNulls": ["1", None, "1", None, None, "2"],
        "uniqueWithNulls": ["1", "2", None, "4", "5", "6"],
        "onlyUniqueWithOtherNonUnique": ["1", "2", "3", "4", "5", "6"],
        "halfUniqueCombinedWithNonUnique": ["0", "1", "1", "2", "3", "4"],
    })


def _numeric_values() -> RefTable:
    return RefTable.from_pydict({
        "item": ["1", "2", "3", "4", "5", "6"],
        "att1": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
        "att2": [0.0, 0.0, 0.0, 5.0, 6.0, 7.0],
    })


def _run_both(ref: RefTable, build):
    """The port's run (on the CPU, counters read after it) and the
    reference's over the same table; every metric held in parity."""
    analyzers = build(port_analyzers)
    SCAN_STATS.reset()
    ctx = PortRunner.do_analysis_run(port_table(ref), analyzers, device="cpu")
    census = SCAN_STATS.snapshot()
    ref_ctx = RefRunner.do_analysis_run(ref, build(ref_analyzers))
    for a, r in zip(analyzers, build(ref_analyzers)):
        mp, mr = ctx.metric_map[a], ref_ctx.metric_map[r]
        if mr.value.is_success and hasattr(mr.value.get(), "values"):  # a Distribution
            assert {k: (v.absolute, v.ratio) for k, v in mp.value.get().values.items()} == {
                k: (v.absolute, v.ratio) for k, v in mr.value.get().values.items()}
        else:
            assert_metric_parity(mr, mp)
    return ctx, census


def test_six_scan_shareable_analyzers_fuse_into_one_pass(fusion):
    ctx, census = _run_both(_numeric_values(), lambda m: [
        m.Size(), m.Completeness("att1"), m.Minimum("att1"), m.Maximum("att1"),
        m.Mean("att1"), m.StandardDeviation("att1"),
    ])
    assert all(m.value.is_success for m in ctx.all_metrics())
    assert census["scan_passes"] == 1
    assert census["grouping_passes"] == 0
    assert census["fused_group_passes"] == 0


def test_sketches_fuse_into_the_same_pass(fusion):
    ctx, census = _run_both(_numeric_values(), lambda m: [
        m.Size(), m.Mean("att1"), m.ApproxCountDistinct("att1"), m.DataType("att1"),
        m.Compliance("c", "att1 > 3"), m.Sum("att2"),
    ])
    assert all(m.value.is_success for m in ctx.all_metrics())
    assert census["scan_passes"] == 1


def test_grouping_analyzers_share_one_frequency_pass(fusion):
    """One grouping set: one pass, and nothing to fuse it with."""
    ctx, census = _run_both(_unique_columns(), lambda m: [
        m.Uniqueness(("nonUnique",)), m.UniqueValueRatio(("nonUnique",)),
        m.CountDistinct(("nonUnique",)),
    ])
    assert all(m.value.is_success for m in ctx.all_metrics())
    assert census["grouping_passes"] == 1
    assert census["scan_passes"] == 0
    assert census["fused_group_passes"] == 0


def test_different_groupings_get_separate_passes(fusion):
    """Three sets: three grouping passes either way; fused, the three ride
    one count (a host one at six rows)."""
    _, census = _run_both(_unique_columns(), lambda m: [
        m.Uniqueness(("unique",)), m.Uniqueness(("nonUnique",)),
        m.Uniqueness(("unique", "nonUnique")),
    ])
    assert census["grouping_passes"] == 3
    assert census["fused_group_passes"] == (3 if fusion else 0)
    assert census["hist_host_dispatches"] == (1 if fusion else 3)


def test_mixed_workload_pass_accounting(fusion):
    _, census = _run_both(_unique_columns(), lambda m: [
        m.Size(), m.Completeness("unique"), m.Uniqueness(("nonUnique",)),
        m.UniqueValueRatio(("nonUnique",)), m.Distinctness(("unique",)),
    ])
    assert census["scan_passes"] == 1
    assert census["grouping_passes"] == 2
    assert census["fused_group_passes"] == (2 if fusion else 0)


def test_precondition_failures_do_not_trigger_passes(fusion):
    ctx, census = _run_both(_numeric_values(), lambda m: [
        m.Completeness("missing_col"), m.Minimum("also_missing"),
        m.Uniqueness(("missing_col",)), m.Distinctness(("also_missing",)),
    ])
    assert all(m.value.is_failure for m in ctx.all_metrics())
    assert census["scan_passes"] == 0
    assert census["grouping_passes"] == 0
    assert census["fused_group_passes"] == 0


def test_numeric_grouping_collapses_nan_to_one_group(fusion):
    """NaN values (possible with user-supplied masks) form ONE distinct
    group, on the set's own pass and fused with another set."""
    nan = float("nan")
    ref = RefTable([
        ref_column("x", "fractional", np.array([1.0, nan, nan, 2.0, nan]), np.ones(5, bool)),
        ref_column("y", "integral", np.array([3, 3, 4, 4, 4]), np.ones(5, bool)),
    ])
    table = port_table(ref)
    codes, values = port_segment.column_key_codes(table["x"], "cpu")
    assert len(values) == 3  # 1.0, 2.0, nan
    assert codes[1] == codes[2] == codes[4]
    freqs, num_rows = port_segment.group_counts(table, ["x"], "cpu")
    assert num_rows == 5
    assert [c for (v,), c in freqs.items() if v != v] == [3]
    ctx, census = _run_both(ref, lambda m: [m.CountDistinct(("x",)), m.Uniqueness(("y",)),
                                            m.Entropy("x")])
    assert ctx.metric_map[port_analyzers.CountDistinct(("x",))].value.get() == 3.0
    assert census["fused_group_passes"] == (2 if fusion else 0)


def test_high_cardinality_grouping_sorts_on_device(fusion):
    """Sparse (huge key-space) grouping sorts on the device, and numeric
    code-building rides the device sort. Through the runner a sparse set is
    prepared twice under fusion, as in the reference: the pre-pass builds
    its codes (two sorts), finds it sparse and leaves it to its own pass,
    which builds them again."""
    rng = np.random.default_rng(31)
    n = 20_000
    a = rng.integers(0, n, n).astype(np.int64)
    b = rng.integers(0, n, n).astype(np.int64)
    ref = RefTable([ref_column("a", "integral", a, np.ones(n, bool)),
                    ref_column("b", "integral", b, np.ones(n, bool))])
    table = port_table(ref)
    SCAN_STATS.reset()
    freqs, num_rows = port_segment.group_counts(table, ["a", "b"], "cpu")
    # 2 column-code device sorts + 1 matrix run-length sort
    assert SCAN_STATS.device_sort_passes == 3
    assert num_rows == n
    expected = collections.Counter(zip(a.tolist(), b.tolist()))
    assert len(freqs) == len(expected)
    for (ka, kb), cnt in list(expected.items())[:100]:
        assert freqs[(ka, kb)] == cnt
    ref_freqs, _ = ref_segment.group_counts(ref, ["a", "b"])
    assert dict(freqs) == dict(ref_freqs)
    _, census = _run_both(ref, lambda m: [m.Uniqueness(("a", "b")), m.Uniqueness(("b",))])
    # own passes: (a, b) 2 + 1, (b) 1; fused adds (a, b)'s 2 dropped sorts
    assert census["device_sort_passes"] == (6 if fusion else 4)
    assert census["fused_group_passes"] == 0  # (b) is dense but alone


def test_count_stats_fast_path_matches_full_path(fusion):
    """Without state persistence the grouping analyzers take the count
    statistics (fused: "stats" requests), with a state provider the
    frequency table ("freq" requests); both agree, and with the
    reference."""
    from deequ_tpu_torch.states import InMemoryStateProvider

    rng = np.random.default_rng(37)
    n = 30_000
    ref = RefTable([
        ref_column("k", "integral", rng.integers(0, n, n), np.ones(n, bool)),
        ref_column("j", "integral", rng.integers(0, 50, n), np.ones(n, bool)),
    ])
    table = port_table(ref)

    def build(m):
        return [m.Uniqueness(("k",)), m.UniqueValueRatio(("k",)), m.Distinctness(("k",)),
                m.CountDistinct(("k",)), m.Entropy("k"), m.Uniqueness(("j",))]

    analyzers = build(port_analyzers)
    fast = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    assert SCAN_STATS.fused_group_passes == (2 if fusion else 0)
    full = PortRunner.do_analysis_run(table, analyzers, device="cpu",
                                      save_states_with=InMemoryStateProvider())
    ref_fast = RefRunner.do_analysis_run(ref, build(ref_analyzers))
    for a, r in zip(analyzers, build(ref_analyzers)):
        vf = fast.metric_map[a].value.get()
        vz = full.metric_map[a].value.get()
        assert abs(vf - vz) < 1e-12, (a, vf, vz)
        assert_metric_parity(ref_fast.metric_map[r], fast.metric_map[a])


def test_frequency_merge_all_null_side_adopts_typed_keys():
    """Merging an all-null-keys state (string-dtype default) with a typed
    int state keeps int keys; mismatched key types refuse loudly."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows

    legacy = FrequenciesAndNumRows.from_dict(("g",), {(None,): 3}, 3)
    typed = FrequenciesAndNumRows.from_dict(("g",), {(5,): 2}, 2)
    assert legacy.sum(typed).as_dict() == {(None,): 3, (5,): 2}
    strs = FrequenciesAndNumRows.from_dict(("g",), {("a",): 1}, 1)
    with pytest.raises(ValueError, match="mismatched group-key types"):
        typed.sum(strs)


def test_sparse_grouping_fetch_is_bounded_by_group_count(monkeypatch):
    """The sparse group-by fetches O(k·G) bytes — group representatives and
    counts — never the O(k·n) sorted code matrix; the count statistics
    fetch four scalars."""
    monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 0)
    rng = np.random.default_rng(47)
    n = (1 << 16) + 8_192
    card = 2_100
    pool_a, pool_b = rng.integers(0, card, 512), rng.integers(0, card, 512)
    pick = rng.integers(0, 512, n)
    strs_a = np.array([f"a{v:05d}" for v in pool_a[pick]])
    strs_b = np.array([f"b{v:05d}" for v in pool_b[pick]])
    dict_a, dict_b = np.unique(strs_a), np.unique(strs_b)
    pad_a = [f"za{i}" for i in range(card - len(dict_a))]
    pad_b = [f"zb{i}" for i in range(card - len(dict_b))]
    ref = RefTable([
        ref_column("a", "string", codes=np.searchsorted(dict_a, strs_a).astype(np.int32),
                   dictionary=list(dict_a) + pad_a),
        ref_column("b", "string", codes=np.searchsorted(dict_b, strs_b).astype(np.int32),
                   dictionary=list(dict_b) + pad_b),
    ])
    table = port_table(ref)
    assert card * card > port_segment.DENSE_KEYSPACE_LIMIT
    SCAN_STATS.reset()
    freqs, num_rows = port_segment.group_counts(table, ["a", "b"], "cpu")
    expected = collections.Counter(zip(strs_a.tolist(), strs_b.tolist()))
    assert num_rows == n
    assert dict(freqs) == dict(expected)
    # (k = 2, G) representatives and G counts, int64, plus G's round trip
    assert SCAN_STATS.bytes_fetched <= 24 * len(expected) + 4096
    SCAN_STATS.reset()
    stats = port_segment.group_count_stats(table, ["a", "b"], "cpu")
    assert stats.num_groups == len(expected)
    assert SCAN_STATS.bytes_fetched <= 64


def test_sparse_and_dense_grouping_agree_randomized(monkeypatch, fusion):
    """Random shapes, dtypes and null patterns: the sparse (device run
    lengths) and dense (bincount) routes give identical frequency states
    and count statistics, and so do the fused requests of every set of a
    case together; each against the reference's dense states."""
    rng = np.random.default_rng(2024)
    for case in range(6):
        n = int(rng.integers(200, 3000))
        card = int(rng.integers(2, 40))
        cols, names = [], []
        for j in range(int(rng.integers(1, 3))):
            name = f"g{j}"
            kind = rng.integers(0, 3)
            if kind == 0:
                codes = rng.integers(0, card, n).astype(np.int32)
                codes[rng.random(n) < rng.random() * 0.2] = -1
                cols.append(ref_column(name, "string", codes=codes,
                                       dictionary=[f"v{i}" for i in range(card)]))
            elif kind == 1:
                cols.append(ref_column(name, "integral",
                                       rng.integers(-5, card, n).astype(np.int64),
                                       rng.random(n) > 0.1))
            else:
                cols.append(ref_column(name, "fractional", np.round(rng.normal(0, 2, n), 1),
                                       rng.random(n) > 0.1))
            names.append(name)
        ref = RefTable(cols)
        table = port_table(ref)
        monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 0)
        monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 1 << 22)
        dense_state = port_segment.group_counts_state(table, names, "cpu")
        dense_stats = port_segment.group_count_stats(table, names, "cpu")
        if fusion:
            sets = [tuple(names)] + [(c,) for c in names]
            requests = [port_segment.GroupRequest(s, m) for s in sets for m in ("freq", "stats")]
            fused = port_segment.fused_group_counts(table, requests, "cpu")
            assert sorted(fused) == list(range(len(requests))), case
            assert fused[0].as_dict() == dense_state.as_dict(), case
            assert fused[1] == dense_stats, case
        monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 0)  # force sparse
        before = SCAN_STATS.device_sort_passes
        sparse_state = port_segment.group_counts_state(table, names, "cpu")
        sparse_stats = port_segment.group_count_stats(table, names, "cpu")
        assert SCAN_STATS.device_sort_passes >= before + 2, case
        assert dense_state.as_dict() == sparse_state.as_dict(), case
        assert dense_state.num_rows == sparse_state.num_rows
        assert dense_stats.num_groups == sparse_stats.num_groups, case
        assert dense_stats.singletons == sparse_stats.singletons, case
        if dense_stats.num_groups:
            assert abs(dense_stats.entropy - sparse_stats.entropy) < 1e-9
        ref_state = ref_segment.group_counts_state(ref, names)
        assert dense_state.as_dict() == ref_state.as_dict(), case


def test_columnar_frequency_state_matches_dict_semantics(fusion):
    """The columnar frequency table agrees with dict semantics on a
    mixed-type grouping with nulls; its merge equals the whole; the
    state-provider route (fused: a "freq" request) gives the count
    statistics route's Uniqueness; MutualInformation equals a dict-loop
    computation."""
    import math

    from deequ_tpu_torch.states import InMemoryStateProvider

    rng = np.random.default_rng(9)
    n = 20_000
    codes = rng.integers(-1, 500, n).astype(np.int32)
    dictionary = [f"k{i}" for i in range(500)]
    ints = rng.integers(0, 50, n)
    int_mask = rng.random(n) > 0.05

    def table(sl=slice(None)):
        return port_table(RefTable([
            ref_column("s", "string", codes=codes[sl], dictionary=dictionary),
            ref_column("i", "integral", ints[sl], int_mask[sl]),
        ]))

    whole = table()
    state = port_segment.group_counts_state(whole, ["s", "i"], "cpu")
    expect = {}
    for c, v, m in zip(codes.tolist(), ints.tolist(), int_mask.tolist()):
        key = (None if c < 0 else f"k{c}", v if m else None)
        if key != (None, None):
            expect[key] = expect.get(key, 0) + 1
    assert state.as_dict() == expect
    half = n // 2
    merged = port_segment.group_counts_state(table(slice(None, half)), ["s", "i"], "cpu").sum(
        port_segment.group_counts_state(table(slice(half, None)), ["s", "i"], "cpu"))
    assert merged == state

    # two grouping sets, so fusion has something to fuse
    a, b = port_analyzers.Uniqueness(("s",)), port_analyzers.Distinctness(("i",))
    fast = PortRunner.do_analysis_run(whole, [a, b], device="cpu")
    stateful = PortRunner.do_analysis_run(whole, [a, b], device="cpu",
                                          save_states_with=InMemoryStateProvider())
    assert SCAN_STATS.fused_group_passes == (4 if fusion else 0)
    for x in (a, b):
        assert fast.metric_map[x].value.get() == stateful.metric_map[x].value.get()

    mi_an = port_analyzers.MutualInformation("s", "i")
    mi = PortRunner.do_analysis_run(whole, [mi_an], device="cpu").metric_map[mi_an].value.get()
    total = state.num_rows
    ma, mb = {}, {}
    for (va, vb), c in state.frequencies:
        ma[va] = ma.get(va, 0) + c
        mb[vb] = mb.get(vb, 0) + c
    want = 0.0
    for (va, vb), c in state.frequencies:
        if va is None or vb is None:
            continue
        pxy = c / total
        want += pxy * math.log(pxy / ((ma[va] / total) * (mb[vb] / total)))
    assert abs(mi - want) < 1e-12


def test_sum_over_inf_columns_keeps_ieee_semantics():
    """Sums over ±inf give the IEEE result (inf, NaN) — the reference's
    pair-path case; the port sums f64."""
    base = [1.0, 2.0, 3.0] * 64
    pos = port_table(RefTable([ref_column("x", "fractional", np.array(base + [np.inf]),
                                          np.ones(len(base) + 1, bool))]))
    s = PortRunner.do_analysis_run(pos, [port_analyzers.Sum("x")], device="cpu")
    assert s.metric_map[port_analyzers.Sum("x")].value.get() == np.inf
    mixed = port_table(RefTable([ref_column("x", "fractional",
                                            np.array(base + [np.inf, -np.inf]),
                                            np.ones(len(base) + 2, bool))]))
    m = PortRunner.do_analysis_run(mixed, [port_analyzers.Mean("x")], device="cpu")
    assert np.isnan(m.metric_map[port_analyzers.Mean("x")].value.get())


def test_frequency_state_edge_regressions():
    """NaN dict keys collapse like the columnar path; an int64-min merge
    with a float state refuses past 2^53; unsigned keys >= 2^63 refuse
    serde; Histogram's boundary ties break by key, whatever the state's
    group order."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.states.serde import serialize_state

    n1, n2 = float("nan"), float("nan")
    st = FrequenciesAndNumRows.from_dict(("x",), {(n1,): 2, (n2,): 3, (1.0,): 1}, 6)
    assert st.num_groups == 2
    assert sorted(st.counts.tolist()) == [1, 5]
    big = FrequenciesAndNumRows(("x",), (np.array([np.iinfo(np.int64).min]),),
                                (np.zeros(1, dtype=bool),), np.array([1]), 1)
    flt = FrequenciesAndNumRows(("x",), (np.array([0.5]),), (np.zeros(1, dtype=bool),),
                                np.array([1]), 1)
    with pytest.raises(ValueError, match="2\\^53"):
        big.sum(flt)
    ust = FrequenciesAndNumRows(("x",), (np.array([2 ** 63], dtype=np.uint64),),
                                (np.zeros(1, dtype=bool),), np.array([1]), 1)
    with pytest.raises(ValueError, match="unsigned"):
        serialize_state(ust)

    def hist_for(order):
        vals = np.array([f"k{i}" for i in order])
        counts = np.array([5] + [3] * (len(order) - 1))
        s = FrequenciesAndNumRows(("c",), (vals,), (np.zeros(len(order), dtype=bool),),
                                  counts, 14)
        m = port_analyzers.Histogram("c", max_detail_bins=3).compute_metric_from(s)
        return set(m.value.get().values.keys())

    assert hist_for([0, 1, 2, 3]) == hist_for([0, 3, 2, 1])


def test_histogram_fast_path_matches_state_path_at_boundary_tie():
    """At the max_detail_bins boundary the top-k route and the state route
    agree on the untied bin and on every count; the state route fills the
    ties by the lowest keys."""
    from deequ_tpu_torch.states import InMemoryStateProvider

    raw = ["k9"] * 5 + ["k1", "k2", "k3"] * 3
    dic = np.unique(np.array(raw))
    codes = np.searchsorted(dic, np.array(raw)).astype(np.int32)
    t = port_table(RefTable([ref_column("c", "string", codes=codes, dictionary=list(dic))]))
    h = port_analyzers.Histogram("c", max_detail_bins=3)
    fast = h.calculate(t, "cpu").value.get()
    stateful = h.calculate(t, "cpu", save_states_with=InMemoryStateProvider()).value.get()
    assert fast.number_of_bins == stateful.number_of_bins == 4
    assert fast.values["k9"] == stateful.values["k9"]
    assert len(fast.values) == len(stateful.values) == 3
    assert {v.absolute for v in fast.values.values()} == {5, 3}
    assert {v.absolute for v in stateful.values.values()} == {5, 3}
    assert set(stateful.values) == {"k9", "k1", "k2"}


def test_sparse_grouping_with_groups_near_rows(monkeypatch):
    """Nearly all-distinct keys on the sparse route (G close to n) stay
    correct."""
    n = (1 << 16) + 5_000
    rng = np.random.default_rng(77)
    a = rng.permutation(n).astype(np.int64)
    b = rng.integers(0, 3, n).astype(np.int64)
    table = port_table(RefTable([ref_column("a", "integral", a, np.ones(n, bool)),
                                 ref_column("b", "integral", b, np.ones(n, bool))]))
    monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 0)
    state = port_segment.group_counts_state(table, ["a", "b"], "cpu")
    expected = collections.Counter(zip(a.tolist(), b.tolist()))
    assert len(state.counts) == len(expected) == n
    got = state.as_dict()
    for key, cnt in list(expected.items())[:50]:
        assert got[key] == cnt


def _fold_table(n=32_768, seed=3):
    rng = np.random.default_rng(seed)
    mask = np.ones(n, dtype=bool)
    mask[rng.integers(0, n, n // 100)] = False
    return port_table(RefTable([
        ref_column("a", "fractional", rng.normal(5.0, 2.0, n), mask),
        ref_column("b", "integral", rng.integers(0, 1000, n), np.ones(n, bool)),
    ]))


def _fold_analyzers():
    m = port_analyzers
    return [m.Size(), m.Completeness("a"), m.Mean("a"), m.StandardDeviation("a"),
            m.Minimum("a"), m.Maximum("b"), m.Sum("b"), m.ApproxCountDistinct("b")]


def test_multi_chunk_resident_scan_is_one_fetch():
    """A resident scan of 8 chunks folds its partials on the device and
    fetches once."""
    from deequ_tpu_torch.ops.scan_engine import persist_table

    table = _fold_table()
    persist_table(table, "cpu", chunk_rows=4096, max_bytes=1 << 30)
    try:
        SCAN_STATS.reset()
        ctx = PortRunner.do_analysis_run(table, _fold_analyzers(), device="cpu")
        assert all(m.value.is_success for m in ctx.all_metrics())
        assert (SCAN_STATS.scan_passes, SCAN_STATS.resident_passes,
                SCAN_STATS.chunks_processed, SCAN_STATS.device_fetches) == (1, 1, 8, 1)
    finally:
        table.unpersist()


def test_fetch_deferred_isolates_one_scans_fold_failure():
    """One deferred scan's unpacking failing marks only that scan failed;
    its sibling of the same fetch succeeds; the failure re-raises."""
    from deequ_tpu_torch.ops.scan_engine import fetch_deferred, run_scan

    table = _fold_table(n=8192)
    good = run_scan(table, [a.scan_op(table) for a in _fold_analyzers()], "cpu",
                    chunk_rows=4096, defer=True)
    bad = run_scan(table, [a.scan_op(table) for a in _fold_analyzers()], "cpu",
                   chunk_rows=2048, defer=True)

    def exploding(*args, **kwargs):
        raise RuntimeError("injected fold failure")

    bad._fold.unflatten = exploding
    fetch_deferred([good, bad])
    assert float(good.result()[0]["n"]) == 8192
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected fold failure"):
            bad.result()


def test_fetch_deferred_keyboard_interrupt_marks_scan_failed():
    """An interrupt while a deferred scan unpacks leaves fetch_deferred and
    leaves the scan failed: result() raises it again, never half a fold."""
    from deequ_tpu_torch.ops.scan_engine import fetch_deferred, run_scan

    table = _fold_table(n=8192)
    scan = run_scan(table, [a.scan_op(table) for a in _fold_analyzers()], "cpu",
                    chunk_rows=4096, defer=True)

    def interrupted(*args, **kwargs):
        raise KeyboardInterrupt()

    scan._fold.unflatten = interrupted
    with pytest.raises(KeyboardInterrupt):
        fetch_deferred([scan])
    assert scan.done
    with pytest.raises(KeyboardInterrupt):
        scan.result()
