"""Cross-set grouping fusion and the plan cost model of the port
(deequ_tpu_torch/ops/segment.py:fused_group_counts,
ops/histogram_device.py:fused_bincount, analyzers/runner.py:
_fuse_grouping_sets, ops/plan_cost.py) against the reference's, on the CPU:
twins of tests/test_plan_optimizer.py where the port has the subject.

Fused grouping counts are integers, so every fused state is held bit for
bit: against the port's own per-set pass, against
``DEEQU_TORCH_PLAN_FUSION=0``, and against the reference's fused states
over the same numpy-seeded table (group values, null flags, counts, row
counts; the entropy's bits). On the CPU ``fused_bincount`` runs its plain
version, which is held here against the reference's formulation (offset,
concatenate, ``np.bincount``); the CUDA multi-input entry is held against
that plain version by the ``cuda``-marked test and by chip_smoke.py on the
card."""

import struct

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.segment as ref_segment
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.segment as port_segment
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.exceptions import DeviceOOMException, EnvConfigError
from deequ_tpu_torch.ops import device_policy, histogram_device
from deequ_tpu_torch.ops.histogram_device import fused_bincount, fused_bincount_plain
from deequ_tpu_torch.ops.plan_cost import PLAN_COST_MODEL, PlanCostModel, PlanFeatures
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.ops.segment import GroupRequest, fused_group_counts
from torch_parity import port_table, ref_column

pytestmark = pytest.mark.torch_port


def _bits(x) -> bytes:
    return struct.pack("<d", float(x))


def _grouping_table(n=512, seed=0) -> RefTable:
    """The reference test's table: two small-int columns and a rounded
    float one, with nulls."""
    r = np.random.default_rng(seed)
    return RefTable([
        ref_column("a", "integral", r.integers(0, 40, n).astype(np.float64),
                   r.random(n) > 0.05),
        ref_column("b", "integral", r.integers(0, 9, n).astype(np.float64),
                   np.ones(n, bool)),
        ref_column("c", "fractional", np.round(r.normal(0, 2, n), 1),
                   r.random(n) > 0.02),
    ])


def _assert_freq_state_identical(got, want, label):
    assert tuple(got.columns) == tuple(want.columns), label
    assert len(got.key_values) == len(want.key_values), label
    for g, w in zip(got.key_values, want.key_values):
        assert np.array_equal(np.asarray(g, dtype=np.float64),
                              np.asarray(w, dtype=np.float64)), label
    for g, w in zip(got.key_nulls, want.key_nulls):
        assert np.array_equal(g, w), label
    assert np.array_equal(got.counts, want.counts), label
    assert got.num_rows == want.num_rows, label


def _assert_stats_identical(got, want, label):
    for f in ("num_rows", "num_groups", "singletons"):
        assert getattr(got, f) == getattr(want, f), (label, f)
    assert _bits(got.entropy) == _bits(want.entropy), label


@pytest.fixture
def device_counts(monkeypatch):
    """Both packages past their host thresholds (the reference's env switch,
    the port's), one torch thread, counters at 0."""
    monkeypatch.setenv("DEEQU_TPU_HOST_GROUP_LIMIT", "1")
    monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    with use_mesh(None):
        yield
    torch.set_num_threads(threads)


REQUESTS = [("a",), ("b",), ("a", "b")]


# -- cross-set fusion: one dispatch, bit for bit -------------------------------


def test_fused_group_counts_one_dispatch_bit_identical(device_counts):
    """K = 3 dense sets fuse into ONE count (the plain version of the
    multi-input entry on the CPU) and one fetch; every slice is bit for bit
    the set's own pass and the reference's fused state."""
    ref = _grouping_table()
    table = port_table(ref)
    requests = [GroupRequest(cols) for cols in REQUESTS]
    want = {i: port_segment.group_counts_state(table, list(c), "cpu")
            for i, c in enumerate(REQUESTS)}
    assert SCAN_STATS.hist_plain_dispatches == len(REQUESTS)

    SCAN_STATS.reset()
    got = fused_group_counts(table, requests, "cpu")
    assert sorted(got) == [0, 1, 2]
    assert SCAN_STATS.hist_plain_dispatches == 1, "fusion must make ONE dispatch"
    assert SCAN_STATS.fused_group_passes == len(REQUESTS)
    assert SCAN_STATS.grouping_passes == len(REQUESTS)
    assert SCAN_STATS.rows_scanned == len(REQUESTS) * table.num_rows
    ref_got = ref_segment.fused_group_counts(
        ref, [ref_segment.GroupRequest(c) for c in REQUESTS])
    for i in got:
        _assert_freq_state_identical(got[i], want[i], f"set {i} vs its own pass")
        _assert_freq_state_identical(got[i], ref_got[i], f"set {i} vs the reference")


def test_fused_stats_mode_bit_identical(device_counts):
    """Stats-mode requests ride the same fused count and match
    group_count_stats field for field, the entropy bit for bit — and the
    reference's fused statistics."""
    ref = _grouping_table(seed=3)
    table = port_table(ref)
    cols = [("a",), ("b",)]
    want = {i: port_segment.group_count_stats(table, list(c), "cpu")
            for i, c in enumerate(cols)}
    SCAN_STATS.reset()
    got = fused_group_counts(table, [GroupRequest(c, "stats") for c in cols], "cpu")
    assert SCAN_STATS.hist_plain_dispatches == 1
    ref_got = ref_segment.fused_group_counts(
        ref, [ref_segment.GroupRequest(c, mode="stats") for c in cols])
    for i in got:
        _assert_stats_identical(got[i], want[i], i)
        _assert_stats_identical(got[i], ref_got[i], i)


def _unique_columns_table() -> RefTable:
    """The reference's df_with_unique_columns fixture, column for column."""
    data = {
        "unique": ["1", "2", "3", "4", "5", "6"],
        "nonUnique": ["0", "0", "0", "5", "6", "7"],
        "nonUniqueWithNulls": ["1", None, "1", None, None, "2"],
        "uniqueWithNulls": ["1", "2", None, "4", "5", "6"],
        "onlyUniqueWithOtherNonUnique": ["1", "2", "3", "4", "5", "6"],
        "halfUniqueCombinedWithNonUnique": ["0", "1", "1", "2", "3", "4"],
    }
    return RefTable.from_pydict(data)


def _grouping_family(module):
    return [
        module.Uniqueness(("nonUnique",)),
        module.UniqueValueRatio(("halfUniqueCombinedWithNonUnique",)),
        module.Distinctness(("unique",)),
        module.Entropy("nonUnique"),
        module.CountDistinct(("onlyUniqueWithOtherNonUnique",)),
    ]


def test_runner_fusion_bit_identical_to_unfused(monkeypatch):
    """The same grouping family fused and under DEEQU_TORCH_PLAN_FUSION=0:
    bit-identical metrics, and the reference's bits; only the fused run
    records fused passes (Uniqueness and Entropy share one set: four fused
    passes serve the five analyzers)."""
    ref = _unique_columns_table()
    table = port_table(ref)
    analyzers = _grouping_family(port_analyzers)
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "0")
    SCAN_STATS.reset()
    base = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    assert SCAN_STATS.fused_group_passes == 0
    assert SCAN_STATS.hist_host_dispatches == 4

    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "1")
    SCAN_STATS.reset()
    fused = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    assert SCAN_STATS.fused_group_passes == 4
    assert SCAN_STATS.hist_host_dispatches == 1
    assert SCAN_STATS.grouping_passes == 4
    with use_mesh(None):
        ref_ctx = RefRunner.do_analysis_run(ref, _grouping_family(ref_analyzers))
    for a, r in zip(analyzers, _grouping_family(ref_analyzers)):
        m0, m1, mr = base.metric_map[a], fused.metric_map[a], ref_ctx.metric_map[r]
        assert m0.value.is_success and m1.value.is_success, str(a)
        assert _bits(m0.value.get()) == _bits(m1.value.get()), str(a)
        assert _bits(m1.value.get()) == _bits(mr.value.get()), str(a)


@pytest.mark.parametrize("encoded", [False, True], ids=["decoded", "encoded"])
def test_mixed_family_suite_bit_identical_under_fusion(monkeypatch, encoded):
    """Fusion does not perturb the other families of the same run: monoid,
    HLL, KLL and grouping analyzers over decoded and encoded ingest are
    bit-identical fused and under DEEQU_TORCH_PLAN_FUSION=0; the grouping
    metrics are the reference's bits, the others within the parity
    bounds."""
    from torch_parity import assert_metric_parity

    r = np.random.default_rng(13)
    n = 512
    ref = RefTable([
        ref_column("v", "fractional", r.normal(10, 3, n), r.random(n) > 0.05),
        ref_column("g", "integral", r.integers(0, 30, n).astype(np.float64),
                   np.ones(n, bool)),
        ref_column("h", "integral", r.integers(0, 7, n).astype(np.float64),
                   np.ones(n, bool)),
    ])
    table = port_table(ref)
    if encoded:
        assert table.encode(["g"])["g"].encoding is not None
        assert ref.encode(["g"])["g"].encoding is not None

    def suite(m):
        return [m.Mean("v"), m.ApproxCountDistinct("g"), m.ApproxQuantile("v", 0.5),
                m.Uniqueness(("g",)), m.Distinctness(("h",))]

    analyzers = suite(port_analyzers)
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "0")
    base = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    SCAN_STATS.reset()
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "1")
    fused = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    assert SCAN_STATS.fused_group_passes == 2
    with use_mesh(None):
        ref_ctx = RefRunner.do_analysis_run(ref, suite(ref_analyzers))
    for a, ra in zip(analyzers, suite(ref_analyzers)):
        m0, m1 = base.metric_map[a], fused.metric_map[a]
        assert m0.value.is_success and m1.value.is_success, str(a)
        assert _bits(m0.value.get()) == _bits(m1.value.get()), str(a)
        mr = ref_ctx.metric_map[ra]
        if type(a).__name__ in ("Uniqueness", "Distinctness"):
            assert _bits(m1.value.get()) == _bits(mr.value.get()), str(a)
        elif type(a).__name__ != "ApproxQuantile":
            assert_metric_parity(mr, m1)


# -- the fusion fault rung -------------------------------------------------------


def test_oom_mid_fused_group_demotes_bit_identical(device_counts, monkeypatch):
    """A device OOM in the FUSED dispatch demotes the group: one
    ``fusion_demote`` event, each member counted in its own dispatch from
    the keys it prepared (nothing prepared again), bit for bit its own pass
    and the reference's state, and no fused pass counted."""
    ref = _grouping_table(seed=7)
    table = port_table(ref)
    cols = [("a",), ("b",)]
    want = {i: port_segment.group_counts_state(table, list(c), "cpu")
            for i, c in enumerate(cols)}

    def oom(keys, keyspaces, device):
        raise DeviceOOMException("injected mid-fused-group")

    prepared = []
    real_prep = port_segment._prepare_grouping
    monkeypatch.setattr(port_segment, "_fused_device_bincount", oom)
    monkeypatch.setattr(port_segment, "_prepare_grouping",
                        lambda t, c, *a, **k: prepared.append(tuple(c)) or real_prep(t, c, *a, **k))
    SCAN_STATS.reset()
    got = fused_group_counts(table, [GroupRequest(c) for c in cols], "cpu")
    demotes = [d for d in SCAN_STATS.degradation_events if d["kind"] == "fusion_demote"]
    assert len(demotes) == 1
    assert demotes[0]["passes"] == 2
    assert demotes[0]["keyspace"] == sum(
        real_prep(table, list(c), "cpu").keyspace for c in cols)
    assert "injected mid-fused-group" in demotes[0]["reason"]
    assert prepared == [("a",), ("b",)], "the demotion must not prepare again"
    assert SCAN_STATS.fused_group_passes == 0
    assert SCAN_STATS.hist_plain_dispatches == 2
    assert sorted(got) == [0, 1], "demotion must still compute every set"
    ref_want = {i: ref_segment.group_counts_state(ref, list(c)) for i, c in enumerate(cols)}
    for i in got:
        _assert_freq_state_identical(got[i], want[i], f"demoted set {i}")
        _assert_freq_state_identical(got[i], ref_want[i], f"demoted set {i} vs reference")


def test_demotion_reaches_the_runner_report(device_counts, monkeypatch):
    """Through the runner the demotion is a run event: the metrics are the
    unfused run's bits and ``scan_execution_report`` lists the rung."""
    import deequ_tpu_torch

    table = port_table(_grouping_table(seed=7))
    analyzers = [port_analyzers.Uniqueness(["a"]), port_analyzers.Distinctness(["b"])]
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "0")
    base = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "1")

    def oom(keys, keyspaces, device):
        raise DeviceOOMException("injected")

    monkeypatch.setattr(port_segment, "_fused_device_bincount", oom)
    SCAN_STATS.reset()
    ctx = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    report = deequ_tpu_torch.scan_execution_report()
    assert [e["kind"] for e in report["degradation_events"]] == ["fusion_demote"]
    assert report["fused_group_passes"] == 0
    for a in analyzers:
        assert _bits(ctx.metric_map[a].value.get()) == _bits(base.metric_map[a].value.get())


# -- the runner's pre-pass: when it stands aside -----------------------------------


def _two_sets():
    return [port_analyzers.Uniqueness(["a"]), port_analyzers.Distinctness(["b"])]


@pytest.mark.parametrize("case", ["switch_off", "one_set", "stream", "budget", "escape"])
def test_fuse_grouping_sets_stands_aside(device_counts, monkeypatch, case):
    """``_fuse_grouping_sets`` computes nothing with the switch off, with
    fewer than two sets, over a stream, under a group memory budget, or
    when anything escapes fused_group_counts; the per-set passes then give
    the same metrics."""
    from deequ_tpu_torch.data.streaming import stream_table

    table = port_table(_grouping_table())
    analyzers = _two_sets()
    want = PortRunner.do_analysis_run(table, analyzers, device="cpu")
    data, kwargs = table, {}
    if case == "switch_off":
        monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "0")
    elif case == "one_set":
        analyzers = analyzers[:1]
    elif case == "stream":
        data = stream_table(table, 100)
    elif case == "budget":
        kwargs["group_memory_budget"] = 1 << 30
    else:
        def boom(*a, **k):
            raise RuntimeError("escaped")

        monkeypatch.setattr(port_segment, "fused_group_counts", boom)
    SCAN_STATS.reset()
    ctx = PortRunner.do_analysis_run(data, analyzers, device="cpu", **kwargs)
    assert SCAN_STATS.fused_group_passes == 0
    for a in analyzers:
        assert _bits(ctx.metric_map[a].value.get()) == _bits(want.metric_map[a].value.get())


def test_plan_fusion_switch_validated(monkeypatch):
    """``plan_fusion_enabled``: an explicit argument wins, then the
    environment ('0' off), then on; malformed values raise typed."""
    from deequ_tpu_torch.envcfg import registry_snapshot
    from deequ_tpu_torch.ops.scan_plan import plan_fusion_enabled

    monkeypatch.delenv("DEEQU_TORCH_PLAN_FUSION", raising=False)
    assert plan_fusion_enabled() is True
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "0")
    assert plan_fusion_enabled() is False
    assert plan_fusion_enabled(True) is True
    with pytest.raises(ValueError):
        plan_fusion_enabled("yes")
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "on")
    with pytest.raises(EnvConfigError):
        plan_fusion_enabled()
    assert "DEEQU_TORCH_PLAN_FUSION" in registry_snapshot()


def test_host_group_limit_knob_sweeps_threshold(monkeypatch):
    """Twin of tests/test_kernel_variants.py's knob sweep on
    DEEQU_TORCH_HOST_GROUP_LIMIT: above the rows the count runs on the
    host, at 0 it takes the histogram (its plain version on the CPU); unset
    the module default; malformed raises typed. Both packages count the
    same."""
    keys = np.array([0, 1, 1, 2, -1, 2, 2], dtype=np.int64)
    ref = np.array([1, 2, 3], dtype=np.int64)
    monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "1000000")
    assert port_segment.host_group_limit() == 1_000_000
    SCAN_STATS.reset()
    np.testing.assert_array_equal(port_segment._device_bincount(keys, 3, "cpu"), ref)
    assert (SCAN_STATS.hist_host_dispatches, SCAN_STATS.hist_plain_dispatches) == (1, 0)

    monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "0")
    assert port_segment.host_group_limit() == 0
    SCAN_STATS.reset()
    np.testing.assert_array_equal(port_segment._device_bincount(keys, 3, "cpu"), ref)
    assert (SCAN_STATS.hist_host_dispatches, SCAN_STATS.hist_plain_dispatches) == (0, 1)
    with use_mesh(None):
        np.testing.assert_array_equal(ref_segment._device_bincount(keys, 3, None), ref)

    monkeypatch.delenv("DEEQU_TORCH_HOST_GROUP_LIMIT")
    assert port_segment.host_group_limit() == port_segment.HOST_GROUP_LIMIT
    monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 7)
    assert port_segment.host_group_limit() == 7

    for bad in ("not-a-number", "-1"):
        monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", bad)
        with pytest.raises(EnvConfigError):
            port_segment.host_group_limit()


def test_host_group_limit_steers_every_grouping_decision(monkeypatch):
    """The switch steers each host-or-device choice of ops/segment.py: the
    numeric unique, the dense count, the sparse run lengths, the top-k and
    the fused count (whose rows are the sets' rows summed, as in the
    reference) — at 5,000 rows a set they all run on the host under the
    default and all reach the device paths at 0."""
    r = np.random.default_rng(5)
    n = 5_000
    ref = RefTable([
        ref_column("x", "integral", r.integers(0, 50, n), np.ones(n, bool)),
        ref_column("y", "integral", r.integers(0, 2000, n), np.ones(n, bool)),
    ])
    table = port_table(ref)

    def run():
        SCAN_STATS.reset()
        out = (
            port_segment.group_count_stats(table, ["x", "y"], "cpu"),
            port_segment.group_counts_state(table, ["x", "y"], "cpu").as_dict(),
            port_segment.group_top_k(table, "x", 5, "cpu"),
            fused_group_counts(table, [GroupRequest(("x",)), GroupRequest(("y",))], "cpu"),
        )
        return out, SCAN_STATS.snapshot()

    # (x, y) sparse, (x) and (y) dense and fused together
    monkeypatch.setattr(port_segment, "DENSE_KEYSPACE_LIMIT", 1 << 12)
    monkeypatch.delenv("DEEQU_TORCH_HOST_GROUP_LIMIT", raising=False)
    host, host_census = run()
    assert host_census["device_sort_passes"] == 0
    assert host_census["hist_plain_dispatches"] == 0
    monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "0")
    dev, dev_census = run()
    assert dev_census["device_sort_passes"] > 0
    assert dev_census["hist_host_dispatches"] == 0
    assert dev_census["fused_group_passes"] == 2
    for f in ("num_rows", "num_groups", "singletons"):
        assert getattr(host[0], f) == getattr(dev[0], f)
    # the host and device run lengths take the entropy by two formulas
    assert abs(host[0].entropy - dev[0].entropy) <= 1e-12 * abs(dev[0].entropy)
    assert host[1:3] == dev[1:3]
    for i in (0, 1):
        _assert_freq_state_identical(host[3][i], dev[3][i], i)


# -- K7's plain version against the reference's formulation ---------------------


def _reference_fused_counts(keys, keyspaces):
    """The reference's host formulation (segment.py:1108-1132): offset,
    concatenate, count over the summed keyspace, out of range dropped."""
    total = int(sum(keyspaces))
    offsets = np.cumsum((0,) + tuple(keyspaces[:-1]))
    combined = np.concatenate([
        np.where(k >= 0, k + np.int64(off), np.int64(-1)) for k, off in zip(keys, offsets)
    ])
    inside = combined[(combined >= 0) & (combined < total)]
    return np.bincount(inside, minlength=total).astype(np.int64)


def _fused_cases():
    r = np.random.default_rng(11)
    big = np.iinfo(np.int64).max
    cases = {}
    for k in range(1, 6):
        spaces = tuple(int(x) for x in r.integers(1, 300, k))
        cases[f"k{k}"] = (
            [r.integers(-1, s, int(r.integers(0, 2000))) for s in spaces], spaces)
    cases["one_bin_sets"] = ([np.zeros(50, np.int64), np.full(7, -1), np.zeros(3, np.int64)],
                             (1, 1, 1))
    near = (1 << 22) - 3
    cases["near_2^22"] = ([r.integers(-1, near - 5, 5000), r.integers(-1, 5, 300)],
                          (near - 5, 5))
    cases["all_dropped"] = ([np.full(100, -1), r.integers(0, 9, 100), np.full(4, -7)],
                            (40, 9, 12))
    # ids at the offset boundaries: the last bin of a set, one past it
    # (which lands on the next set's first bin, as in the reference),
    # past the total, and int64 extremes (the add wraps as numpy's does)
    cases["boundaries"] = ([np.array([0, 9, 10, 11, -1, big, -big - 1]),
                            np.array([0, 4, 5, 100, big - 9, big - 10])],
                           (10, 5))
    cases["empty_inputs"] = ([np.zeros(0, np.int64), r.integers(0, 3, 10)], (4, 3))
    # the kernel's partition route (a summed keyspace past a block's shared
    # histogram): narrow ids past their own keyspace landing in a wide
    # input's bins, every wide id in one bucket, a wide input alone, narrow
    # inputs alone, the summed keyspace on both sides of 132 << 13 (where
    # the H100's bucket width steps), 70 wide and narrow inputs
    cases["narrow_past_keyspace_into_wide"] = (
        [r.integers(-1, 90_000, 4000), r.integers(-1, 70_002, 3000)], (9, 70_000))
    cases["one_bucket_wide"] = (
        [12_152 * 64 + r.integers(0, 64, 6000), r.integers(-1, 10, 500)], (1_000_000, 9))
    cases["wide_only"] = ([r.integers(-1, 200_002, 5000)], (200_000,))
    cases["narrow_only_past_shared"] = (
        [r.integers(-1, 15_002, 2000) for _ in range(5)], (15_000,) * 5)
    for label, total in (("below_132<<13", (132 << 13) - 1), ("above_132<<13", (132 << 13) + 1)):
        cases[label] = ([r.integers(-1, total - 5_010, 20_000), r.integers(-1, 10, 3000),
                         r.integers(-1, 5_002, 3000)], (total - 5_010, 9, 5_001))
    mixed = tuple(int(r.integers(16_385, 40_000)) if j % 2 else int(r.integers(1, 3_000))
                  for j in range(70))
    cases["70_mixed"] = ([r.integers(-1, s + 2, int(r.integers(0, 500))) for s in mixed], mixed)
    return cases


FUSED_CASES = _fused_cases()


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_bincount_plain_matches_reference_formulation(case):
    keys, spaces = FUSED_CASES[case]
    keys = [np.asarray(k, dtype=np.int64) for k in keys]
    want = _reference_fused_counts(keys, spaces)
    tensors = [torch.from_numpy(k) for k in keys]
    before = histogram_device.FUSED_LAUNCHES
    got = fused_bincount(tensors, spaces)
    assert histogram_device.FUSED_LAUNCHES == before, "the CPU runs no kernel"
    assert got.dtype == torch.int64 and got.shape == (sum(spaces),)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(fused_bincount_plain(tensors, spaces), got)


def test_fused_bincount_refuses_bad_arguments():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        fused_bincount([], [])
    with pytest.raises(ValueError):
        fused_bincount([k], [3, 4])
    with pytest.raises(TypeError):
        fused_bincount([k.to(torch.int32)], [3])
    with pytest.raises(ValueError):
        fused_bincount([k], [-1])
    with pytest.raises(ValueError):
        fused_bincount([k.to("meta")], [3])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the multi-input entry is CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_cuda_fused_kernel_matches_plain(cuda_device, case):
    keys, spaces = FUSED_CASES[case]
    tensors = [torch.from_numpy(np.asarray(k, dtype=np.int64)).to(cuda_device) for k in keys]
    before = histogram_device.FUSED_LAUNCHES
    got = fused_bincount(tensors, spaces)
    launched = any(t.numel() for t in tensors) and sum(spaces) > 0
    assert histogram_device.FUSED_LAUNCHES == before + int(launched)
    assert torch.equal(got, fused_bincount_plain(tensors, spaces))


# -- the plan cost model ------------------------------------------------------------


def test_cost_model_monotone_in_every_feature(monkeypatch):
    """A wider or deeper plan never predicts cheaper."""
    monkeypatch.setattr(device_policy, "HIST_ONEHOT_CPU_MAX_SEGMENTS", 64)
    model = PlanCostModel(platform="cpu")
    base = dict(rows=4096, scan_ops=2, sort_ops=1, select_ops=1,
                hist_widths=(32,), group_keyspaces=(100,), tenants=2,
                encoded_columns=1)
    ramps = {
        "rows": [0, 1, 100, 4096, 1 << 20],
        "scan_ops": [0, 1, 5, 50],
        "sort_ops": [0, 1, 4],
        "select_ops": [0, 2, 8],
        "hist_widths": [(), (16,), (64,), (65,), (1 << 12,),
                        (1 << 12, 64), (1 << 12, 1 << 12)],
        "group_keyspaces": [(), (10,), (1 << 14,), (1 << 14, 10)],
        "tenants": [1, 2, 8],
        "encoded_columns": [0, 1, 3],
    }
    for field, values in ramps.items():
        prev = None
        for v in values:
            cost = model.predict(PlanFeatures(**{**base, field: v})).total
            if prev is not None:
                assert cost >= prev, (field, v)
            prev = cost


def test_cost_cap_knobs_price_the_crossover(monkeypatch):
    """The width caps are cost-model inputs: a width past the platform's cap
    prices strictly higher than the same width under a raised cap (the
    constants monkeypatched: the port has no cap switches until K6)."""
    f = PlanFeatures(rows=1 << 16, hist_widths=(512,))
    monkeypatch.setattr(device_policy, "HIST_ONEHOT_CPU_MAX_SEGMENTS", 128)
    capped = PlanCostModel(platform="cpu").predict(f).total
    monkeypatch.setattr(device_policy, "HIST_ONEHOT_CPU_MAX_SEGMENTS", 1024)
    uncapped = PlanCostModel(platform="cpu").predict(f).total
    assert capped > uncapped

    monkeypatch.setattr(device_policy, "HIST_ONEHOT_MXU_MAX_SEGMENTS", 128)
    acapped = PlanCostModel(platform="cuda").predict(f).total
    monkeypatch.setattr(device_policy, "HIST_ONEHOT_MXU_MAX_SEGMENTS", 1024)
    auncapped = PlanCostModel(platform="cuda").predict(f).total
    assert acapped > auncapped


def test_cost_model_prices_as_the_reference(monkeypatch):
    """The port's model gives the reference's numbers for the same
    features and platform class, with the accelerator's one-hot cap set
    equal through both packages' switches (the card's default cap comes
    from its own sweep), and resolves its platform from the port's
    default device (the CPU here: no card, or a use_device scope)."""
    from deequ_tpu.ops.device_policy import HIST_ONEHOT_MXU_MAX_SEGMENTS as REF_CAP
    from deequ_tpu.ops.plan_cost import PlanCostModel as RefModel
    from deequ_tpu.ops.plan_cost import PlanFeatures as RefFeatures
    from deequ_tpu_torch import use_device

    monkeypatch.setenv("DEEQU_TPU_HIST_ACCEL_CAP", str(REF_CAP))
    monkeypatch.setenv("DEEQU_TORCH_HIST_ACCEL_CAP", str(REF_CAP))

    fields = dict(rows=1 << 15, scan_ops=3, sort_ops=1, select_ops=2,
                  hist_widths=(16, 1 << 18), group_keyspaces=(100, 1 << 20),
                  tenants=3, encoded_columns=2)
    for port_platform, ref_platform in (("cpu", "cpu"), ("cuda", "tpu")):
        got = PlanCostModel(platform=port_platform).predict(PlanFeatures(**fields))
        want = RefModel(platform=ref_platform).predict(RefFeatures(**fields))
        assert got == _port_cost(want), port_platform
    with use_device("cpu"):
        assert PlanCostModel()._resolve_platform() == "cpu"


def _port_cost(ref_cost):
    from deequ_tpu_torch.ops.plan_cost import PlanCost

    return PlanCost(ref_cost.transfer, ref_cost.compute, ref_cost.fetch, ref_cost.dispatches)


def test_estimate_suite_orders_heavier_suites_higher():
    """A suite with a grouping analyzer on top of the scalar set prices
    strictly higher, and more rows price higher for the same suite — with
    the reference's totals."""
    from deequ_tpu.ops.plan_cost import PLAN_COST_MODEL as REF_MODEL
    from deequ_tpu_torch import use_device

    def suites(m):
        return [m.Completeness("x")], [m.Completeness("x"), m.Mean("x"), m.Uniqueness(("y",))]

    light, heavy = suites(port_analyzers)
    n = 4096
    with use_device("cpu"):
        cl = PLAN_COST_MODEL.estimate_suite(light, n).total
        ch = PLAN_COST_MODEL.estimate_suite(heavy, n).total
        assert ch > cl
        assert PLAN_COST_MODEL.estimate_suite(heavy, 4 * n).total > ch
    ref_light, ref_heavy = suites(ref_analyzers)
    assert cl == REF_MODEL.estimate_suite(ref_light, n).total
    assert ch == REF_MODEL.estimate_suite(ref_heavy, n).total


# -- the serving layer's consumers of the plan optimizer (serve/) --------------


@pytest.fixture
def cpu_serving():
    """The port's serving worker on the CPU, one torch thread."""
    from deequ_tpu_torch import use_device
    from deequ_tpu_torch.parallel.mesh import use_mesh as port_use_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), port_use_mesh(None):
        yield
    torch.set_num_threads(threads)


def _serve_sides():
    """Each package's (name, analyzers, table type, service, SCAN_STATS,
    SUBPLAN_CACHE, mesh scope): the reference on one device."""
    import contextlib

    import deequ_tpu.ops.scan_engine as ref_engine
    import deequ_tpu.serve as ref_serve
    import deequ_tpu.serve.plan_cache as ref_plan_cache
    import deequ_tpu_torch.serve as port_serve
    import deequ_tpu_torch.serve.plan_cache as port_plan_cache

    return [
        ("ref", ref_analyzers, ref_serve.VerificationService, ref_engine.SCAN_STATS,
         ref_plan_cache.SUBPLAN_CACHE, lambda: use_mesh(None)),
        ("port", port_analyzers, port_serve.VerificationService, SCAN_STATS,
         port_plan_cache.SUBPLAN_CACHE, contextlib.nullcontext),
    ]


def _serve_table(side, ref):
    return ref if side == "ref" else port_table(ref)


def test_subplan_sharing_across_permuted_suites(cpu_serving):
    """Two tenants submit one analyzer set in two orders: distinct exact
    plan keys, one shared program below them — the second suite builds
    nothing and its sub-plan hit is counted; every metric bit for bit, and
    the reference's service counts the same and computes the same metrics
    within tests/torch_parity.py's bounds."""
    from torch_parity import assert_metric_parity

    r = np.random.default_rng(11)
    n = 256
    ref_table = RefTable([
        ref_column("x", "fractional", r.normal(0, 1, n), np.ones(n, bool)),
        ref_column("y", "fractional", r.normal(5, 2, n), np.ones(n, bool)),
    ])
    counts, metrics = {}, {}
    for side, pkg, Service, stats, subplans, scope in _serve_sides():
        with scope():
            subplans.clear()
            table = _serve_table(side, ref_table)
            suite = [pkg.Completeness("x"), pkg.Mean("x"), pkg.Minimum("y")]
            svc = Service(max_batch=4, coalesce_window=0.0)
            try:
                hits0, built0 = stats.subplan_cache_hits, stats.programs_built
                res_a = svc.submit(table, required_analyzers=tuple(suite),
                                   tenant="a").result(timeout=60)
                built, reused = stats.programs_built, stats.programs_reused
                hits = stats.subplan_cache_hits
                res_b = svc.submit(table, required_analyzers=tuple(reversed(suite)),
                                   tenant="b").result(timeout=60)
                counts[side] = (built > built0, hits - hits0,
                                stats.programs_built - built,
                                stats.subplan_cache_hits - hits >= 1,
                                stats.programs_reused - reused >= 1)
            finally:
                svc.stop(drain=False)
            for a in suite:
                va, vb = res_a.metrics[a].value, res_b.metrics[a].value
                assert va.is_success and vb.is_success, str(a)
                assert _bits(va.get()) == _bits(vb.get()), str(a)
            metrics[side] = [res_a.metrics[a] for a in suite]
    # a permuted suite adopts the shared program: it builds nothing
    assert counts["port"] == (True, 0, 0, True, True)
    assert counts["port"] == counts["ref"]
    for ref_metric, port_metric in zip(metrics["ref"], metrics["port"]):
        assert_metric_parity(ref_metric, port_metric)


def test_planner_obs_section_counts(device_counts):
    """The registry's ``planner`` section reads the optimizer's census:
    fused passes and sub-plan hits surface through execution_report, as
    the reference's do for the same grouping requests."""
    import deequ_tpu
    import deequ_tpu_torch
    from deequ_tpu.ops.scan_engine import SCAN_STATS as REF_STATS
    from deequ_tpu.ops.segment import GroupRequest as RefGroupRequest
    from deequ_tpu.ops.segment import fused_group_counts as ref_fused_group_counts

    ref_table = _grouping_table(seed=5)
    REF_STATS.reset()
    ref_fused_group_counts(ref_table, [RefGroupRequest(("a",)), RefGroupRequest(("b",))])
    ref = deequ_tpu.execution_report()["planner"]
    fused_group_counts(port_table(ref_table), [GroupRequest(("a",)), GroupRequest(("b",))],
                       "cpu")
    rep = deequ_tpu_torch.execution_report()["planner"]
    assert rep["fused_group_passes"] == 2
    assert rep["plan_fusion"] is True
    assert "subplan_cache_hits" in rep
    assert set(rep) == set(ref)
    for key in ("fused_group_passes", "plan_fusion", "subplan_cache_hits"):
        assert rep[key] == ref[key], key


def test_retry_after_orders_by_queued_cost():
    """One queue depth schedules a later retry when the queued work is
    predicted heavier: depth alone no longer decides retry_after_s. The
    reference's controller, fed the same batches, gives the same
    schedules."""
    import deequ_tpu.serve.admission as ref_admission
    import deequ_tpu_torch.serve.admission as port_admission

    def schedules(m):
        ctl = m.AdmissionController(max_pending=64)
        for _ in range(4):
            ctl.note_served(1, 0.1, cost=1000.0)
        light = ctl.retry_after(3, queued_cost=3 * 1000.0)
        heavy = ctl.retry_after(3, queued_cost=3 * 50_000.0)
        fresh = m.AdmissionController(max_pending=64).retry_after(3, queued_cost=1e9)
        return light, heavy, fresh

    light, heavy, fresh = schedules(port_admission)
    assert heavy > light
    assert fresh > 0
    assert (light, heavy, fresh) == schedules(ref_admission)


def test_brownout_reads_cost_pressure():
    """The brownout ladder rises on the queued-cost fraction at a shallow
    depth, to the reference's level for the same pressures."""
    import deequ_tpu.serve.admission as ref_admission
    import deequ_tpu_torch.serve.admission as port_admission

    def levels(m):
        return [m.BrownoutController(capacity=100).update(5, cost_frac=frac)
                for frac in (None, 0.5, 0.8, 0.95)]

    got = levels(port_admission)
    lvl_depth_only, lvl_cost = got[0], got[3]
    assert lvl_cost >= lvl_depth_only
    assert lvl_cost >= 1, "95% queued-cost pressure must brown out"
    assert got == levels(ref_admission)


def test_service_stamps_predicted_cost_and_drains_ledger(cpu_serving):
    """submit() prices the suite with PLAN_COST_MODEL, the queue's ledger
    sums it, and a drained queue pins the ledger back to zero; the
    reference's service prices the same suite alike."""
    r = np.random.default_rng(2)
    ref_table = RefTable([ref_column("x", "fractional", r.normal(0, 1, 512),
                                     np.ones(512, bool))])
    ledgers = {}
    for side, pkg, Service, _, _, scope in _serve_sides():
        with scope():
            svc = Service(max_batch=4, coalesce_window=0.0)
            try:
                completeness = pkg.Completeness("x")
                res = svc.submit(_serve_table(side, ref_table),
                                 required_analyzers=(completeness,)).result(timeout=60)
                assert res.metrics[completeness].value.is_success
                ledgers[side] = (svc._queued_cost, svc._admission._avg_cost)
            finally:
                svc.stop(drain=False)
    queued, avg_cost = ledgers["port"]
    assert queued == 0.0
    assert avg_cost is not None and avg_cost > 0
    assert ledgers["port"] == ledgers["ref"]
