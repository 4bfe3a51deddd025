"""The row-sharded mesh (``deequ_tpu_torch/parallel/mesh.py`` and the
mesh paths of ``ops/scan_engine.py`` and ``ops/segment.py``) on the CPU.

The port's ``virtual_mesh(8, "cpu")`` — eight members on the CPU — is
held against the reference on its default 8-device mesh (the forced host
devices of tests/conftest.py), and the port over the mesh against itself
on one device:

- the main suite over ``smoke_schema_table``, in one chunk and in chunks
  the 8 members do not divide (members past a chunk's last row hold no
  rows), in memory, persisted over the mesh and streamed;
- grouping: the dense counts unfused and fused (K5 and K7 a member, the
  counts summed on the lead), a persisted string column's counts from its
  resident shards, the top-k after the sum;
- sketches: HyperLogLog registers exact, KLL summaries laid out member by
  member as the reference's ``all_gather`` lays them out;
- the incremental stream's group scan declining under a mesh;
- the module's functions and the placement rule that resolves a mesh and
  a device together.

Bounds are tests/torch_parity.py's: exact for counts, completeness,
compliance, extrema and group statistics, ``REL_BOUNDS`` for sums and
moments (the reference's psum and the port's member-order merge
associate the members differently).
"""

import math

import numpy as np
import pytest
import torch

import deequ_tpu
import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.streaming import stream_table as ref_stream_table
from deequ_tpu.ops import scan_engine as ref_scan_engine
from deequ_tpu.parallel.mesh import current_mesh as ref_current_mesh
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.data.streaming import stream_table
from deequ_tpu_torch.exceptions import DeviceUnavailableException
from deequ_tpu_torch.ops import scan_engine as port_scan_engine
from deequ_tpu_torch.ops.device_policy import MESH_HEALTH
from deequ_tpu_torch.ops.scan_engine import (
    SCAN_STATS,
    install_scan_fault_hook,
    persist_table,
    run_scan,
    total_resident_bytes,
)
from deequ_tpu_torch.parallel import mesh as mesh_mod
from deequ_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    default_mesh,
    mesh_device_ids,
    mesh_excluding,
    resolve_placement,
    set_mesh,
    use_mesh,
    virtual_mesh,
)
from torch_parity import (  # noqa: F401
    assert_metric_parity,
    parity_env,
    port_table,
    ref_column,
    smoke_schema_table,
)

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
BUDGET = 1 << 30


@pytest.fixture
def mesh8():
    return virtual_mesh(8, "cpu")


@pytest.fixture
def ref_mesh8():
    mesh = ref_current_mesh()
    assert mesh is not None and math.prod(mesh.devices.shape) == 8
    return mesh


def _smoke_check(pkg):
    """The chip-smoke check set at the small width of smoke_schema_table."""
    check = (
        pkg.Check(pkg.CheckLevel.ERROR, "smoke")
        .has_size(lambda n: n > 0)
        .is_complete("id")
        .has_completeness("f0", lambda v: v > 0.9)
    )
    for j in range(4):
        c = f"f{j}"
        check = (check.has_min(c, lambda v: True).has_max(c, lambda v: True)
                 .has_mean(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_standard_deviation(c, lambda v: v > 0))
    return (
        check.has_correlation("f0", "f1", lambda v: -1.0 <= v <= 1.0)
        .is_non_negative("f2", lambda v: v > 0)
        .is_contained_in("status", [f"S{i}" for i in range(7)], lambda v: v > 0.5)
        .satisfies("f1 > 14", "f1 above 14", lambda v: v > 0.99)
        .where("status = 'S1'")
        .is_unique("id")
        .has_uniqueness(["customer_id"], lambda v: 0 < v < 1)
        .has_distinctness(["status"], lambda v: v > 0)
        .has_entropy("region", lambda v: v > 0)
        .has_unique_value_ratio(["customer_id"], lambda v: 0 < v < 1)
    )


def _ref_run(data):
    return deequ_tpu.VerificationSuite.on_data(data).add_check(_smoke_check(deequ_tpu)).run()


def _port_run(data, mesh):
    with use_mesh(mesh):
        return (deequ_tpu_torch.VerificationSuite.on_data(data, device="cpu")
                .add_check(_smoke_check(deequ_tpu_torch)).run())


def _assert_agree(ref_result, port_result):
    """Every metric of the two results under the parity bounds; the
    extrema exact (the reference under DEEQU_TPU_COMPUTE=f64)."""
    assert port_result.status.value == ref_result.status.value
    ref_metrics = {repr(a): m for a, m in ref_result.metrics.items()}
    port_metrics = {repr(a): m for a, m in port_result.metrics.items()}
    assert set(port_metrics) == set(ref_metrics)
    for key, ref_metric in ref_metrics.items():
        assert_metric_parity(ref_metric, port_metrics[key])


@pytest.fixture
def f64_chunks(monkeypatch):
    """Both packages in f64 (the reference's exact plane), and a setter of
    both packages' in-memory chunk rows."""
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")

    def set_chunk(rows):
        monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: rows)
        monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: rows)

    return set_chunk


# -- the module's functions --------------------------------------------------------


def test_virtual_mesh_and_member_functions(mesh8):
    assert mesh8.size == 8
    assert mesh_device_ids(mesh8) == tuple(range(8))
    assert mesh8.devices == (CPU,) * 8 and mesh8.lead == CPU
    assert mesh_device_ids(None) == ()
    assert mesh8 == virtual_mesh(8, "cpu") and hash(mesh8) == hash(virtual_mesh(8, "cpu"))
    shrunk = mesh_excluding(mesh8, {6, 2})
    assert mesh_device_ids(shrunk) == (0, 1, 3, 4, 5, 7)  # mesh order kept
    lone = mesh_excluding(mesh8, set(range(8)) - {5})
    assert lone is not None and mesh_device_ids(lone) == (5,)  # a lone survivor stays a mesh
    assert mesh_excluding(mesh8, range(8)) is None
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh([(1, "cpu"), (1, "cpu")])
    with pytest.raises(ValueError):
        virtual_mesh(0, "cpu")


def test_mesh_scope_and_set_mesh(mesh8):
    import contextvars

    assert current_mesh() is None  # the CPU build sees no card: no default mesh
    with use_mesh(mesh8):
        assert current_mesh() is mesh8
        with use_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is mesh8
    assert current_mesh() is None

    def inside():
        set_mesh(mesh8)
        return current_mesh()

    assert contextvars.copy_context().run(inside) is mesh8
    assert current_mesh() is None  # set_mesh holds in its own context only


def test_default_mesh_spans_every_card_and_is_never_virtual(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = default_mesh()
    assert mesh_device_ids(mesh) == (0, 1, 2, 3)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))


def test_placement_rule(mesh8, monkeypatch):
    """The rule of parallel/mesh.py's doc: an asked mesh leads; an
    explicit device that is not its lead raises; with no mesh asked, an
    explicit device pins one device and no device takes the default
    mesh."""
    from deequ_tpu_torch.device import use_device

    # no mesh asked, a device asked: one device
    assert resolve_placement("cpu") == (CPU, None)
    # an asked mesh, by argument or by scope, with its lead's device
    assert resolve_placement("cpu", mesh8) == (CPU, mesh8)
    with use_mesh(mesh8):
        assert resolve_placement("cpu") == (CPU, mesh8)
        assert resolve_placement() == (CPU, mesh8)  # no device asked: the mesh's lead
        with use_device("cpu"):
            assert resolve_placement() == (CPU, mesh8)
    with use_mesh(None), use_device("cpu"):
        assert resolve_placement() == (CPU, None)
    # a device that is not the mesh's lead: a sign, never a silent drop
    card_mesh = Mesh([(0, torch.device("cuda", 0)), (1, torch.device("cuda", 0))])
    with pytest.raises(ValueError, match="led by"):
        resolve_placement("cpu", card_mesh)
    with use_mesh(card_mesh), pytest.raises(ValueError, match="led by"):
        resolve_placement("cpu")
    # neither asked: the default mesh where a machine has one, else cuda
    monkeypatch.setattr(mesh_mod, "default_mesh", lambda: mesh8)
    assert resolve_placement() == (CPU, mesh8)
    assert resolve_placement("cpu") == (CPU, None)
    monkeypatch.setattr(mesh_mod, "default_mesh", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableException):
        resolve_placement()


def test_an_asked_mesh_shards_the_run_or_raises(mesh8):
    """A suite run under an asked mesh runs every chunk step over all its
    members; one whose device conflicts with the mesh raises before it
    scans."""
    table = port_table(smoke_schema_table(4000, seed=3))
    seen = []

    def hook(boundary, ctx):
        seen.append(tuple(ctx.get("device_ids") or ()))

    prev = install_scan_fault_hook(hook)
    try:
        _port_run(table, mesh8)
    finally:
        install_scan_fault_hook(prev)
    assert seen and all(ids == tuple(range(8)) for ids in seen)
    card_mesh = Mesh([(0, torch.device("cuda", 0))])
    with use_mesh(card_mesh), pytest.raises(ValueError):
        deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu").run()


# -- the main suite ----------------------------------------------------------------


def test_main_suite_on_virtual_mesh_matches_reference_mesh8(parity_env, f64_chunks, mesh8,
                                                            ref_mesh8):
    ref = smoke_schema_table(50_000, seed=5)
    port = port_table(ref)
    SCAN_STATS.reset()
    port_result = _port_run(port, mesh8)
    _assert_agree(_ref_run(ref), port_result)
    assert all(m.value.is_success for m in port_result.metrics.values())
    assert port_result.scan_stats["scan_passes"] == 1
    assert SCAN_STATS.last_scan_fetches == 1
    # the port over the mesh against itself on one device
    _assert_agree(_port_run(port, None), port_result)


@pytest.mark.parametrize("chunk", [4999, 6000])
def test_multi_chunk_suite_with_uneven_shards(parity_env, f64_chunks, mesh8, ref_mesh8, chunk):
    """Chunks of 5000 rows (4999 rounded up to a multiple of 8) or 6000
    over 12,345 rows: the last chunk leaves members with few rows or none,
    and both packages shard it alike."""
    f64_chunks(chunk)
    ref = smoke_schema_table(12_345, seed=7)
    port = port_table(ref)
    SCAN_STATS.reset()
    port_result = _port_run(port, mesh8)
    rounded = -(-chunk // 8) * 8
    assert SCAN_STATS.chunks_processed == -(-12_345 // rounded)
    _assert_agree(_ref_run(ref), port_result)
    _assert_agree(_port_run(port, None), port_result)


def test_persisted_suite_on_mesh_matches_reference(parity_env, f64_chunks, mesh8, ref_mesh8):
    ref = smoke_schema_table(20_003, seed=11)
    port = port_table(ref)
    cache = persist_table(port, "cpu", chunk_rows=6000, max_bytes=BUDGET, mesh=mesh8)
    try:
        assert cache.mesh == mesh8 and cache.chunk == 6000
        # each member holds its 750 rows of each chunk; the last chunk's
        # 2003 rows fill members 0-1 and leave 503 to member 2
        last = [cache.shard(len(cache.device_chunks) - 1, i)[0].shape[1] for i in range(8)]
        assert last == [750, 750, 503, 0, 0, 0, 0, 0]
        assert total_resident_bytes("cpu") == cache.nbytes == sum(cache.member_bytes)
        SCAN_STATS.reset()
        port_result = _port_run(port, mesh8)
        assert SCAN_STATS.resident_passes == 1
        ref_scan_engine.persist_table(ref, chunk_rows=6000)
        try:
            _assert_agree(_ref_run(ref), port_result)
        finally:
            ref.unpersist()
    finally:
        port.unpersist()
    assert total_resident_bytes() == 0


def test_streamed_suite_on_mesh_matches_reference(parity_env, f64_chunks, mesh8, ref_mesh8):
    ref = smoke_schema_table(9_000, seed=13)
    port = port_table(ref)
    SCAN_STATS.reset()
    port_result = _port_run(stream_table(port, 2_500), mesh8)
    assert SCAN_STATS.chunks_staged == 4
    _assert_agree(_ref_run(ref_stream_table(ref, 2_500)), port_result)


def test_sharded_gather_layout_is_member_major(mesh8, ref_mesh8):
    """A gather leaf (a standard deviation's per-chunk moments) holds one
    row a member a chunk, chunk-major and member-major within a chunk — the
    reference's all_gather layout: the per-row counts agree exactly."""
    ref = smoke_schema_table(10_001, seed=17)
    port = port_table(ref)
    port_op = port_analyzers.StandardDeviation("f0").scan_op(port)
    ref_op = ref_analyzers.StandardDeviation("f0").scan_op(ref)
    (got,) = run_scan(port, [port_op], "cpu", chunk_rows=4000, mesh=mesh8)
    (want,) = ref_scan_engine.run_scan(ref, [ref_op], chunk_rows=4000, mesh=ref_mesh8)
    gathered = [k for k, tag in port_op.tags.items() if tag == "gather"]
    assert gathered
    for key in gathered:
        assert np.asarray(got[key]).shape[0] == 3 * 8
    port_counts = np.concatenate([np.atleast_1d(np.asarray(got[k])).reshape(24, -1)[:, 0]
                                  for k in gathered[:1]])
    ref_leaves = [np.asarray(v) for v in _leaves(want)]
    assert any(np.array_equal(port_counts, leaf.reshape(24, -1)[:, 0])
               for leaf in ref_leaves if leaf.size % 24 == 0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- grouping ----------------------------------------------------------------------


def _group_specs(pkg):
    return [
        pkg.Uniqueness(["customer_id"]),
        pkg.Distinctness(["status"]),
        pkg.Entropy("region"),
        pkg.CountDistinct(["customer_id", "status"]),
        pkg.MutualInformation(["status", "region"]),
        pkg.Histogram("region"),
        pkg.Histogram("customer_id"),
    ]


def _dist(metric_value):
    return {k: (v.absolute, v.ratio) for k, v in metric_value.values.items()}, \
        metric_value.number_of_bins


def _assert_group_metrics(ref_ctx, port_ctx):
    for r, p in zip(_group_specs(ref_analyzers), _group_specs(port_analyzers)):
        if type(r).__name__ == "Histogram":
            assert _dist(port_ctx.metric(p).value.get()) == _dist(ref_ctx.metric(r).value.get())
        else:
            assert_metric_parity(ref_ctx.metric(r), port_ctx.metric(p))


@pytest.mark.parametrize("fusion", ["fused", "unfused"])
def test_grouping_counts_on_mesh_match_reference(parity_env, monkeypatch, mesh8, ref_mesh8,
                                                 fusion):
    monkeypatch.setenv("DEEQU_TORCH_PLAN_FUSION", "1" if fusion == "fused" else "0")
    ref = smoke_schema_table(30_001, seed=19)
    port = port_table(ref)
    ref_ctx = RefRunner.do_analysis_run(ref, _group_specs(ref_analyzers))
    SCAN_STATS.reset()
    with use_mesh(mesh8):
        port_ctx = PortRunner.do_analysis_run(port, _group_specs(port_analyzers), device="cpu")
    _assert_group_metrics(ref_ctx, port_ctx)
    assert SCAN_STATS.hist_host_dispatches == 0
    if fusion == "fused":
        assert SCAN_STATS.fused_group_passes >= 2
    # the mesh against one device: the summed counts are exact
    with use_mesh(None):
        single = PortRunner.do_analysis_run(port, _group_specs(port_analyzers), device="cpu")
    for a in _group_specs(port_analyzers):
        assert port_ctx.metric(a).value.get() == single.metric(a).value.get()


def test_member_counts_sum_each_members_shard(mesh8, monkeypatch):
    """Each member counts its ceil(rows / 8) keys and the counts sum on the
    lead: the shards the members saw partition the keys."""
    from deequ_tpu_torch.ops import histogram_device, segment

    seen = []
    real = histogram_device.bincount_variant

    def spy(variant, seg, num_segments, *a, **k):
        seen.append(seg.numel())
        return real(variant, seg, num_segments, *a, **k)

    monkeypatch.setattr(segment, "bincount_variant", spy)
    monkeypatch.setattr(segment, "HOST_GROUP_LIMIT", 0)
    keys = np.random.default_rng(3).integers(-1, 50, 1003)
    with use_mesh(mesh8):
        counts = segment._device_bincount(keys, 50, "cpu")
    assert seen == [126] * 7 + [1003 - 7 * 126]
    np.testing.assert_array_equal(counts, np.bincount(keys[keys >= 0], minlength=50))


def test_resident_string_counts_on_mesh(parity_env, mesh8, ref_mesh8):
    """A string column persisted over the mesh counts each member's
    resident codes of each chunk (K5 a member a chunk), summed on the
    lead; the top-k and entropy follow the sum."""
    ref = smoke_schema_table(14_000, seed=23)
    port = port_table(ref)
    specs = lambda pkg: [pkg.Histogram("region"), pkg.Entropy("region")]  # noqa: E731
    ref_ctx = RefRunner.do_analysis_run(ref, specs(ref_analyzers))
    persist_table(port, "cpu", chunk_rows=5000, max_bytes=BUDGET, mesh=mesh8)
    try:
        SCAN_STATS.reset()
        with use_mesh(mesh8):
            port_ctx = PortRunner.do_analysis_run(port, specs(port_analyzers), device="cpu")
        # two grouping passes (histogram, entropy), each 3 chunks x 8 members
        assert SCAN_STATS.hist_plain_dispatches == 2 * 3 * 8
    finally:
        port.unpersist()
    r_hist, r_ent = specs(ref_analyzers)
    p_hist, p_ent = specs(port_analyzers)
    assert _dist(port_ctx.metric(p_hist).value.get()) == _dist(ref_ctx.metric(r_hist).value.get())
    assert_metric_parity(ref_ctx.metric(r_ent), port_ctx.metric(p_ent))


# -- sketches ----------------------------------------------------------------------


def test_sketches_on_mesh(parity_env, f64_chunks, mesh8, ref_mesh8):
    """HyperLogLog registers exact; KLL summaries member-major with the
    reference's layout and totals, within its rank error."""
    f64_chunks(3000)
    ref = smoke_schema_table(10_000, seed=29)
    port = port_table(ref)

    def specs(pkg):
        return [pkg.ApproxCountDistinct("customer_id"), pkg.ApproxCountDistinct("region"),
                pkg.ApproxQuantile("f1", 0.5), pkg.ApproxQuantiles("f0", (0.1, 0.9)),
                pkg.KLLSketch("f2")]

    ref_ctx = RefRunner.do_analysis_run(ref, specs(ref_analyzers))
    with use_mesh(mesh8):
        port_ctx = PortRunner.do_analysis_run(port, specs(port_analyzers), device="cpu")
    for r, p in zip(specs(ref_analyzers), specs(port_analyzers)):
        want, got = ref_ctx.metric(r).value.get(), port_ctx.metric(p).value.get()
        name = type(r).__name__
        if name == "ApproxCountDistinct":
            assert got == want
        elif name == "KLLSketch":
            assert got.parameters == want.parameters
            assert sum(b.count for b in got.buckets) == sum(b.count for b in want.buckets)
            assert [len(d) for d in got.data] == [len(d) for d in want.data]
        else:
            col = port[r.column].values[port[r.column].mask]
            qs = [r.quantile] if name == "ApproxQuantile" else list(r.quantiles)
            vals = [got] if name == "ApproxQuantile" else [got[str(q)] for q in qs]
            for q, v in zip(qs, vals):
                rank = np.searchsorted(np.sort(col), v, side="right") / len(col)
                assert abs(rank - q) <= 0.01 + 1e-9, (name, q, rank)


# -- the incremental stream --------------------------------------------------------


def test_incremental_group_scan_declines_under_mesh(parity_env, mesh8):
    from deequ_tpu_torch.analyzers.incremental import IncrementalAnalysisStream
    from deequ_tpu_torch.ops.scan_engine import group_scannable

    batches = [port_table(smoke_schema_table(2000, seed=s)) for s in range(4)]
    analyzers = [port_analyzers.Size(), port_analyzers.Mean("f0"),
                 port_analyzers.Completeness("f1"), port_analyzers.Maximum("f3")]
    ops = [a.scan_op(batches[0]) for a in analyzers]
    assert group_scannable(batches, ops)
    assert group_scannable(batches, ops, mesh8) is False

    def drive(mesh):
        SCAN_STATS.reset()
        with use_mesh(mesh):
            stream = IncrementalAnalysisStream(analyzers, window=4, device="cpu")
        out = []
        for k, b in enumerate(batches):
            out.extend(stream.submit(b, tag=k))
        out.extend(stream.close())
        return [{repr(a): ctx.metric(a).value.get() for a in analyzers} for _, ctx in out], \
            SCAN_STATS.group_scan_passes

    sharded, groups = drive(mesh8)
    assert groups == 0  # every batch took its own sharded scan
    single, single_groups = drive(None)
    assert single_groups == 1
    for got, want in zip(sharded, single):
        assert got.keys() == want.keys()
        for key in want:
            a, b = got[key], want[key]
            assert a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (key, a, b)


# -- the merge and the residency ----------------------------------------------------


def test_mesh_merge_folds_members_in_order():
    from deequ_tpu_torch.ops import masked_reduce
    from deequ_tpu_torch.ops.scan_engine import mesh_merge

    rng = np.random.default_rng(5)
    m, size = 9, 14
    src = torch.from_numpy(rng.permutation(size)[:m].astype(np.int64))
    is_sum = torch.from_numpy(rng.random(m) < 0.5)
    is_min = ~is_sum & torch.from_numpy(rng.random(m) < 0.5)
    flats = [torch.from_numpy(rng.normal(size=size)) for _ in range(4)]
    got = mesh_merge(is_sum, is_min, flats, src)
    want = flats[0][src]
    for f in flats[1:]:
        want = masked_reduce.merge_tags_plain(is_sum, is_min, want, f, src)
    assert torch.equal(got, want)


def test_luts_placed_once_a_member_device(mesh8):
    """A scan over the mesh places each lookup table on every member's
    device, one copy a distinct device: the eight CPU members share one,
    built once."""
    from deequ_tpu_torch.ops import lut_cache
    from deequ_tpu_torch.ops.scan_engine import _member_luts

    table = port_table(smoke_schema_table(500, seed=37))
    op = port_analyzers.PatternMatch("region", r"^R00").scan_op(table)
    before = lut_cache.BUILDS
    placed = _member_luts([op], {"region": table["region"]}, mesh8.members)
    assert list(placed) == [CPU]
    again = _member_luts([op], {"region": table["region"]}, mesh8.members)
    assert lut_cache.BUILDS - before == len(op.luts)  # built once, not once a member
    for col, luts in placed[CPU].items():
        for key, lut in luts.items():
            assert again[CPU][col][key] is lut


def test_persist_budget_is_each_member_devices(mesh8):
    table = port_table(smoke_schema_table(4000, seed=31))
    cache = persist_table(table, "cpu", chunk_rows=2000, max_bytes=BUDGET, mesh=mesh8)
    one = cache.nbytes
    assert cache.bytes_on("cpu") == one and total_resident_bytes("cpu") == one
    other = port_table(smoke_schema_table(4000, seed=32))
    with pytest.raises(MemoryError):  # both on the members' one device
        persist_table(other, "cpu", chunk_rows=2000, max_bytes=one + one // 2, mesh=mesh8)
    assert other._device_cache is None
    table.unpersist()
    assert total_resident_bytes() == 0 and cache.nbytes == 0
    MESH_HEALTH.reset()
