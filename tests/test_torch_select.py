"""K4, the port's radix select (``deequ_tpu_torch/ops/select_device.py``),
and its routing (``ops/scan_plan.py``) against K3 and the reference, on
the CPU (K5 runs as its plain version here; ``chip_smoke.py``'s
``resident_path`` holds the kernel on the card).

- K4 against K3 (the port's sort, bit-identical to the reference's f64
  path, tests/test_torch_sketches.py) on adversarial columns (generated
  by ``tests/select_cases.py``, which ``chip_smoke.py``'s
  ``select_parity`` runs on the card too): the strata items bit for bit,
  the remainder as a multiset of bit patterns (K4 writes it in row
  order), count/weights/min/max, and the folded states bit for bit —
  twin of ``test_select_matches_sort_reference_adversarial``;
- the plain version in the kernel's digit plan (eight byte passes)
  against K3 and numpy's exact ranks at the kernel's tile edges (8,192
  rows) and at k = 16,384; its per-pass trace; ranks in any order;
- exact ranks against numpy; the order-preserving key;
- a select-made sketch merges with a host sketch;
- routing: resident scans select with ``device_sort_passes == 0``,
  streaming scans and sketches past 2^14 sort, the plan census,
  ``select_kernel`` validation, and the rule read from the card's K4-vs-K3
  table (``select_beats_sort``: large sketches over small chunks sort);
- a persisted port run's folded KLL states equal the reference's
  persisted run under ``DEEQU_TPU_COMPUTE=f64`` (its wide-f64 columns
  sort) bit for bit, and the reference's default persisted run (its
  pair-plane select) within the sketch's rank error.
"""

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.ops.scan_engine as ref_scan_engine
import deequ_tpu_torch.analyzers as port_analyzers
import deequ_tpu_torch.ops.scan_engine as port_scan_engine
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.ops import select_device
from deequ_tpu_torch.ops.kll import KLLSketchState
from deequ_tpu_torch.ops.kll_device import chunk_summary_batched, fold_summaries
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan
from deequ_tpu_torch.ops.scan_plan import (
    plan_scan_ops,
    select_beats_sort,
    select_kernel_enabled,
)
from deequ_tpu_torch.ops.select_device import (
    NAN_KEY,
    PASSES,
    chunk_summary_select_batched,
    chunk_summary_select_batched_plain,
    inverse_monotone_i64,
    monotone_i64,
    select_ranks,
    select_ranks_plain,
)
from select_cases import adversarial_cases
from torch_parity import parity_env, port_table, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port

BUDGET = 1 << 30


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(np.int64)


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.int64).view(np.float64)


_RNG, _NAN_BITS, _ADVERSARIAL = adversarial_cases()


def _both(values, mask, k, capacity=None):
    X = torch.from_numpy(np.stack([values, values[::-1].copy()]))
    M = torch.from_numpy(np.stack([mask, mask[::-1].copy()]))
    capacity = capacity or max(len(values), 1)
    return (chunk_summary_batched(X, M, k, capacity),
            chunk_summary_select_batched(X, M, k, capacity))


def _assert_summaries_equal(a, b, k):
    for key in ("count", "weights"):
        assert torch.equal(a[key], b[key]), key
    for key in ("min", "max"):
        assert np.array_equal(a[key].numpy(), b[key].numpy(), equal_nan=True), key
    ia, ib = a["items"].numpy(), b["items"].numpy()
    assert np.array_equal(_bits(ia[:, :k]), _bits(ib[:, :k]))
    assert np.array_equal(np.sort(_bits(ia[:, k:]), axis=1), np.sort(_bits(ib[:, k:]), axis=1))


@pytest.mark.parametrize("case", sorted(_ADVERSARIAL))
@pytest.mark.parametrize("k", [16, 256])
def test_select_matches_sort_adversarial(case, k):
    values, mask = _ADVERSARIAL[case]
    mask = np.ones(len(values), dtype=bool) if mask is None else mask
    a, b = _both(values, mask, k)
    _assert_summaries_equal(a, b, k)
    for j in range(2):
        sa = fold_summaries(a["items"][j].numpy(), a["weights"][j].numpy(), k, 0.64)
        sb = fold_summaries(b["items"][j].numpy(), b["weights"][j].numpy(), k, 0.64)
        if sa is None:
            assert sb is None
            continue
        assert (sa.count, len(sa.compactors)) == (sb.count, len(sb.compactors))
        for la, lb in zip(sa.compactors, sb.compactors):
            if case == "nan_payloads":
                # np.sort orders NaN payloads by their input order, which
                # differs between the two remainders; the values agree
                assert np.array_equal(la, lb, equal_nan=True)
            else:
                assert np.array_equal(_bits(la), _bits(lb))


def test_select_splits_wide_batches(monkeypatch):
    """Column batches past MAX_BINS a pass are split; the result is the
    same."""
    values = _RNG.normal(0, 1, (5, 1500))
    mask = _RNG.random((5, 1500)) > 0.1
    X, M = torch.from_numpy(values), torch.from_numpy(mask)
    whole = chunk_summary_select_batched(X, M, 64, 1500)
    monkeypatch.setattr(select_device, "MAX_BINS", 2 * 66 * 256)
    split = chunk_summary_select_batched(X, M, 64, 1500)
    sort = chunk_summary_batched(X, M, 64, 1500)
    for key in whole:
        assert torch.equal(whole[key], split[key]), key
    _assert_summaries_equal(sort, split, 64)


def test_short_last_chunk_and_empty_chunk():
    """The width comes from the capacity, not the chunk's rows, and an
    empty chunk summarises as one invalid row — as K3 does."""
    values = _RNG.normal(0, 1, 700)
    a, b = _both(values, np.ones(700, dtype=bool), 64, capacity=3000)
    _assert_summaries_equal(a, b, 64)
    empty = torch.zeros((2, 0), dtype=torch.float64)
    none = torch.zeros((2, 0), dtype=torch.bool)
    a = chunk_summary_batched(empty, none, 64, 3000)
    b = chunk_summary_select_batched(empty, none, 64, 3000)
    _assert_summaries_equal(a, b, 64)


def test_select_exact_ranks_vs_numpy():
    """Strata items equal numpy's sorted column at the midpoint ranks, and
    the remainder is its top m - n_strata·w values."""
    k = 64
    values = _RNG.normal(100, 10, 3001)
    X = torch.from_numpy(values).unsqueeze(0)
    out = chunk_summary_select_batched(X, torch.ones_like(X, dtype=torch.bool), k, 3001)
    items, weights = out["items"][0].numpy(), out["weights"][0].numpy()
    sv, m = np.sort(values), len(values)
    w = int(weights[0])
    n_strata = int((weights[:k] > 0).sum())
    assert n_strata == m // w
    for i in range(n_strata):
        assert items[i] == sv[i * w + w // 2]
    n_rem = m - n_strata * w
    got = np.sort(items[k:][weights[k:] > 0])
    assert np.array_equal(got, sv[m - n_rem:])


#: the kernel's tile (rows of one column a block takes, csrc/select.cu)
_TILE = 8192


def _edge_column(n, kind, rng):
    if kind == "normal":
        return rng.normal(100, 10, n), rng.random(n) > 0.05
    # ties across tiles: few values, both zeros, NaN payloads, nulls
    pool = np.array([-0.0, 0.0, 1.5, -2.0, np.inf, _from_bits(_NAN_BITS[1]), 2.0 ** 60])
    return rng.choice(pool, n), rng.random(n) > 0.1


def _assert_exact_strata(out, values, mask, k):
    """Each column's strata items equal numpy's sorted valid values (nulls
    as +inf, NaNs last) at the midpoint ranks, bit for bit up to the zero
    and NaN keys."""
    for j in range(values.shape[0]):
        xf = np.where(mask[j], values[j], np.inf)
        sv = np.sort(np.where(xf == 0, 0.0, xf))
        items, weights = out["items"][j].numpy(), out["weights"][j].numpy()
        w = int(weights[0]) if weights[0] > 0 else 1
        for i in np.nonzero(weights[:k] > 0)[0]:
            want, got = sv[i * w + w // 2], items[i]
            assert (np.isnan(want) and np.isnan(got)) or want == got, (j, i)


@pytest.mark.parametrize("n", [1, _TILE - 1, _TILE, _TILE + 1, 20_000])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_plain_at_tile_edges_matches_sort_and_numpy(n, kind):
    """The plain version in the kernel's plan (eight byte passes) at the
    kernel's tile edges: K3's summary, numpy's exact ranks."""
    rng = np.random.default_rng(n)
    cols = [_edge_column(n, kind, rng) for _ in range(3)]
    values = np.stack([c[0] for c in cols])
    mask = np.stack([c[1] for c in cols])
    X, M = torch.from_numpy(values), torch.from_numpy(mask)
    for k in (16, 256):
        got = chunk_summary_select_batched_plain(X, M, k, n)
        _assert_summaries_equal(chunk_summary_batched(X, M, k, n), got, k)
        _assert_exact_strata(got, values, mask, k)


def test_plain_at_the_largest_sketch_size():
    """k = 16,384 (MAX_SELECT_SKETCH_SIZE): 16,386 targets a column."""
    k = select_device.MAX_SELECT_SKETCH_SIZE
    rng = np.random.default_rng(16384)
    values = rng.normal(0, 1, (2, 40_000))
    values[1, ::3] = 0.25  # a tie group wider than many strata
    mask = rng.random((2, 40_000)) > 0.02
    X, M = torch.from_numpy(values), torch.from_numpy(mask)
    got = chunk_summary_select_batched_plain(X, M, k, 40_000)
    _assert_summaries_equal(chunk_summary_batched(X, M, k, 40_000), got, k)
    _assert_exact_strata(got, values, mask, k)


def test_select_ranks_any_order_and_trace_vs_numpy():
    """Ranks in any order (clipped into [0, n)): the key at each rank, the
    rank inside its ties, and after each pass the top 8(p + 1) bits of that
    key (unsigned) and the rank left below them, all from numpy."""
    values, mask = _ADVERSARIAL["nan_payloads"]
    values = np.stack([values, _ADVERSARIAL["digit_boundaries"][0]])
    mask = np.stack([mask, np.ones(len(mask), dtype=bool)])
    n = values.shape[1]
    ranks = torch.from_numpy(np.random.default_rng(41).integers(-5, n + 5, (2, 41)))
    X, M = torch.from_numpy(values), torch.from_numpy(mask)
    keys, tie, (pfx, rem) = select_ranks_plain(X, M, ranks, trace=True)
    assert pfx.shape == rem.shape == (2, PASSES, 41)
    for j in range(2):
        skey = np.sort(monotone_i64(torch.where(M[j], X[j], np.inf)).numpy())
        ukey = skey.view(np.uint64) ^ np.uint64(1 << 63)
        for t, r in enumerate(np.clip(ranks[j].numpy(), 0, n - 1)):
            assert keys[j, t] == skey[r]
            assert tie[j, t] == r - np.searchsorted(skey, skey[r])
            for p in range(PASSES):
                shift = np.uint64(56 - 8 * p)
                top = ukey[r] >> shift
                assert np.uint64(pfx[j, p, t].numpy()).view(np.uint64) == top
                assert rem[j, p, t] == r - np.searchsorted(ukey >> shift, top)
    assert torch.equal(select_ranks(X, M, ranks)[0], keys)


def test_wrappers_take_the_plain_version_on_the_cpu():
    values, mask = _ADVERSARIAL["normals"]
    X = torch.from_numpy(np.stack([values, values]))
    M = torch.from_numpy(np.stack([mask, mask]))
    before = select_device.LAUNCHES
    got = chunk_summary_select_batched(X, M, 64, 2000)
    want = chunk_summary_select_batched_plain(X, M, 64, 2000)
    assert select_device.LAUNCHES == before
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("args", [
    (torch.zeros(5), torch.zeros(5, dtype=torch.bool)),
    (torch.zeros((2, 5), dtype=torch.float32), torch.zeros((2, 5), dtype=torch.bool)),
    (torch.zeros((2, 5), dtype=torch.float64), torch.zeros((2, 4), dtype=torch.bool)),
    (torch.zeros((2, 5), dtype=torch.float64), torch.zeros((2, 5), dtype=torch.uint8)),
])
def test_select_rejects_bad_input(args):
    with pytest.raises(ValueError):
        chunk_summary_select_batched(*args, 16, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["signed_zeros", "nan_payloads", "all_null", "normals"])
def test_cuda_kernel_matches_plain_and_sort(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the select kernel has no CPU mode")
    values, mask = _ADVERSARIAL[case]
    mask = np.ones(len(values), dtype=bool) if mask is None else mask
    X = torch.from_numpy(np.stack([values, values[::-1].copy()])).cuda()
    M = torch.from_numpy(np.stack([mask, mask[::-1].copy()])).cuda()
    before = select_device.LAUNCHES
    got = chunk_summary_select_batched(X, M, 256, len(values))
    assert select_device.LAUNCHES == before + 1
    got = {key: t.cpu() for key, t in got.items()}
    want = chunk_summary_select_batched_plain(X.cpu(), M.cpu(), 256, len(values))
    for key in ("items", "weights", "count"):
        assert torch.equal(got[key].view(torch.int64) if key == "items" else got[key],
                           want[key].view(torch.int64) if key == "items" else want[key]), key
    _assert_summaries_equal(chunk_summary_batched(X.cpu(), M.cpu(), 256, len(values)), got, 256)


def test_monotone_key_round_trip_and_order():
    ordered = np.array([-np.inf, -1e300, -1.5, -1e-310, -5e-324, 0.0, 5e-324, 1e-310,
                        2.5, 2.0 ** 60, 1e300, np.inf])
    keys = monotone_i64(torch.from_numpy(ordered))
    assert bool((keys[1:] > keys[:-1]).all())
    assert np.array_equal(_bits(inverse_monotone_i64(keys).numpy()), _bits(ordered))
    special = torch.from_numpy(np.array([-0.0, 0.0, np.nan, -np.nan, _from_bits(_NAN_BITS[0])]))
    got = monotone_i64(special).tolist()
    assert got[:2] == [0, 0] and got[2:] == [NAN_KEY] * 3
    assert NAN_KEY > int(monotone_i64(torch.tensor([np.inf], dtype=torch.float64))[0])


def test_selection_sketch_merges_with_host_sketch():
    values = _RNG.normal(50, 10, 20_000)
    X = torch.from_numpy(values).unsqueeze(0)
    out = chunk_summary_select_batched(X, torch.ones_like(X, dtype=torch.bool), 256, 20_000)
    sel = fold_summaries(out["items"].numpy(), out["weights"].numpy(), 256, 0.64)
    host = KLLSketchState(256, 0.64)
    other = _RNG.normal(60, 5, 10_000)
    host.update_batch(other)
    merged = sel.merge(host)
    assert merged.count == len(values) + len(other)
    lo, hi = np.quantile(np.concatenate([values, other]), [0.45, 0.55])
    assert lo <= merged.quantile(0.5) <= hi


# -- routing ------------------------------------------------------------------


def _two_col_table(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) > 0.02
    return ColumnarTable([
        Column("c0", DType.FRACTIONAL, values=rng.normal(5, 2, n), mask=mask),
        Column("c1", DType.INTEGRAL, values=rng.integers(-50, 50, n)),
    ])


def _quantile_analyzers():
    return [
        port_analyzers.Size(), port_analyzers.Mean("c0"),
        port_analyzers.ApproxQuantile("c0", 0.5), port_analyzers.ApproxQuantile("c1", 0.25),
        port_analyzers.ApproxQuantiles("c1", (0.1, 0.9)), port_analyzers.KLLSketch("c0"),
        port_analyzers.ApproxQuantile("c0", 0.3, where="c1 > 0"),
    ]


def _values(ctx, analyzers):
    out = []
    for a in analyzers:
        v = ctx.metric(a).value.get()
        out.append(v.data if isinstance(a, port_analyzers.KLLSketch) else v)
    return out


def test_resident_scan_selects_with_zero_sort_passes(parity_env):
    analyzers = _quantile_analyzers()
    with use_device("cpu"):
        SCAN_STATS.reset()
        sort_ctx = PortRunner.do_analysis_run(_two_col_table(), analyzers)
        assert SCAN_STATS.device_sort_passes > 0 and SCAN_STATS.device_select_passes == 0
        table = _two_col_table().persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        sel_ctx = PortRunner.do_analysis_run(table, analyzers)
        assert SCAN_STATS.device_sort_passes == 0 and SCAN_STATS.kll_sort_passes == 0
        # per chunk: the batched k=256 op, KLLSketch (k=2048), the filtered op
        assert SCAN_STATS.device_select_passes == 3
        assert SCAN_STATS.resident_passes == 1
        table.unpersist()
    # one chunk each way: the select and the sort agree bit for bit
    assert _values(sort_ctx, analyzers) == _values(sel_ctx, analyzers)


def test_streaming_scan_keeps_sort(parity_env):
    with use_device("cpu"):
        SCAN_STATS.reset()
        PortRunner.do_analysis_run(_two_col_table(), _quantile_analyzers())
    assert SCAN_STATS.device_select_passes == 0
    assert SCAN_STATS.device_sort_passes == 3 and SCAN_STATS.kll_sort_passes == 3


def test_huge_sketch_sizes_keep_sort(parity_env):
    """relative_error 1e-4 asks for k = 23,000 > 2^14: that op sorts even
    on a resident scan; the other op still selects."""
    analyzers = [port_analyzers.ApproxQuantile("c0", 0.5, relative_error=1e-4),
                 port_analyzers.ApproxQuantile("c1", 0.5)]
    with use_device("cpu"):
        table = _two_col_table().persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        PortRunner.do_analysis_run(table, analyzers)
        table.unpersist()
    assert SCAN_STATS.device_sort_passes == 1 and SCAN_STATS.device_select_passes == 1


def test_select_kernel_false_sorts_the_same_chunks_bit_identically(parity_env):
    table = _two_col_table(n=9000)
    analyzers = [port_analyzers.ApproxQuantile(c, 0.5) for c in ("c0", "c1")]
    ops, plan = PortRunner._coalesce_scan_ops([a.scan_op(table) for a in analyzers])
    table.persist("cpu", max_bytes=BUDGET)
    results = {}
    for select in (True, False):
        SCAN_STATS.reset()
        results[select] = run_scan(table, ops, "cpu", chunk_rows=None, select_kernel=select)
        assert SCAN_STATS.resident_passes == 1
        assert (SCAN_STATS.device_select_passes > 0) == select
    table.unpersist()
    for a, (i, ex) in zip(analyzers, plan):
        sa = a.state_from_scan_result(ex(results[True][i]))
        sb = a.state_from_scan_result(ex(results[False][i]))
        assert [list(_bits(c)) for c in sa.sketch.compactors] == [
            list(_bits(c)) for c in sb.sketch.compactors]


def test_plan_scan_ops_census():
    table = _two_col_table()
    ops = [a.scan_op(table) for a in _quantile_analyzers()[1:]]
    resident = plan_scan_ops(ops, None, resident=True)
    assert (resident.select_ops, resident.sort_ops, resident.variant) == (5, 0, "select")
    assert all(not op.sorts_chunk for op in resident.ops)
    streaming = plan_scan_ops(ops, None, resident=False)
    assert (streaming.select_ops, streaming.sort_ops, streaming.variant) == (0, 5, "sort")
    off = plan_scan_ops(ops, None, resident=True, select_kernel=False)
    assert off.variant == "sort"
    huge = ops + [port_analyzers.ApproxQuantile("c0", 0.5, 1e-4).scan_op(table)]
    mixed = plan_scan_ops(huge, None, resident=True)
    assert (mixed.select_ops, mixed.sort_ops, mixed.variant) == (5, 1, "mixed")
    none = plan_scan_ops(ops[:1], None, resident=True)
    assert (none.select_ops, none.sort_ops, none.variant) == (0, 0, "none")


@pytest.mark.parametrize("rows,k,select", [
    (65_536, 256, True), (65_536, 2048, True), (1 << 25, 2048, True),
    (65_536, 16_384, False), (524_288, 16_384, False), (1_048_703, 16_384, False),
    (1_048_704, 16_384, True), (4_194_304, 16_384, True), (1 << 25, 16_384, True),
    (100_000, 4096, False), (262_272, 4096, True),
])
def test_select_beats_sort_rule(rows, k, select):
    """The rule read from PERF.md's K4-vs-K3 table: K3 for more than 2,050
    targets with fewer than 64 rows each, K4 everywhere else."""
    assert select_beats_sort(rows, k) is select


def test_resident_scan_routes_large_sketches_over_small_chunks_to_sort(parity_env):
    """relative_error 2e-4 asks for k = 11,499: over 6,000-row chunks (under
    64 rows a target) that op sorts on a resident scan while the default
    sketch selects; over chunks of 64 rows a target it would select."""
    analyzers = [port_analyzers.ApproxQuantile("c0", 0.5, relative_error=2e-4),
                 port_analyzers.ApproxQuantile("c1", 0.5)]
    with use_device("cpu"):
        table = _two_col_table().persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        PortRunner.do_analysis_run(table, analyzers)
        table.unpersist()
    assert SCAN_STATS.device_sort_passes == 1 and SCAN_STATS.device_select_passes == 1
    ops = [a.scan_op(table) for a in analyzers]
    assert [op.select_size for op in ops] == [11_499, 256]
    assert plan_scan_ops(ops, None, resident=True, chunk_rows=6000).select_ops == 1
    assert plan_scan_ops(ops, None, resident=True, chunk_rows=64 * 11_501).select_ops == 2


@pytest.mark.parametrize("bad", ["1", 2, 0.5, "yes", None])
def test_select_kernel_validation(bad):
    if bad is None:
        assert select_kernel_enabled(None) is True
        return
    with pytest.raises(ValueError):
        select_kernel_enabled(bad)
    with pytest.raises(ValueError):
        plan_scan_ops([], None, resident=False, select_kernel=bad)
    assert select_kernel_enabled(False) is False and select_kernel_enabled(1) is True


# -- against the reference ----------------------------------------------------

CHUNK = 2500
ROWS = 7000


def _ref_quantile_table(seed=5):
    rng = np.random.default_rng(seed)
    f = rng.normal(10, 3, ROWS)
    f[rng.integers(0, ROWS, 20)] = -0.0
    return [
        ref_column("f", "fractional", f, rng.random(ROWS) > 0.03),
        ref_column("i", "integral", rng.integers(-1000, 1000, ROWS), np.ones(ROWS, bool)),
        ref_column("g", "fractional", np.round(rng.normal(0, 5, ROWS), 2),
                   rng.random(ROWS) > 0.5),
    ]


def _quantile_specs(pkg):
    return [pkg.ApproxQuantile("f", 0.5), pkg.ApproxQuantile("i", 0.9),
            pkg.ApproxQuantiles("g", (0.1, 0.5, 0.9)), pkg.KLLSketch("f"),
            pkg.ApproxQuantile("f", 0.25, where="i > 0")]


def _persisted_states(monkeypatch, mode):
    """(reference KLL states, port KLL states) of persisted runs over the
    same table in CHUNK-row chunks."""
    from deequ_tpu.data.table import ColumnarTable as RefTable

    if mode == "f64":
        monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    monkeypatch.setattr(ref_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: CHUNK)
    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: CHUNK)
    ref = RefTable(_ref_quantile_table())
    port = port_table(ref)
    ref_list, port_list = _quantile_specs(ref_analyzers), _quantile_specs(port_analyzers)
    with use_mesh(None):
        ref.persist()
        ref_scan_engine.SCAN_STATS.reset()
        ref_states = _states(RefRunner, ref, ref_list)
        ref_select = ref_scan_engine.SCAN_STATS.device_select_passes
        ref.unpersist()
    with use_device("cpu"):
        port.persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        port_states = _states(PortRunner, port, port_list)
        assert SCAN_STATS.device_select_passes > 0 and SCAN_STATS.device_sort_passes == 0
        assert SCAN_STATS.chunks_processed == -(-ROWS // CHUNK)
        port.unpersist()
    return ref_states, port_states, ref_select


def _states(runner, table, analyzers):
    """Each analyzer's KLL state from one fused scan."""
    ops = [a.scan_op(table) for a in analyzers]
    exec_ops, plan = runner._coalesce_scan_ops(ops)
    if runner is PortRunner:
        results = run_scan(table, exec_ops, "cpu")
    else:
        from deequ_tpu.ops.scan_engine import run_scan as ref_run_scan

        results = ref_run_scan(table, exec_ops)
    out = []
    for a, (i, ex) in zip(analyzers, plan):
        res = results[i] if ex is None else ex(results[i])
        out.append(a.state_from_scan_result(res))
    return out


def test_persisted_states_equal_reference_f64(parity_env, monkeypatch):
    """The reference keeps wide-f64 columns on the sort; the port selects.
    Same chunks, bit-identical folded states."""
    ref_states, port_states, ref_select = _persisted_states(monkeypatch, "f64")
    assert ref_select == 0
    for r, p in zip(ref_states, port_states):
        assert (p.global_min, p.global_max) == (r.global_min, r.global_max)
        assert (p.sketch.count, p.sketch.rng_count) == (r.sketch.count, r.sketch.rng_count)
        assert len(p.sketch.compactors) == len(r.sketch.compactors)
        for a, b in zip(p.sketch.compactors, r.sketch.compactors):
            assert np.array_equal(_bits(a), _bits(b))


def test_persisted_states_within_rank_error_of_reference_pairs(parity_env, monkeypatch):
    """Against the reference's own select on its (hi, lo) pair planes: each
    quantile within the sketch's rank error (relative_error 0.01) of the
    reference's, measured as ranks in the column's valid values."""
    from deequ_tpu.data.table import ColumnarTable as RefTable

    ref_states, port_states, ref_select = _persisted_states(monkeypatch, "pairs")
    assert ref_select > 0
    table = RefTable(_ref_quantile_table())
    columns = ["f", "i", "g", "f"]
    for r, p, col in zip(ref_states[:4], port_states[:4], columns):
        c = table[col]
        s = np.sort(c.values[c.mask])
        for q in (0.1, 0.25, 0.5, 0.75, 0.9):
            ranks = [np.searchsorted(s, st.sketch.quantile(q)) for st in (r, p)]
            assert abs(ranks[0] - ranks[1]) <= 2 * 0.01 * len(s), (col, q, ranks)
