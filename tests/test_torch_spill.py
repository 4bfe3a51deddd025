"""The port's spill engine (``deequ_tpu_torch/spill``) on the CPU: twins of
the 20 tests of tests/test_spill.py, and parity with the reference's
engine (``deequ_tpu/spill``).

- Twins: run files (round trip, bad magic), the canonical key order and
  its three implementations agreeing, the k-way merge, the store (plain
  state when nothing spills, exact spilled merges, the monoid, refused
  mixed key kinds, int/float promotion, a frequencies-only analyzer over
  a spilled state), tag-13 serde, the randomized spill-against-in-memory
  sweep, a budgeted in-memory table, the count-statistics route that a
  budget must not degrade, the RSS regression in a subprocess (not slow
  here: 4·10^5 rows take seconds on the port), num_rows kept through a
  re-spill, the commutative plain + spilled sum, and the cascade that
  collapses once.
- Parity: the same deltas into both packages' stores give the same merged
  blocks, and the same block bytes; a tag-13 payload written by either
  package decodes in the other to equal frequencies; a budgeted run of
  one suite gives the same metrics in both packages (counts and
  Histograms exact, entropy and mutual information within 1e-12, the
  bound of docs/numerics.md).
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu.spill as ref_spill
import deequ_tpu.states.serde as ref_serde
from deequ_tpu.analyzers.grouping import FrequenciesAndNumRows as RefFreq
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.streaming import stream_table as ref_stream_table
from deequ_tpu.spill.runs import encode_block as ref_encode_block
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import (
    CountDistinct,
    Distinctness,
    Entropy,
    Histogram,
    MutualInformation,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.streaming import stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.spill import SpilledFrequencies, SpillingFrequencyStore
from deequ_tpu_torch.spill.merge import merge_block_streams
from deequ_tpu_torch.spill.order import (
    canonical_order,
    compare_keys,
    leq_boundary,
    merge_add_sorted,
)
from deequ_tpu_torch.spill.runs import RunReader, RunWriter, encode_block
from deequ_tpu_torch.states import InMemoryStateProvider
from deequ_tpu_torch.states.serde import deserialize_state, serialize_state
from torch_parity import assert_metric_parity, parity_env, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _freq(columns, mapping, num_rows):
    return FrequenciesAndNumRows.from_dict(tuple(columns), mapping, num_rows)


# -- run files ---------------------------------------------------------------


def test_run_writer_reader_round_trip(tmp_path):
    path = str(tmp_path / "a.run")
    kv = (np.array(["a", "b", "c"]), np.array([1, 2, 3], dtype=np.int64))
    kn = (np.array([True, False, False]), np.array([False, False, True]))
    counts = np.array([5, 1, 2], dtype=np.int64)
    w = RunWriter(path, 2)
    w.write_block(kv, kn, counts)
    w.write_block((kv[0][:1], kv[1][:1]), (kn[0][:1], kn[1][:1]), counts[:1])
    w.close()
    r = RunReader(path)
    blocks = list(r.blocks())
    assert len(blocks) == 2
    (bkv, bkn, bcounts) = blocks[0]
    assert bcounts.tolist() == [5, 1, 2]
    assert bkv[0].tolist() == ["a", "b", "c"]
    assert bkn[0].tolist() == [True, False, False]
    assert bkv[1].tolist() == [1, 2, 3]
    assert r.bytes_read > 0


def test_run_reader_rejects_bad_magic(tmp_path):
    path = str(tmp_path / "bad.run")
    with open(path, "wb") as f:
        f.write(b"NOPE" + struct.pack("<HH", 1, 1))
    with pytest.raises(ValueError, match="bad magic"):
        RunReader(path)


# -- canonical order and boundary compares -----------------------------------


def test_canonical_order_null_first_nan_last():
    values = np.array([3.0, np.nan, 1.0, 2.0, np.nan])
    nulls = np.array([False, False, False, True, False])
    order = canonical_order([values], [nulls])
    assert order[0] == 3  # the null row
    assert values[order[1]] == 1.0
    assert values[order[2]] == 3.0
    assert np.isnan(values[order[3]]) and np.isnan(values[order[4]])


def test_compare_keys_and_leq_boundary_agree():
    rng = np.random.default_rng(7)
    pool = [None, float("nan"), -1.5, 0.0, 2.0, 7.25]
    cells = [pool[i] for i in rng.choice(len(pool), size=40)]
    nulls = np.array([c is None for c in cells])
    values = np.array([0.0 if c is None else c for c in cells], dtype=np.float64)
    for b in pool:
        mask = leq_boundary([values], [nulls], (b,))
        for i in range(len(cells)):
            assert mask[i] == (compare_keys((cells[i],), (b,)) <= 0), (cells[i], b)


def test_merge_add_sorted_merges_duplicates():
    a = ((np.array([1, 2], dtype=np.int64),), (np.zeros(2, bool),),
         np.array([3, 4], dtype=np.int64))
    b = ((np.array([2, 5], dtype=np.int64),), (np.zeros(2, bool),),
         np.array([10, 1], dtype=np.int64))
    kv, kn, counts = merge_add_sorted([a, b])
    assert kv[0].tolist() == [1, 2, 5]
    assert counts.tolist() == [3, 14, 1]


def _blocks_of(pairs):
    for keys, counts in pairs:
        yield ((np.asarray(keys, dtype=np.int64),), (np.zeros(len(keys), bool),),
               np.asarray(counts, dtype=np.int64))


def test_merge_block_streams_globally_unique_and_sorted():
    s1 = _blocks_of([([1, 3, 5], [1, 1, 1]), ([7, 9], [1, 1])])
    s2 = _blocks_of([([2, 3], [5, 5]), ([8, 9, 10], [5, 5, 5])])
    merged = list(merge_block_streams([s1, s2], out_groups=4))
    keys = np.concatenate([b[0][0] for b in merged])
    counts = np.concatenate([b[2] for b in merged])
    assert keys.tolist() == [1, 2, 3, 5, 7, 8, 9, 10]
    assert counts.tolist() == [1, 5, 6, 1, 1, 5, 6, 5]
    assert max(len(b[2]) for b in merged) <= 4


# -- the store ---------------------------------------------------------------


def test_store_returns_plain_state_when_nothing_spills():
    store = SpillingFrequencyStore(("a",), budget_bytes=1 << 30)
    store.add(_freq(["a"], {("x",): 1, ("y",): 2}, 3))
    out = store.result()
    assert isinstance(out, FrequenciesAndNumRows)
    assert out.as_dict() == {("x",): 1, ("y",): 2}


def test_store_spills_and_merges_exactly():
    store = SpillingFrequencyStore(("a",), budget_bytes=2048)
    expect, num_rows = {}, 0
    rng = np.random.default_rng(3)
    for _ in range(30):
        batch = {(f"k{int(k):04d}",): int(c)
                 for k, c in zip(rng.integers(0, 500, 40), rng.integers(1, 9, 40))}
        for g, c in batch.items():
            expect[g] = expect.get(g, 0) + c
        rows = sum(batch.values())
        num_rows += rows
        store.add(_freq(["a"], batch, rows))
    out = store.result()
    assert isinstance(out, SpilledFrequencies)
    assert SCAN_STATS.spill_runs > 1
    assert out.num_rows == num_rows
    assert out.as_dict() == expect
    seen = [k for kv, _, _ in out.blocks() for k in kv[0].tolist()]
    assert seen == sorted(seen)
    assert len(seen) == len(set(seen)) == len(expect)


def test_spilled_state_is_still_a_monoid():
    store = SpillingFrequencyStore(("a",), budget_bytes=1024)
    for i in range(20):
        store.add(_freq(["a"], {(f"k{i:03d}",): 1, ("shared",): 2}, 3))
    spilled = store.result()
    assert isinstance(spilled, SpilledFrequencies)
    merged = spilled.sum(_freq(["a"], {("shared",): 5, ("new",): 1}, 6))
    d = merged.as_dict()
    assert d[("shared",)] == 45
    assert d[("new",)] == 1
    assert merged.num_rows == 66
    assert isinstance(merged, SpilledFrequencies)
    assert spilled.sum(merged).as_dict()[("shared",)] == 85


def test_store_refuses_mixed_key_kinds():
    store = SpillingFrequencyStore(("a",), budget_bytes=1 << 20)
    store.add(_freq(["a"], {("x",): 1}, 1))
    with pytest.raises(ValueError, match="mismatched"):
        store.add(_freq(["a"], {(5,): 1}, 1))


def test_store_promotes_int_float_like_sum():
    store = SpillingFrequencyStore(("a",), budget_bytes=512)
    for i in range(40):
        store.add(_freq(["a"], {(i,): 1}, 1))
    store.add(_freq(["a"], {(0.5,): 2}, 2))
    out = store.result()
    d = out.as_dict()
    assert d[(0.5,)] == 2
    assert d[(0.0,)] == 1  # int 0 promoted into the float key space
    assert out.num_rows == 42
    big = SpillingFrequencyStore(("a",), budget_bytes=1 << 20)
    big.add(_freq(["a"], {(2 ** 60,): 1}, 1))
    with pytest.raises(ValueError, match="2\\^53"):
        big.add(_freq(["a"], {(0.5,): 1}, 1))


def test_spilled_state_falls_back_for_frequencies_only_subclass():
    """An analyzer implementing only compute_from_frequencies still
    computes over a spilled state: the count-statistics route needs an
    explicit override, so its NotImplementedError is never swallowed."""
    from deequ_tpu_torch.analyzers.grouping import ScanShareableFrequencyBasedAnalyzer

    class MaxCount(ScanShareableFrequencyBasedAnalyzer):
        metric_name = "MaxCount"

        @property
        def group_columns(self):
            return ["a"]

        def compute_from_frequencies(self, state):
            return float(state.counts.max())

    store = SpillingFrequencyStore(("a",), budget_bytes=512)
    for i in range(64):
        store.add(_freq(["a"], {(f"k{i:03d}",): i + 1}, i + 1))
    out = store.result()
    assert isinstance(out, SpilledFrequencies)
    assert MaxCount().compute_metric_from(out).value.get() == 64.0


# -- serde -------------------------------------------------------------------


def _two_column_spill(rng, budget=1024):
    store = SpillingFrequencyStore(("a", "b"), budget_bytes=budget)
    expect, rows = {}, 0
    for _ in range(15):
        batch = {}
        for k in rng.integers(0, 50, 20):
            g = (f"s{int(k)}", int(k) % 7)
            batch[g] = batch.get(g, 0) + 1
        for g, c in batch.items():
            expect[g] = expect.get(g, 0) + c
        n = sum(batch.values())
        rows += n
        store.add(_freq(["a", "b"], batch, n))
    return store.result(), expect, rows


def test_spilled_state_serde_round_trip():
    spilled, expect, rows = _two_column_spill(np.random.default_rng(11))
    assert isinstance(spilled, SpilledFrequencies)
    back = deserialize_state(serialize_state(spilled))
    assert isinstance(back, SpilledFrequencies)
    assert back.num_rows == rows
    assert back.as_dict() == expect
    got = Uniqueness(("a", "b")).compute_metric_from(back)
    want = Uniqueness(("a", "b")).compute_metric_from(spilled.to_frequencies())
    assert got.value.get() == want.value.get()


# -- randomized equivalence sweep: spill against in memory -------------------


def _fresh_table(rng, n):
    """Fresh Column objects per draw (no shared dictionaries or caches)."""
    card = max(4, int(n * rng.uniform(0.05, 0.9)))
    keys = rng.integers(0, card, n)
    uniq, codes = np.unique(keys, return_inverse=True)
    dic = np.char.add("v_", uniq.astype("U8")).astype(object)
    scol = Column("s", DType.STRING, codes=codes.astype(np.int32), dictionary=dic)
    ints = rng.integers(0, max(2, card // 3), n).astype(np.int64)
    mask = rng.random(n) > 0.05
    icol = Column("i", DType.INTEGRAL, values=ints, mask=mask)
    return ColumnarTable([scol, icol])


SWEEP_ANALYZERS = [
    Uniqueness(("s",)),
    Uniqueness(("s", "i")),
    UniqueValueRatio(("i",)),
    Distinctness(("s",)),
    CountDistinct(("s", "i")),
    Entropy("s"),
    Histogram("s", max_detail_bins=17),
    MutualInformation(("s", "i")),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spill_vs_in_ram_equivalence_sweep(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(3_000, 12_000))
    table = _fresh_table(rng, n)
    ref = AnalysisRunner.do_analysis_run(
        table, SWEEP_ANALYZERS, save_states_with=InMemoryStateProvider())
    SCAN_STATS.reset()
    got = AnalysisRunner.do_analysis_run(
        stream_table(table, 1500), SWEEP_ANALYZERS,
        save_states_with=InMemoryStateProvider(), group_memory_budget=48 << 10)
    assert SCAN_STATS.spill_runs >= 1, "a budget small enough to spill"
    for a in SWEEP_ANALYZERS:
        vr, vg = ref.metric_map[a].value.get(), got.metric_map[a].value.get()
        if isinstance(a, Histogram):
            assert vg.number_of_bins == vr.number_of_bins
            assert vg.values == vr.values
        elif isinstance(a, (Entropy, MutualInformation)):
            assert vg == pytest.approx(vr, rel=1e-12), a
        else:
            assert vg == vr, a  # count-derived: exact


def test_in_memory_table_budget_matches_unbounded():
    table = _fresh_table(np.random.default_rng(5), 90_000)
    analyzers = [Uniqueness(("s", "i")), Histogram("s")]
    ref = AnalysisRunner.do_analysis_run(table, analyzers,
                                         save_states_with=InMemoryStateProvider())
    SCAN_STATS.reset()
    got = (AnalysisRunner.on_data(table).add_analyzers(analyzers)
           .save_states_with(InMemoryStateProvider())
           .with_group_memory_budget(32 << 10).run())
    assert SCAN_STATS.spill_runs >= 1  # past budget_batch_rows: the sliced fold
    u, h = analyzers
    assert got.metric_map[u].value.get() == ref.metric_map[u].value.get()
    assert got.metric_map[h].value.get().values == ref.metric_map[h].value.get().values


def test_count_stats_fast_path_not_degraded_by_budget():
    """No saved states and count-statistics analyzers: the count route runs
    (no spill run, no frequency table) whatever the budget."""
    table = _fresh_table(np.random.default_rng(6), 20_000)
    ctx = AnalysisRunner.do_analysis_run(table, [Uniqueness(("s",))],
                                         group_memory_budget=1 << 10)
    assert SCAN_STATS.spill_runs == 0
    assert ctx.metric_map[Uniqueness(("s",))].value.is_success


# -- RSS budget regression (a subprocess, for a clean ru_maxrss) --------------

_RSS_CHILD = r"""
import json, resource, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import Histogram, Uniqueness
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.streaming import stream_table
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.states import InMemoryStateProvider

n, budget = int(sys.argv[1]), int(sys.argv[2])
rng = np.random.default_rng(42)
keys = rng.integers(0, n // 2, n)
uniq, codes = np.unique(keys, return_inverse=True)
dic = np.char.add("id_", np.char.zfill(uniq.astype("U9"), 9)).astype(object)
table = ColumnarTable([Column("key", DType.STRING, codes=codes.astype(np.int32), dictionary=dic)])
analyzers = [Uniqueness(("key",)), Histogram("key", max_detail_bins=100)]
base_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
with use_device("cpu"):
    ctx = AnalysisRunner.do_analysis_run(
        stream_table(table, max(n // 20, 1)), analyzers,
        save_states_with=InMemoryStateProvider(), group_memory_budget=budget)
h = ctx.metric_map[analyzers[1]].value.get()
print(json.dumps({
    "uniqueness": ctx.metric_map[analyzers[0]].value.get(),
    "bins": h.number_of_bins,
    "top": sorted(((k, v.absolute) for k, v in h.values.items()), key=lambda t: t[0]),
    "base_rss_kb": base_kb,
    "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    "spill_runs": SCAN_STATS.spill_runs,
    "peak_group_state_bytes": SCAN_STATS.peak_group_state_bytes,
}))
"""


def test_rss_budget_regression_subprocess(tmp_path):
    """A high-cardinality grouping under a hard budget, in a child process:
    the in-memory grouping tail stays within the budget, the child's
    peak RSS within a bound, and the metrics equal the in-memory route
    (computed in this process, whose RSS is not under test)."""
    n, budget = 400_000, 4 << 20
    script = str(tmp_path / "child.py")
    with open(script, "w") as f:
        f.write(_RSS_CHILD)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, script, str(n), str(budget)],
                         capture_output=True, text=True, env=env, cwd=repo_root,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["spill_runs"] >= 1
    assert got["peak_group_state_bytes"] <= budget
    # the torch runtime dominates the base; the run may add a few budgets
    assert got["peak_rss_kb"] - got["base_rss_kb"] <= 400 * 1024, got

    rng = np.random.default_rng(42)
    keys = rng.integers(0, n // 2, n)
    uniq, codes = np.unique(keys, return_inverse=True)
    dic = np.char.add("id_", np.char.zfill(uniq.astype("U9"), 9)).astype(object)
    table = ColumnarTable([Column("key", DType.STRING, codes=codes.astype(np.int32),
                                  dictionary=dic)])
    analyzers = [Uniqueness(("key",)), Histogram("key", max_detail_bins=100)]
    ref = AnalysisRunner.do_analysis_run(table, analyzers,
                                         save_states_with=InMemoryStateProvider())
    assert got["uniqueness"] == ref.metric_map[analyzers[0]].value.get()
    h = ref.metric_map[analyzers[1]].value.get()
    assert got["bins"] == h.number_of_bins
    assert got["top"] == [list(t) for t in sorted(
        ((k, v.absolute) for k, v in h.values.items()), key=lambda t: t[0])]


def test_respilled_state_under_large_budget_keeps_num_rows():
    """An already-spilled state folded into a store whose budget keeps it
    in memory keeps its rows: its blocks carry num_rows = 0 (the store
    counts them), so result() adds them back to the plain state."""
    small = SpillingFrequencyStore(("a",), budget_bytes=1024)
    for i in range(20):
        small.add(_freq(["a"], {(f"k{i:03d}",): 1, ("shared",): 2}, 3))
    spilled = small.result()
    assert isinstance(spilled, SpilledFrequencies)
    assert spilled.num_rows == 60
    big = SpillingFrequencyStore(("a",), budget_bytes=1 << 30)
    big.add(spilled, canonical=True)
    big.add(_freq(["a"], {("shared",): 5}, 5))
    out = big.result()
    assert isinstance(out, FrequenciesAndNumRows)  # nothing spilled again
    assert out.num_rows == 65
    assert out.as_dict()[("shared",)] == 45
    big2 = SpillingFrequencyStore(("a",), budget_bytes=1 << 30)
    big2.add(spilled, canonical=True)
    out2 = big2.result()
    assert out2.num_rows == 60
    assert out2.as_dict() == spilled.as_dict()


def test_plain_sum_spilled_delegates_commutatively():
    store = SpillingFrequencyStore(("a",), budget_bytes=1024)
    for i in range(20):
        store.add(_freq(["a"], {(f"k{i:03d}",): 1, ("shared",): 2}, 3))
    spilled = store.result()
    assert isinstance(spilled, SpilledFrequencies)
    plain = _freq(["a"], {("shared",): 5, ("new",): 1}, 6)
    m1, m2 = plain.sum(spilled), spilled.sum(plain)
    assert m1.as_dict() == m2.as_dict()
    assert m1.num_rows == m2.num_rows == 66
    assert m1.as_dict()[("shared",)] == 45


def test_blocks_cascade_collapses_once():
    """More runs than the merge fan-in: the disk cascade runs once, and
    later block consumers reuse the collapsed run set."""
    store = SpillingFrequencyStore(("a",), budget_bytes=700)
    expect, rows = {}, 0
    for i in range(300):
        batch = {(f"k{i % 97:03d}",): 1, (f"j{i:04d}",): 2}
        for g, c in batch.items():
            expect[g] = expect.get(g, 0) + c
        rows += 3
        store.add(_freq(["a"], batch, 3))
    out = store.result()
    assert isinstance(out, SpilledFrequencies)
    assert len(store._run_paths) > store._max_fanin()
    assert out.as_dict() == expect  # the first pass runs the cascade
    collapsed = list(store._run_paths)
    assert len(collapsed) <= store._max_fanin()
    SCAN_STATS.reset()
    assert out.as_dict() == expect  # the second: no new cascade
    assert store._run_paths == collapsed
    assert SCAN_STATS.spill_bytes_written == 0
    assert SCAN_STATS.spill_merge_passes == 0
    assert out.num_rows == rows


# -- parity with the reference ------------------------------------------------


def _delta_stream(seed: int, batches: int = 24):
    """Frequency deltas over (str, int-with-nulls, float-with-NaN-and-±0)
    keys, as (columns, key arrays, null masks, counts, rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        g = int(rng.integers(20, 80))
        s = np.array([f"k{int(v):03d}" for v in rng.integers(0, 120, g)])
        i = rng.integers(-5, 40, g).astype(np.int64)
        f = rng.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 1e300]), g)
        kv = (s, i, f)
        kn = (rng.random(g) < 0.1, rng.random(g) < 0.1, rng.random(g) < 0.05)
        counts = rng.integers(1, 9, g).astype(np.int64)
        out.append((kv, kn, counts, int(counts.sum())))
    return out


def _both_states(kv, kn, counts, rows):
    cols = ("s", "i", "f")
    return (RefFreq(cols, kv, kn, counts, rows),
            FrequenciesAndNumRows(cols, kv, kn, counts, rows))


@pytest.mark.parametrize("seed", [0, 1])
def test_same_deltas_give_the_references_blocks_and_bytes(seed):
    """The same deltas into both packages' stores (each sorted and merged
    by its own code) give the same merged blocks, and each block the same
    encoded bytes; NaN keys sort last and -0.0 folds with 0.0 alike."""
    ref_store = ref_spill.SpillingFrequencyStore(("s", "i", "f"), budget_bytes=4096)
    port_store = SpillingFrequencyStore(("s", "i", "f"), budget_bytes=4096)
    for kv, kn, counts, rows in _delta_stream(seed):
        ref_state, port_state = _both_states(kv, kn, counts, rows)
        ref_store.add(ref_state)
        port_store.add(port_state)
    ref_out, port_out = ref_store.result(), port_store.result()
    assert isinstance(port_out, SpilledFrequencies)
    assert isinstance(ref_out, ref_spill.SpilledFrequencies)
    assert port_out.num_rows == ref_out.num_rows
    ref_blocks = list(ref_out.blocks(out_groups=64))
    port_blocks = list(port_out.blocks(out_groups=64))
    assert len(ref_blocks) == len(port_blocks) > 1
    for (rkv, rkn, rc), (pkv, pkn, pc) in zip(ref_blocks, port_blocks):
        assert np.array_equal(rc, pc)
        for a, b in zip(rkn, pkn):
            assert np.array_equal(a, b)
        for a, b in zip(rkv, pkv):
            assert a.dtype == b.dtype
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        assert encode_block(pkv, pkn, pc) == ref_encode_block(rkv, rkn, rc)
    ref_out._store.release()
    port_out._store.release()


def test_float_keys_nan_last_and_signed_zero_fold_as_the_reference():
    """One float key column: NaN keys sort last and fold into one group
    (which decodes to the port's one shared NaN key), -0.0 and 0.0 fold
    into one group as numpy's unique folds them — the same blocks, bit for
    bit, in both packages."""
    rng = np.random.default_rng(4)
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 7.0])
    ref_store = ref_spill.SpillingFrequencyStore(("f",), budget_bytes=256)
    port_store = SpillingFrequencyStore(("f",), budget_bytes=256)
    for _ in range(12):
        f = rng.choice(pool, 6)
        kn = rng.random(6) < 0.2
        counts = np.ones(6, dtype=np.int64)
        ref_store.add(RefFreq(("f",), (f,), (kn,), counts, 6))
        port_store.add(FrequenciesAndNumRows(("f",), (f,), (kn,), counts, 6))
    ref_out, port_out = ref_store.result(), port_store.result()
    assert isinstance(port_out, SpilledFrequencies)
    port_blocks, ref_blocks = list(port_out.blocks()), list(ref_out.blocks())
    assert len(port_blocks) == len(ref_blocks)
    for p, r in zip(port_blocks, ref_blocks):
        assert encode_block(*p) == ref_encode_block(*r)
    pkv = (np.concatenate([b[0][0] for b in port_blocks]),)
    pkn = (np.concatenate([b[1][0] for b in port_blocks]),)
    pc = np.concatenate([b[2] for b in port_blocks])
    values = pkv[0][~pkn[0]]
    assert np.isnan(values[-1]) and not np.isnan(values[:-1]).any()
    assert int((values == 0.0).sum()) == 1  # -0.0 and 0.0: one group
    assert int(pc.sum()) == 72
    nan_keys = [k for k in port_out.as_dict() if k[0] is not None and k[0] != k[0]]
    assert len(nan_keys) == 1
    from deequ_tpu_torch.analyzers.grouping import _CANONICAL_NAN

    assert nan_keys[0][0] is _CANONICAL_NAN


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tag13_payload_crosses_packages(writer):
    """A spilled state serialised by either package decodes in the other to
    a disk-backed state with equal frequencies and rows; re-encoding it
    gives the writer's bytes back."""
    rng = np.random.default_rng(13)
    ref_store = ref_spill.SpillingFrequencyStore(("s", "i", "f"), budget_bytes=2048)
    port_store = SpillingFrequencyStore(("s", "i", "f"), budget_bytes=2048)
    for kv, kn, counts, rows in _delta_stream(21, batches=16):
        ref_state, port_state = _both_states(kv, kn, counts, rows)
        ref_store.add(ref_state)
        port_store.add(port_state)
    ref_out, port_out = ref_store.result(), port_store.result()
    if writer == "reference":
        blob = ref_serde.serialize_state(ref_out)
        back = deserialize_state(blob)
        assert isinstance(back, SpilledFrequencies)
        assert serialize_state(back) == blob
    else:
        blob = serialize_state(port_out)
        back = ref_serde.deserialize_state(blob)
        assert isinstance(back, ref_spill.SpilledFrequencies)
        assert ref_serde.serialize_state(back) == blob
    assert back.num_rows == ref_out.num_rows == port_out.num_rows
    want = ref_out.to_frequencies()
    got = back.to_frequencies()
    assert np.array_equal(got.counts, want.counts)
    for a, b in zip(got.key_values, want.key_values):
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    del rng


def _ref_sweep_table(rng, n):
    card = max(4, int(n * 0.4))
    keys = rng.integers(0, card, n)
    uniq, codes = np.unique(keys, return_inverse=True)
    dic = np.char.add("v_", uniq.astype("U8")).astype(object)
    ints = rng.integers(0, max(2, card // 3), n).astype(np.int64)
    mask = rng.random(n) > 0.05
    return [
        ref_column("s", "string", codes=codes.astype(np.int32), dictionary=dic),
        ref_column("i", "integral", ints, mask),
    ]


def test_budgeted_run_matches_the_reference(parity_env):
    """One suite over one stream under one spilling budget in both
    packages: count metrics and Histograms exact, Entropy and
    MutualInformation within 1e-12 (docs/numerics.md)."""
    from deequ_tpu.data.table import ColumnarTable as RefTable
    from deequ_tpu.parallel.mesh import use_mesh
    from torch_parity import port_table

    rng = np.random.default_rng(77)
    ref_t = RefTable(_ref_sweep_table(rng, 9_000))
    port_t = port_table(ref_t)
    ref_as = [
        ref_analyzers.Uniqueness(("s",)),
        ref_analyzers.Uniqueness(("s", "i")),
        ref_analyzers.UniqueValueRatio(("i",)),
        ref_analyzers.Distinctness(("s",)),
        ref_analyzers.CountDistinct(("s", "i")),
        ref_analyzers.Entropy("s"),
        ref_analyzers.Histogram("s", max_detail_bins=17),
        ref_analyzers.MutualInformation(("s", "i")),
    ]
    with use_mesh(None):
        ref = RefRunner.do_analysis_run(ref_stream_table(ref_t, 1500), ref_as,
                                        group_memory_budget=48 << 10)
    SCAN_STATS.reset()
    port = AnalysisRunner.do_analysis_run(stream_table(port_t, 1500), SWEEP_ANALYZERS,
                                          group_memory_budget=48 << 10)
    assert SCAN_STATS.spill_runs >= 1
    for a, ra in zip(SWEEP_ANALYZERS, ref_as):
        if isinstance(a, Histogram):
            want, got = ref.metric_map[ra].value.get(), port.metric_map[a].value.get()
            assert got.number_of_bins == want.number_of_bins
            assert {k: (v.absolute, v.ratio) for k, v in got.values.items()} == \
                {k: (v.absolute, v.ratio) for k, v in want.values.items()}
        else:
            assert_metric_parity(ref.metric_map[ra], port.metric_map[a])
