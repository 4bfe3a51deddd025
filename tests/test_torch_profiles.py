"""The port's column profiler and constraint suggestion
(``deequ_tpu_torch/profiles``, ``deequ_tpu_torch/suggestions``) against the
reference's on the CPU: the twins of the 8 tests of tests/test_profiles.py,
and more.

The same table goes through both packages; the reference runs on one
device (``use_mesh(None)``). Its profiler persists the table, the port's
streams on the CPU (a host table needs no copy; on a card it persists).
Held to:

- the port's profile against numpy: size, completeness, min/max and
  histograms exact; sum and mean within 1e-12 relative, standard deviation
  within 1e-10;
- the port's profile against the reference's under
  ``DEEQU_TPU_COMPUTE=f64`` (the reference exact): completeness,
  approximate distinct counts, types, type counts, histograms, min/max and
  KLL buckets and percentiles identical; sums and moments within
  ``torch_parity.REL_BOUNDS``. Under the reference's default (hi, lo) f32
  pairs, which ROADMAP queue 3 records as less exact: min/max within
  2^-48 relative, each KLL percentile within the sketch's rank error;
- ``ColumnProfiles.to_json`` parsed field by field under the same bounds,
  every other field as text; suggestion strings and code, and the
  held-out evaluation's statuses, identical as text;
- profile metrics saved by one package into a filesystem or columnar
  repository and reused by the other give the saving package's profile
  exactly;
- the profiler keeps its tables resident only where the device has a
  resident budget, streams on the same device after the budget's
  ``MemoryError`` or an out-of-memory error, and lets any other failure
  of ``persist()`` raise.
"""

import json
import math

import numpy as np
import pytest
import torch

import deequ_tpu.profiles as ref_profiles
import deequ_tpu.repository as ref_repo
import deequ_tpu.suggestions as ref_suggestions
import deequ_tpu_torch.profiles as port_profiles
import deequ_tpu_torch.repository as port_repo
import deequ_tpu_torch.suggestions as port_suggestions
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers.scan import DataTypeInstances
from deequ_tpu_torch.data.table import DType
from deequ_tpu_torch.ops import scan_engine
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.profiles import NumericColumnProfile, StandardColumnProfile
from torch_parity import REL_BOUNDS, parity_env, port_table, smoke_schema_table  # noqa: F401

pytestmark = pytest.mark.torch_port

#: the reference's (hi, lo) f32 pairs hold a fractional min/max to ~48 bits
PAIR_EXTREMUM_REL = 2.0 ** -48
#: the KLL sketch's rank error at its default size, as a share of the rows
KLL_RANK_ERROR = 0.01
#: bounds of the profile's floating fields (PERF.md §2)
PROFILE_REL = {"mean": REL_BOUNDS["Mean"], "sum": REL_BOUNDS["Sum"],
               "std_dev": REL_BOUNDS["StandardDeviation"]}
JSON_REL = {"mean": REL_BOUNDS["Mean"], "sum": REL_BOUNDS["Sum"],
            "stdDev": REL_BOUNDS["StandardDeviation"]}


def _pydict(n=200):
    return {
        "id": list(range(n)),
        "name": [f"name_{i}" for i in range(n)],
        "status": ["active", "inactive"] * (n // 2),
        "score": [float(i % 50) for i in range(n)],
        "maybe": [None if i % 4 == 0 else f"{i % 3}" for i in range(n)],
    }


@pytest.fixture
def tables(parity_env):
    """(reference table, port table) holding the same arrays: the table of
    tests/test_profiles.py."""
    ref = RefTable.from_pydict(_pydict())
    return ref, port_table(ref)


def _seeded_tables(rows=3000, seed=5):
    """The chip-smoke schema at a small width, a low-cardinality integral
    column, and a zip-code column of numeric strings (1% null) that the
    profile infers integral and casts."""
    from torch_parity import ref_column

    ref = smoke_schema_table(rows, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 400, size=rows).astype(np.int32)
    codes[rng.random(rows) < 0.01] = -1
    zips = sorted(f"{z:05d}" for z in rng.choice(100_000, 400, replace=False))
    cols = list(ref.columns.values()) + [
        ref_column("zip", "string", codes=codes, dictionary=zips),
        ref_column("small", "integral", rng.integers(0, 30, size=rows).astype(np.int64),
                   rng.random(rows) >= 0.05),
    ]
    ref = RefTable(cols)
    return ref, port_table(ref)


def _ref_profile(builder_fn, ref_table, mode, monkeypatch):
    if mode == "f64":
        monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    with use_mesh(None):
        out = builder_fn(ref_profiles.ColumnProfilerRunner.on_data(ref_table)).run()
    monkeypatch.delenv("DEEQU_TPU_COMPUTE", raising=False)
    return out


def _port_profile(builder_fn, port_table_):
    with use_device("cpu"):
        return builder_fn(port_profiles.ColumnProfilerRunner.on_data(port_table_)).run()


def _close(a, b, rel) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return a == b if rel == 0.0 else abs(a - b) <= rel * max(abs(a), abs(b))


def _dist_items(dist):
    if dist is None:
        return None
    return dist.number_of_bins, {k: (v.absolute, v.ratio) for k, v in dist.values.items()}


def _column_values(table, name):
    """The valid values of a column as the profile sees them (a numeric
    string column cast the way ``data/cast.py`` casts it)."""
    col = table[name]
    if col.dtype != DType.STRING:
        return col.values[col.mask].astype(np.float64)
    def parse(v):
        try:
            return float(v)
        except ValueError:
            return math.nan

    lut = np.array([parse(v) for v in col.dictionary])
    values = lut[col.codes[col.codes >= 0]]
    return values[~np.isnan(values)]


def _buckets(kll):
    return [(b.low_value, b.high_value, b.count) for b in kll.buckets]


def _percentile_ranks_close(values, a, b) -> bool:
    s = np.sort(values)
    ra, rb = np.searchsorted(s, a), np.searchsorted(s, b)
    return bool(np.all(np.abs(ra - rb) <= 2 * KLL_RANK_ERROR * len(s)))


def assert_profiles_parity(ref, port, mode, table):
    """The port's profiles against the reference's (module doc)."""
    assert port.num_records == ref.num_records
    assert list(port.profiles) == list(ref.profiles)
    extremum_rel = 0.0 if mode == "f64" else PAIR_EXTREMUM_REL
    for name, r in ref.profiles.items():
        p = port.profiles[name]
        assert type(p).__name__ == type(r).__name__, name
        assert p.completeness == r.completeness, name
        assert p.approximate_num_distinct_values == r.approximate_num_distinct_values, name
        assert p.data_type.value == r.data_type.value, name
        assert p.is_data_type_inferred == r.is_data_type_inferred, name
        assert p.type_counts == r.type_counts, name
        assert _dist_items(p.histogram) == _dist_items(r.histogram), name
        if not isinstance(r, ref_profiles.NumericColumnProfile):
            continue
        for field, rel in PROFILE_REL.items():
            assert _close(getattr(p, field), getattr(r, field), rel), (name, field)
        for field in ("minimum", "maximum"):
            assert _close(getattr(p, field), getattr(r, field), extremum_rel), (name, field)
        assert (p.kll is None) == (r.kll is None), name
        if r.kll is None:
            continue
        if mode == "f64":
            assert _buckets(p.kll) == _buckets(r.kll), name
            assert p.kll.parameters == r.kll.parameters, name
            assert p.approx_percentiles == r.approx_percentiles, name
        else:
            assert _percentile_ranks_close(
                _column_values(table, name), r.approx_percentiles, p.approx_percentiles
            ), name


def assert_json_parity(ref_json, port_json, mode):
    """``to_json`` field by field: the floats from sums and moments within
    their bounds (min/max and percentiles as in assert_profiles_parity),
    every other field identical as text."""
    ref_cols = json.loads(ref_json)["columns"]
    port_cols = json.loads(port_json)["columns"]
    assert [c["column"] for c in port_cols] == [c["column"] for c in ref_cols]
    for r, p in zip(ref_cols, port_cols):
        assert set(p) == set(r), r["column"]
        for key, want in r.items():
            have = p[key]
            if key in JSON_REL:
                assert _close(have, want, JSON_REL[key]), (r["column"], key)
            elif mode != "f64" and key in ("minimum", "maximum"):
                assert _close(have, want, PAIR_EXTREMUM_REL), (r["column"], key)
            elif mode != "f64" and key == "approxPercentiles":
                assert len(have) == len(want)
            else:
                assert json.dumps(have) == json.dumps(want), (r["column"], key)


def assert_profile_matches_numpy(table, profiles):
    """The port's profile against numpy (module doc)."""
    n = table.num_rows
    assert profiles.num_records == n
    for name, p in profiles.profiles.items():
        col = table[name]
        assert p.completeness == float(col.mask.sum()) / n, name
        if isinstance(p, NumericColumnProfile):
            v = _column_values(table, name)
            assert p.minimum == float(v.min()) and p.maximum == float(v.max()), name
            assert _close(p.sum, float(v.sum()), PROFILE_REL["sum"]), name
            assert _close(p.mean, float(v.mean()), PROFILE_REL["mean"]), name
            assert _close(p.std_dev, float(v.std()), PROFILE_REL["std_dev"]), name
        if p.histogram is not None:
            if col.dtype == DType.STRING:
                keys = np.where(col.codes >= 0, col.dictionary[np.maximum(col.codes, 0)],
                                "NullValue").astype(str)
            else:
                keys = np.where(col.mask, col.values.astype(str), "NullValue")
            labels, counts = np.unique(keys, return_counts=True)
            want = {str(k): (int(c), int(c) / n) for k, c in zip(labels, counts)}
            assert {k: (v.absolute, v.ratio) for k, v in p.histogram.values.items()} == want


# -- twins of tests/test_profiles.py ------------------------------------------


def test_profiler_basic(tables, monkeypatch):
    ref_table, table = tables
    profiles = _port_profile(lambda b: b, table)
    assert profiles.num_records == 200

    id_profile = profiles.profiles["id"]
    assert isinstance(id_profile, NumericColumnProfile)
    assert id_profile.completeness == 1.0
    assert id_profile.data_type == DataTypeInstances.INTEGRAL
    assert not id_profile.is_data_type_inferred
    assert id_profile.minimum == 0.0
    assert id_profile.maximum == 199.0
    assert abs(id_profile.mean - 99.5) < 1e-9
    assert abs(id_profile.approximate_num_distinct_values - 200) < 30

    status = profiles.profiles["status"]
    assert isinstance(status, StandardColumnProfile)
    assert status.data_type == DataTypeInstances.STRING
    assert status.histogram is not None
    assert status.histogram["active"].absolute == 100

    maybe = profiles.profiles["maybe"]
    assert maybe.data_type == DataTypeInstances.INTEGRAL
    assert maybe.is_data_type_inferred
    assert isinstance(maybe, NumericColumnProfile)
    assert maybe.completeness == 0.75
    assert maybe.minimum == 0.0
    assert maybe.maximum == 2.0

    assert_profile_matches_numpy(table, profiles)
    ref = _ref_profile(lambda b: b, ref_table, "f64", monkeypatch)
    assert_profiles_parity(ref, profiles, "f64", table)


def test_profiler_restrict_columns(tables, monkeypatch):
    ref_table, table = tables
    build = lambda b: b.restrict_to_columns(["id", "status"])  # noqa: E731
    profiles = _port_profile(build, table)
    assert set(profiles.profiles) == {"id", "status"}
    assert_profiles_parity(_ref_profile(build, ref_table, "f64", monkeypatch), profiles,
                           "f64", table)
    with use_device("cpu"), pytest.raises(ValueError, match="Unable to find column"):
        port_profiles.ColumnProfilerRunner.on_data(table).restrict_to_columns(["nope"]).run()


def test_profiler_histogram_threshold(tables, monkeypatch):
    ref_table, table = tables
    build = lambda b: b.with_low_cardinality_histogram_threshold(1)  # noqa: E731
    profiles = _port_profile(build, table)
    assert profiles.profiles["status"].histogram is None
    assert_profiles_parity(_ref_profile(build, ref_table, "f64", monkeypatch), profiles,
                           "f64", table)


def test_profiler_kll(tables, monkeypatch):
    ref_table, table = tables
    build = lambda b: b.with_kll_profiling()  # noqa: E731
    profiles = _port_profile(build, table)
    score = profiles.profiles["score"]
    assert score.kll is not None
    assert len(score.approx_percentiles) == 100
    assert_profiles_parity(_ref_profile(build, ref_table, "f64", monkeypatch), profiles,
                           "f64", table)


def test_profiler_json(tables, monkeypatch):
    ref_table, table = tables
    profiles = _port_profile(lambda b: b, table)
    data = json.loads(profiles.to_json())
    assert len(data["columns"]) == 5
    ref = _ref_profile(lambda b: b, ref_table, "f64", monkeypatch)
    assert_json_parity(ref.to_json(), profiles.to_json(), "f64")


def _suggestion_rows(result):
    return [(str(s.constraint), s.column_name, s.current_value, s.description,
             repr(s.suggesting_rule), s.suggesting_rule.rule_description,
             s.code_for_constraint) for s in result.all_suggestions]


def _suggest(pkg, table, rules, split=None, mode="f64", monkeypatch=None):
    """One suggestion run of ``pkg`` (the reference under use_mesh(None)
    and, with mode "f64", DEEQU_TPU_COMPUTE=f64; the port on the CPU)."""
    builder = pkg.ConstraintSuggestionRunner.on_data(table)
    for rule in rules(pkg):
        builder = builder.add_constraint_rule(rule)
    if split is not None:
        builder = builder.use_train_test_split_with_test_set_ratio(*split)
    if pkg is port_suggestions:
        with use_device("cpu"):
            return builder.run()
    if mode == "f64":
        monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    with use_mesh(None):
        out = builder.run()
    monkeypatch.delenv("DEEQU_TPU_COMPUTE", raising=False)
    return out


def assert_suggestions_parity(ref, port):
    assert _suggestion_rows(port) == _suggestion_rows(ref)
    assert list(port.suggestions) == list(ref.suggestions)
    assert port.suggestions_as_json() == ref.suggestions_as_json()
    assert port.evaluation_as_json() == ref.evaluation_as_json()


def test_suggestions_default_rules(tables, monkeypatch):
    ref_table, table = tables
    default = lambda pkg: pkg.Rules.DEFAULT  # noqa: E731
    result = _suggest(port_suggestions, table, default)
    codes = [s.code_for_constraint for s in result.all_suggestions]
    assert '.is_complete("id")' in codes
    assert '.is_complete("status")' in codes
    assert any("is_contained_in" in c and "status" in c for c in codes)
    assert '.is_non_negative("id")' in codes
    assert any("has_completeness" in c and "maybe" in c for c in codes)
    assert any("has_data_type" in c and "maybe" in c for c in codes)
    assert_suggestions_parity(
        _suggest(ref_suggestions, ref_table, default, monkeypatch=monkeypatch), result)


def test_suggestions_unique_rule(tables, monkeypatch):
    ref_table, table = tables
    unique = lambda pkg: [pkg.UniqueIfApproximatelyUniqueRule()]  # noqa: E731
    result = _suggest(port_suggestions, table, unique)
    codes = [s.code_for_constraint for s in result.all_suggestions]
    assert '.is_unique("id")' in codes
    assert '.is_unique("name")' in codes
    assert not any("status" in c for c in codes)
    assert_suggestions_parity(
        _suggest(ref_suggestions, ref_table, unique, monkeypatch=monkeypatch), result)


def test_suggestions_with_train_test_evaluation(tables, monkeypatch):
    ref_table, table = tables
    default = lambda pkg: pkg.Rules.DEFAULT  # noqa: E731
    result = _suggest(port_suggestions, table, default, split=(0.3, 7))
    assert result.verification_result is not None
    assert result.verification_result.device == "cpu"
    evaluation = json.loads(result.evaluation_as_json())
    assert len(evaluation["constraint_suggestions"]) == len(result.all_suggestions)
    sugg = json.loads(result.suggestions_as_json())
    assert len(sugg["constraint_suggestions"]) == len(result.all_suggestions)
    assert_suggestions_parity(
        _suggest(ref_suggestions, ref_table, default, split=(0.3, 7),
                 monkeypatch=monkeypatch), result)


# -- beyond the twins ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["f64", "pairs"])
def test_profile_parity_seeded(parity_env, monkeypatch, mode):
    """A 3,000-row seeded table of the chip-smoke schema plus a numeric
    string column: the port's profile (KLL on) against numpy and the
    reference's, in both of the reference's compute modes."""
    ref_table, table = _seeded_tables()
    build = lambda b: b.with_kll_profiling()  # noqa: E731
    profiles = _port_profile(build, table)
    zip_profile = profiles.profiles["zip"]
    assert zip_profile.data_type == DataTypeInstances.INTEGRAL
    assert zip_profile.is_data_type_inferred and isinstance(zip_profile, NumericColumnProfile)
    assert profiles.profiles["small"].histogram is not None
    assert_profile_matches_numpy(table, profiles)
    ref = _ref_profile(build, ref_table, mode, monkeypatch)
    assert_profiles_parity(ref, profiles, mode, table)
    assert_json_parity(ref.to_json(), profiles.to_json(), mode)


def test_suggestions_parity_seeded(parity_env, monkeypatch):
    """Every rule over the seeded table, with a held-out tenth: the same
    suggestions, code and evaluation statuses as the reference's."""
    ref_table, table = _seeded_tables()
    rules = lambda pkg: pkg.Rules.DEFAULT + [pkg.UniqueIfApproximatelyUniqueRule()]  # noqa: E731
    result = _suggest(port_suggestions, table, rules, split=(0.1, 3))
    assert result.verification_result is not None
    codes = [s.code_for_constraint for s in result.all_suggestions]
    assert '.is_unique("id")' in codes and '.has_data_type("zip", ' \
        'ConstrainableDataTypes.INTEGRAL)' in codes
    assert_suggestions_parity(
        _suggest(ref_suggestions, ref_table, rules, split=(0.1, 3), monkeypatch=monkeypatch),
        result)


@pytest.mark.parametrize("backend", ["filesystem", "columnar"])
@pytest.mark.parametrize("direction", ["reference_saves", "port_saves"])
def test_saved_profile_reused_across_packages(parity_env, monkeypatch, tmp_path, direction,
                                              backend):
    """Profile metrics saved into a filesystem or columnar repository by
    one package are reused by the other (every metric found, no scan):
    the reusing profile is the saving package's exactly."""
    ref_table, table = _seeded_tables(rows=1000)
    build = lambda b: b.with_kll_profiling()  # noqa: E731
    ref_key = ref_repo.ResultKey(7, {"dataset": "orders"})
    port_key = port_repo.ResultKey(7, {"dataset": "orders"})
    path = str(tmp_path / ("metrics.json" if backend == "filesystem" else "metrics"))

    def repository(pkg):
        # the reading side opens the repository after the save, as a
        # second process would
        if backend == "filesystem":
            return pkg.FileSystemMetricsRepository(path)
        return pkg.ColumnarMetricsRepository(path)

    if direction == "reference_saves":
        saved = _ref_profile(lambda b: build(b).use_repository(repository(ref_repo))
                             .save_or_append_result(ref_key), ref_table, "f64", monkeypatch)
        SCAN_STATS.reset()
        reused = _port_profile(lambda b: build(b).use_repository(repository(port_repo))
                               .reuse_existing_results_for_key(port_key, True), table)
        assert SCAN_STATS.scan_passes == 0
    else:
        saved = _port_profile(lambda b: build(b).use_repository(repository(port_repo))
                              .save_or_append_result(port_key), table)
        reused = _ref_profile(lambda b: build(b).use_repository(repository(ref_repo))
                              .reuse_existing_results_for_key(ref_key, True),
                              ref_table, "f64", monkeypatch)
    assert reused.to_json() == saved.to_json()
    assert reused.num_records == saved.num_records


# -- residency -----------------------------------------------------------------


def _budgeted(monkeypatch, budget):
    """Give the CPU a resident budget, as a card has."""
    monkeypatch.setattr(scan_engine, "has_resident_budget", lambda device: True)
    monkeypatch.setattr(scan_engine, "resident_budget", lambda device: budget)


def _profile_streams(parity_env, table):
    with use_device("cpu"):
        SCAN_STATS.reset()
        out = port_profiles.ColumnProfilerRunner.on_data(table).with_kll_profiling().run()
    return out, SCAN_STATS.snapshot()


@pytest.mark.parametrize("budget, resident", [(1 << 40, True), (1000, False)])
def test_profile_resident_within_budget_streams_past_it(parity_env, monkeypatch,
                                                        budget, resident):
    """Within the budget the table and its cast twin stay resident for the
    three passes and are freed after; past it (the budget's MemoryError)
    every pass streams on the same device. The profile is the same."""
    _, table = _seeded_tables(rows=1000)
    streamed, _ = _profile_streams(parity_env, table)
    _budgeted(monkeypatch, budget)
    got, stats = _profile_streams(parity_env, table)
    assert stats["scan_passes"] == 2  # passes 1 and 2; pass 3 is a grouping
    assert stats["resident_passes"] == (2 if resident else 0)
    assert (stats["bytes_packed"] == 0) == resident
    assert scan_engine.total_resident_bytes() == 0 and not table.is_persisted
    assert got.to_json() == streamed.to_json()


@pytest.mark.parametrize("error", [MemoryError, torch.cuda.OutOfMemoryError])
def test_profile_streams_after_out_of_memory(parity_env, monkeypatch, error):
    """An out-of-memory error from persist() (the budget's, or the card's)
    leaves the table streamed on the same device."""
    _, table = _seeded_tables(rows=1000)
    streamed, _ = _profile_streams(parity_env, table)
    _budgeted(monkeypatch, 1 << 40)

    def persist_fails(table, device=None, **kwargs):
        raise error("out of memory")

    monkeypatch.setattr(scan_engine, "persist_table", persist_fails)
    got, stats = _profile_streams(parity_env, table)
    assert stats["resident_passes"] == 0 and stats["scan_passes"] == 2
    assert got.to_json() == streamed.to_json()


def test_profile_persist_failure_propagates(parity_env, monkeypatch):
    """Any other failure of persist() (a failed kernel build, an
    asynchronous device error) raises: the profiler never hides the
    device."""
    _, table = _seeded_tables(rows=1000)
    _budgeted(monkeypatch, 1 << 40)

    def persist_fails(table, device=None, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(scan_engine, "persist_table", persist_fails)
    with use_device("cpu"), pytest.raises(RuntimeError, match="illegal memory access"):
        port_profiles.ColumnProfilerRunner.on_data(table).run()
