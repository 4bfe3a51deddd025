"""The port's readers and writers and its distribution distances
(``deequ_tpu_torch/data/io.py``, ``deequ_tpu_torch/analyzers/distance.py``)
against the reference's on the CPU: the twins of the 9 tests of
tests/test_io_and_distance.py (the three titanic twins skip exactly as the
reference's do, without the reference's test data), and the table surface
the profiler and the readers use (``ColumnChunk.from_codes``,
``ColumnarTable.with_column``, ``random_split``).

- every table read holds the reference's arrays: types, values and
  nulls, column for column;
- distances within 1e-12 of the reference's on the same sketches;
- ``random_split`` gives the reference's rows, row for row.
"""

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers.distance as ref_distance
import deequ_tpu.data.io as ref_io
from deequ_tpu.data.table import ColumnChunk as RefChunk
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.ops.kll import KLLSketchState as RefSketch
from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite, use_device
from deequ_tpu_torch.analyzers.distance import categorical_distance, numerical_distance
from deequ_tpu_torch.data.io import from_arrow, from_pandas, read_csv, read_parquet
from deequ_tpu_torch.data.table import Column, ColumnChunk, DType
from deequ_tpu_torch.ops.kll import KLLSketchState
from test_io_and_distance import TITANIC, requires_titanic

pytestmark = pytest.mark.torch_port

DISTANCE_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _columns(table):
    """{name: (type, values with None for nulls)} of either package's table."""
    return {name: (table[name].dtype.value, table[name].to_pylist())
            for name in table.column_names}


@requires_titanic
def test_read_titanic_csv():
    table = read_csv(TITANIC)
    assert table.num_rows == 891
    assert table["PassengerId"].dtype == DType.INTEGRAL
    assert table["Fare"].dtype == DType.FRACTIONAL
    assert table["Name"].dtype == DType.STRING
    assert table["Age"].dtype == DType.FRACTIONAL
    assert table["Age"].num_valid == 714
    assert _columns(table) == _columns(ref_io.read_csv(TITANIC))


@requires_titanic
def test_titanic_verification():
    table = read_csv(TITANIC)
    check = (
        Check(CheckLevel.ERROR, "titanic")
        .has_size(lambda n: n == 891)
        .is_complete("PassengerId")
        .is_unique("PassengerId")
        .has_completeness("Age", lambda c: abs(c - 714 / 891) < 1e-9)
        .is_contained_in("Sex", ["male", "female"])
        .is_contained_in("Embarked", ["S", "C", "Q"])
        .is_non_negative("Fare")
    )
    result = VerificationSuite.on_data(table).add_check(check).run()
    assert result.status == CheckStatus.SUCCESS


@requires_titanic
def test_titanic_profile():
    from deequ_tpu.profiles import ColumnProfilerRunner as RefRunner
    from deequ_tpu_torch.profiles import ColumnProfilerRunner

    table = read_csv(TITANIC)
    profiles = ColumnProfilerRunner.on_data(table).run()
    assert profiles.num_records == 891
    sex = profiles.profiles["Sex"]
    assert sex.histogram is not None
    assert sex.histogram["male"].absolute == 577
    ref = RefRunner.on_data(ref_io.read_csv(TITANIC)).run()
    for name, r in ref.profiles.items():
        p = profiles.profiles[name]
        assert (p.completeness, p.approximate_num_distinct_values, p.data_type.value) == (
            r.completeness, r.approximate_num_distinct_values, r.data_type.value)


def test_parquet_roundtrip(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch.data.io import write_parquet

    arrow = pa.table({
        "a": [1, 2, None, 4],
        "b": [1.5, None, 3.5, 4.5],
        "c": ["x", "y", None, "x"],
        "d": [True, False, True, None],
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(arrow, path)
    table = read_parquet(path)
    assert table.num_rows == 4
    assert table["a"].dtype == DType.INTEGRAL
    assert table["a"].to_pylist() == [1, 2, None, 4]
    assert table["b"].to_pylist() == [1.5, None, 3.5, 4.5]
    assert table["c"].to_pylist() == ["x", "y", None, "x"]
    assert table["d"].to_pylist() == [True, False, True, None]
    assert _columns(table) == _columns(ref_io.read_parquet(path))
    # written back by the port, read by both packages
    again = str(tmp_path / "again.parquet")
    write_parquet(table, again)
    assert _columns(read_parquet(again)) == _columns(table)
    assert _columns(ref_io.read_parquet(again)) == _columns(table)
    # one column of a file
    assert read_parquet(path, columns=["c"]).column_names == ["c"]


def test_from_pandas():
    import pandas as pd

    df = pd.DataFrame({"x": [1.0, np.nan, 3.0], "s": ["a", None, "b"],
                       "i": [1, 2, 3], "b": [True, False, True]})
    table = from_pandas(df)
    assert table["x"].to_pylist() == [1.0, None, 3.0]
    assert table["s"].to_pylist() == ["a", None, "b"]
    assert _columns(table) == _columns(ref_io.from_pandas(df))


def _sketches(pkg_sketch, *samples):
    out = []
    for data in samples:
        s = pkg_sketch()
        s.update_batch(data)
        out.append(s)
    return out


def test_numerical_distance_identical():
    data = np.random.default_rng(0).normal(size=5000)
    s1, s2 = _sketches(KLLSketchState, data, data)
    assert numerical_distance(s1, s2, correct_for_low_number_of_samples=True) == 0.0
    r1, r2 = _sketches(RefSketch, data, data)
    assert ref_distance.numerical_distance(r1, r2) == numerical_distance(s1, s2)


def test_numerical_distance_shifted():
    rng = np.random.default_rng(0)
    a, b = rng.normal(0, 1, 5000), rng.normal(3, 1, 5000)
    s1, s2 = _sketches(KLLSketchState, a, b)
    d = numerical_distance(s1, s2, correct_for_low_number_of_samples=True)
    assert d > 0.8
    r1, r2 = _sketches(RefSketch, a, b)
    for flag in (True, False):
        want = ref_distance.numerical_distance(r1, r2, correct_for_low_number_of_samples=flag)
        got = numerical_distance(s1, s2, correct_for_low_number_of_samples=flag)
        assert abs(got - want) <= DISTANCE_TOL
    empty = KLLSketchState()
    assert np.isnan(numerical_distance(s1, empty))


def test_categorical_distance():
    a = {"x": 50, "y": 50}
    b = {"x": 50, "y": 50}
    assert categorical_distance(a, b, correct_for_low_number_of_samples=True) == 0.0
    c = {"x": 100}
    d = categorical_distance(a, c, correct_for_low_number_of_samples=True)
    assert d == 0.5
    robust = categorical_distance(a, c)
    assert robust < d
    for x, y in ((a, c), ({"p": 3, "q": 9, "r": 1}, {"q": 4, "s": 7})):
        for flag in (True, False):
            want = ref_distance.categorical_distance(x, y, flag)
            assert abs(categorical_distance(x, y, flag) - want) <= DISTANCE_TOL
    assert np.isnan(categorical_distance({}, a))


def test_from_arrow_valid_nan_is_null():
    import pyarrow as pa

    from deequ_tpu_torch.analyzers import Mean, Sum
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner

    arrow = pa.table({"x": pa.array([1.0, float("nan"), None, 4.0])})
    col = from_arrow(arrow)["x"]
    assert list(col.mask) == [True, False, False, True]
    assert np.all(np.isfinite(col.values))
    ctx = AnalysisRunner.do_analysis_run(from_arrow(arrow), [Sum("x"), Mean("x")])
    assert ctx.metric_map[Sum("x")].value.get() == 5.0
    assert ctx.metric_map[Mean("x")].value.get() == 2.5


# -- the table surface the profiler and the readers use ------------------------


def test_from_arrow_dictionary_stays_encoded():
    """A numeric Arrow DictionaryArray arrives as a ColumnChunk (a NaN
    entry and a null index both null), the reference's codes and
    dictionary; a string one, or one past the int16 codes, decodes."""
    import pyarrow as pa

    enc = pa.DictionaryArray.from_arrays(pa.array([0, 1, None, 2, 1], type=pa.int32()),
                                         pa.array([1.5, float("nan"), -2.0]))
    strs = pa.array(["a", "b", "a", None, "b"]).dictionary_encode()
    wide = pa.DictionaryArray.from_arrays(pa.array(np.arange(40_000) % 40_000),
                                          pa.array(np.arange(40_000, dtype=np.int64)))
    arrow = pa.table({"e": enc, "s": strs})
    port, ref = from_arrow(arrow), ref_io.from_arrow(arrow)
    chunk, ref_chunk = port["e"].encoding, ref["e"].encoding
    assert chunk is not None and chunk.cardinality == 3
    np.testing.assert_array_equal(chunk.codes, ref_chunk.codes)
    np.testing.assert_array_equal(chunk.dictionary, ref_chunk.dictionary)
    np.testing.assert_array_equal(chunk.validity, ref_chunk.validity)
    assert chunk.nbytes == ref_chunk.nbytes
    assert port["e"].to_pylist() == [1.5, None, None, -2.0, None]
    assert _columns(port) == _columns(ref)
    wide_col = from_arrow(pa.table({"w": wide}))["w"]
    assert wide_col.encoding is None and wide_col.dtype == DType.INTEGRAL


def test_column_chunk_from_codes():
    """Wider codes, a mask, negative codes and NaN dictionary entries,
    normalised to int16 with -1 as the reference does."""
    codes = np.array([0, 3, -1, 2, 1, 3, 0], dtype=np.int64)
    dictionary = np.array([0.5, np.nan, 7.0, -1.25])
    mask = np.array([True, True, True, True, True, False, True])
    port = ColumnChunk.from_codes(codes, dictionary, mask=mask)
    ref = RefChunk.from_codes(codes, dictionary, mask=mask)
    assert port.codes.dtype == np.int16
    np.testing.assert_array_equal(port.codes, ref.codes)
    np.testing.assert_array_equal(port.dictionary, ref.dictionary)
    np.testing.assert_array_equal(port.validity, ref.validity)
    assert (port.num_rows, port.cardinality, port.nbytes) == (
        ref.num_rows, ref.cardinality, ref.nbytes)
    assert list(port.codes) == [0, 3, -1, 2, -1, -1, 0]
    full = ColumnChunk.from_codes(np.array([1, 0]), np.array([4, 5]))
    assert full.validity is None and full.nbytes == full.codes.nbytes + full.dictionary.nbytes
    col = Column("x", DType.FRACTIONAL, encoded=port)
    assert col.to_pylist() == [0.5, -1.25, None, 7.0, None, None, 0.5]


def test_with_column_and_random_split():
    """``with_column`` replaces a column or appends one, sharing the rest;
    ``random_split`` gives the reference's rows, row for row, at several
    seeds and fractions."""
    rng = np.random.default_rng(4)
    n = 5_000
    ref = RefTable.from_pydict({"v": list(rng.normal(size=n)),
                                "s": [f"k{i % 7}" for i in range(n)]})
    from torch_parity import port_table

    table = port_table(ref)
    doubled = Column("v", DType.FRACTIONAL, values=table["v"].values * 2)
    replaced = table.with_column(doubled)
    assert replaced.column_names == ["s", "v"] and replaced["s"] is table["s"]
    assert replaced["v"] is doubled and table["v"] is not doubled
    added = table.with_column(Column("w", DType.INTEGRAL, values=np.arange(n)))
    assert added.column_names == ["v", "s", "w"]
    for seed, fractions in ((0, (0.9, 0.1)), (7, (0.7, 0.3)), (123, (1.0, 3.0))):
        train, test = table.random_split(fractions, seed=seed)
        ref_train, ref_test = ref.random_split(fractions, seed=seed)
        assert train.num_rows + test.num_rows == n and 0 < test.num_rows < n
        assert _columns(train) == _columns(ref_train)
        assert _columns(test) == _columns(ref_test)
