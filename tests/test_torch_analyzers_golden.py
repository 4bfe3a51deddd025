"""Port twins of the reference's golden-value analyzer tests
(tests/test_analyzers_golden.py): the exact metrics the Scala
``AnalyzerTests`` and ``NullHandlingTests`` pin, on the reference's fixture
tables (tests/fixtures.py, the same arrays moved into the port's tables),
each analyzer run on the CPU through the port's fused scan, whose masked
reductions are K1's tasks (``deequ_tpu_torch/ops/masked_reduce.py``).
Each test keeps its reference twin's name and assertions. The last one
twins ``tests/test_analyzers.py::test_host_fold_widens_int_counts_to_i64``
against the port's fold: the device fold (``masked_reduce.merge_tags``)
and the host unflatten keep counts past 2^31 exact and give int64.

The mesh/no-mesh matrix: every test here runs twice, over the port's
8-member virtual mesh on the CPU and with no mesh
(``torch_parity.port_mesh_mode``), as the reference's suite runs under
its 8-device mesh and without it.
"""

import math

import numpy as np
import pytest

import fixtures
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.metrics import Entity
from torch_parity import port_table, port_mesh_mode  # noqa: F401

# every test runs over the port's 8-member virtual mesh and with none
pytestmark = [pytest.mark.torch_port, pytest.mark.usefixtures("port_mesh_mode")]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _port(name):
    def table():
        return port_table(getattr(fixtures, name)())

    table.__name__ = name
    return table


ref_df_complete_incomplete = _port("ref_df_complete_incomplete")
ref_df_empty_strings = _port("ref_df_empty_strings")
ref_df_full = _port("ref_df_full")
ref_df_informative = _port("ref_df_informative")
ref_df_missing = _port("ref_df_missing")
ref_df_uninformative = _port("ref_df_uninformative")
ref_df_variable_string_lengths = _port("ref_df_variable_string_lengths")
ref_df_with_distinct_values = _port("ref_df_with_distinct_values")
ref_df_with_numeric_values = _port("ref_df_with_numeric_values")
ref_df_with_unique_columns = _port("ref_df_with_unique_columns")


def value(metric):
    assert metric.value.is_success, metric.value
    return metric.value.get()


# -- Size / Completeness (AnalyzerTests.scala:33-75) ------------------------


def test_size():
    assert value(Size().calculate(ref_df_missing())) == 12.0
    assert value(Size().calculate(ref_df_full())) == 4.0


def test_completeness_exact():
    m = Completeness("att1").calculate(ref_df_missing())
    assert m.entity == Entity.COLUMN
    assert m.name == "Completeness"
    assert m.instance == "att1"
    assert value(m) == 0.5
    assert value(Completeness("att2").calculate(ref_df_missing())) == 0.75


def test_completeness_missing_column_fails():
    m = Completeness("someMissingColumn").calculate(ref_df_missing())
    assert m.instance == "someMissingColumn"
    assert m.value.is_failure


def test_completeness_with_filter():
    m = Completeness("att1", where="item IN ('1', '2')").calculate(ref_df_missing())
    assert value(m) == 1.0


# -- Uniqueness / Distinctness family (AnalyzerTests.scala:78-131) ----------


def test_uniqueness_exact():
    assert value(Uniqueness(("att1",)).calculate(ref_df_missing())) == 0.0
    assert value(Uniqueness(("att2",)).calculate(ref_df_missing())) == 0.0
    assert value(Uniqueness(("att1",)).calculate(ref_df_full())) == 0.25
    assert value(Uniqueness(("att2",)).calculate(ref_df_full())) == 0.25


def test_uniqueness_multi_column():
    df = ref_df_with_unique_columns()
    assert value(Uniqueness(("unique",)).calculate(df)) == 1.0
    assert value(Uniqueness(("uniqueWithNulls",)).calculate(df)) == 1.0
    m = Uniqueness(("unique", "nonUnique")).calculate(df)
    assert m.entity == Entity.MULTICOLUMN
    assert m.instance == "unique,nonUnique"
    assert value(m) == 1.0
    assert value(
        Uniqueness(("unique", "nonUniqueWithNulls")).calculate(df)
    ) == 1.0
    assert value(
        Uniqueness(("nonUnique", "onlyUniqueWithOtherNonUnique")).calculate(df)
    ) == 1.0


def test_uniqueness_missing_column_fails():
    m = Uniqueness(("nonExistingColumn",)).calculate(ref_df_full())
    assert m.value.is_failure


def test_distinctness_exact():
    # att1: a,a,null,b,b,c -> 3 distinct / 5 non-null rows... the reference
    # counts rows with at least one non-null grouping value as num_rows
    df = ref_df_with_distinct_values()
    assert value(Distinctness(("att1",)).calculate(df)) == 3.0 / 5.0
    assert value(Distinctness(("att2",)).calculate(df)) == 2.0 / 4.0
    # pairs: (a,null)x2, (null,x), (b,x)x2, (c,y) -> 4 distinct groups / 6
    # rows with at least one non-null (reference CheckTest.scala:90)
    assert value(Distinctness(("att1", "att2")).calculate(df)) == 4.0 / 6.0


def test_unique_value_ratio_exact():
    # att1 groups: a(2), b(2), c(1) -> 1 singleton / 3 groups
    df = ref_df_with_distinct_values()
    assert value(UniqueValueRatio(("att1",)).calculate(df)) == 1.0 / 3.0


def test_count_distinct_exact():
    df = ref_df_with_unique_columns()
    assert value(CountDistinct(("uniqueWithNulls",)).calculate(df)) == 5.0


def test_approx_count_distinct_exact_small():
    df = ref_df_with_unique_columns()
    assert value(ApproxCountDistinct("uniqueWithNulls").calculate(df)) == 5.0
    assert value(
        ApproxCountDistinct("uniqueWithNulls", where="unique < '4'").calculate(df)
    ) == 2.0


# -- Entropy / MutualInformation (AnalyzerTests.scala:133-168) --------------

_ENTROPY_3_1 = -(0.75 * math.log(0.75) + 0.25 * math.log(0.25))


def test_entropy_exact():
    assert value(Entropy("att1").calculate(ref_df_full())) == pytest.approx(
        _ENTROPY_3_1, rel=1e-12
    )
    assert value(Entropy("att2").calculate(ref_df_full())) == pytest.approx(
        _ENTROPY_3_1, rel=1e-12
    )


def test_mutual_information_exact():
    # att1 and att2 are in bijection on ref_df_full -> MI == entropy
    assert value(
        MutualInformation(("att1", "att2")).calculate(ref_df_full())
    ) == pytest.approx(_ENTROPY_3_1, rel=1e-12)


def test_mutual_information_uninformative():
    assert value(
        MutualInformation(("att1", "att2")).calculate(ref_df_uninformative())
    ) == pytest.approx(0.0, abs=1e-12)


# -- Compliance (AnalyzerTests.scala:171-199) -------------------------------


def test_compliance_exact():
    df = ref_df_with_numeric_values()
    m = Compliance("rule1", "att1 > 3").calculate(df)
    assert m.instance == "rule1"
    assert value(m) == 3.0 / 6.0
    assert value(Compliance("rule2", "att1 > 2").calculate(df)) == 4.0 / 6.0


def test_compliance_with_filter():
    df = ref_df_with_numeric_values()
    m = Compliance("rule1", "att1 > 3", where="att2 > 0").calculate(df)
    assert value(m) == 1.0


def test_compliance_bogus_predicate_fails():
    m = Compliance("rule1", "attNoSuchColumn > 0").calculate(
        ref_df_with_numeric_values()
    )
    assert m.value.is_failure


# -- Histogram (AnalyzerTests.scala:201-271) --------------------------------


def test_histogram_exact():
    df = ref_df_complete_incomplete()
    dist = value(Histogram("att1").calculate(df))
    assert dist.number_of_bins == 2
    assert dist.values["a"].absolute == 4
    assert dist.values["b"].absolute == 2
    assert dist.values["a"].ratio == 4.0 / 6.0


def test_histogram_nulls_bin():
    df = ref_df_complete_incomplete()
    dist = value(Histogram("att2").calculate(df))
    assert dist.number_of_bins == 3
    assert set(dist.values) == {"f", "d", "NullValue"}
    assert dist.values["NullValue"].absolute == 2


def test_histogram_binning_udf():
    df = ref_df_complete_incomplete()
    dist = value(
        Histogram("att1", binning_udf=lambda v: "Value1").calculate(df)
    )
    assert dist.number_of_bins == 1
    assert dist.values["Value1"].absolute == 6


def test_histogram_top_n():
    df = ref_df_complete_incomplete()
    dist = value(Histogram("att2", max_detail_bins=2).calculate(df))
    assert dist.number_of_bins == 3  # total distinct still reported
    assert len(dist.values) == 2  # only top-2 detailed
    assert set(dist.values) == {"f", "NullValue"}


def test_histogram_too_many_bins_fails():
    from deequ_tpu_torch.analyzers.grouping import MAXIMUM_ALLOWED_DETAIL_BINS

    m = Histogram("att1", max_detail_bins=MAXIMUM_ALLOWED_DETAIL_BINS + 1).calculate(
        ref_df_complete_incomplete()
    )
    assert m.value.is_failure


# -- numeric statistics (AnalyzerTests.scala:420-545) -----------------------


def test_mean_exact():
    df = ref_df_with_numeric_values()
    assert value(Mean("att1").calculate(df)) == 3.5
    assert value(Mean("att1", where="item != '6'").calculate(df)) == 3.0


def test_stddev_exact():
    df = ref_df_with_numeric_values()
    assert value(StandardDeviation("att1").calculate(df)) == pytest.approx(
        1.707825127659933, rel=1e-12
    )


def test_minimum_maximum_exact():
    df = ref_df_with_numeric_values()
    assert value(Minimum("att1").calculate(df)) == 1.0
    assert value(Maximum("att1").calculate(df)) == 6.0
    assert value(Maximum("att1", where="item <= '5'").calculate(df)) == 5.0
    assert value(Minimum("att2").calculate(df)) == 0.0
    assert value(Minimum("att2", where="att2 > 0").calculate(df)) == 5.0


def test_sum_exact():
    assert value(Sum("att1").calculate(ref_df_with_numeric_values())) == 21.0


def test_numeric_analyzer_on_string_column_fails():
    for analyzer in (Mean("att1"), Sum("att1"), Minimum("att1"),
                     StandardDeviation("att1")):
        assert analyzer.calculate(ref_df_full()).value.is_failure


# -- string lengths (AnalyzerTests.scala:506-540) ---------------------------


def test_min_max_length_exact():
    df = ref_df_variable_string_lengths()
    assert value(MinLength("att1").calculate(df)) == 0.0
    assert value(MinLength("att1", where="att1 != ''").calculate(df)) == 1.0
    assert value(MaxLength("att1").calculate(df)) == 4.0
    assert value(MaxLength("att1", where="att1 != 'dddd'").calculate(df)) == 3.0


def test_length_on_numeric_column_fails():
    df = ref_df_with_numeric_values()
    assert MinLength("att1").calculate(df).value.is_failure
    assert MaxLength("att1").calculate(df).value.is_failure


# -- Correlation (AnalyzerTests.scala around 640-660) -----------------------


def test_correlation_exact():
    assert value(
        Correlation("att1", "att2").calculate(ref_df_informative())
    ) == pytest.approx(1.0, rel=1e-12)
    m = Correlation("att1", "att2").calculate(ref_df_uninformative())
    # constant att2 -> zero variance -> correlation undefined (NaN)
    assert m.value.is_success and math.isnan(m.value.get())


# -- PatternMatch (AnalyzerTests.scala:660-760) -----------------------------


def test_pattern_match_exact():
    df = ColumnarTableFromValues(["1.0", "2.0", "3.0", "4"])
    assert value(PatternMatch("col", r"\d\.\d").calculate(df)) == 0.75
    df2 = ColumnarTableFromValues(["4", "a", "b", "5"])
    assert value(PatternMatch("col", r"\d").calculate(df2)) == 0.5


def ColumnarTableFromValues(values):
    from deequ_tpu_torch.data.table import ColumnarTable

    return ColumnarTable.from_pydict({"col": values})


def test_pattern_match_email_builtin():
    from deequ_tpu_torch.analyzers.scan import Patterns

    df = ColumnarTableFromValues(["someone@somewhere.org", "someone@else"])
    assert value(PatternMatch("col", Patterns.EMAIL).calculate(df)) == 0.5


def test_pattern_match_creditcard_builtin():
    from deequ_tpu_torch.analyzers.scan import Patterns

    df = ColumnarTableFromValues([
        "378282246310005",   # AMEX
        "6011111111111117",  # Discover
        "email@example.com",
        "###",
    ])
    assert value(PatternMatch("col", Patterns.CREDITCARD).calculate(df)) == 0.5


def test_pattern_match_url_builtin():
    from deequ_tpu_torch.analyzers.scan import Patterns

    df = ColumnarTableFromValues([
        "https://www.example.com/foo/?bar=baz&inga=42",
        "http://userid@example.com:8080",
        "not-a-url",
        "also not",
    ])
    assert value(PatternMatch("col", Patterns.URL).calculate(df)) == 0.5


# -- DataType inference (AnalyzerTests.scala:273-415) -----------------------


def _type_ratio(dist, key):
    dv = dist.values.get(key)
    return dv.ratio if dv else 0.0


def test_data_type_all_strings():
    dist = value(DataType("att1").calculate(ref_df_full()))
    assert _type_ratio(dist, "String") == 1.0


def test_data_type_integral_fractional_mix():
    df = ColumnarTableFromValues(["1.0", "1"])
    dist = value(DataType("col").calculate(df))
    assert dist.values["Fractional"].absolute == 1
    assert dist.values["Integral"].absolute == 1


def test_data_type_boolean():
    df = ColumnarTableFromValues(["true", "false", "true", "x"])
    dist = value(DataType("col").calculate(df))
    assert dist.values["Boolean"].absolute == 3
    assert dist.values["String"].absolute == 1


def test_data_type_nulls_are_unknown():
    df = ColumnarTableFromValues(["1", None, "2.0", None])
    dist = value(DataType("col").calculate(df))
    assert dist.values["Unknown"].absolute == 2
    assert dist.values["Integral"].absolute == 1
    assert dist.values["Fractional"].absolute == 1


# -- all-null / empty inputs (NullHandlingTests.scala) ----------------------


def _all_null_numeric():
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    return ColumnarTable([
        Column("v", DType.FRACTIONAL,
               values=np.zeros(4), mask=np.zeros(4, dtype=bool)),
    ])


def test_all_null_column_behaviour():
    t = _all_null_numeric()
    assert value(Size().calculate(t)) == 4.0
    assert value(Completeness("v").calculate(t)) == 0.0
    # value aggregates over zero rows -> EmptyStateException failure
    for analyzer in (Mean("v"), Minimum("v"), Maximum("v"), Sum("v"),
                     StandardDeviation("v")):
        m = analyzer.calculate(t)
        assert m.value.is_failure, analyzer


def test_empty_table_behaviour():
    t = ref_df_empty_strings()
    assert value(Size().calculate(t)) == 0.0
    m = Completeness("column1").calculate(t)
    # 0/0 rows: the reference yields NaN-ish / failure; ours must not crash
    assert m.value.is_success or m.value.is_failure
    dist_m = Histogram("column1").calculate(t)
    assert dist_m.value.is_success or dist_m.value.is_failure


def test_host_fold_widens_int_counts_to_i64():
    """Counts past 2^31 fold exactly on the device (f64 add, the
    reference's ``_tag_reduce_np`` "sum" on the host) and come back as
    int64 (round-4 review finding of the reference)."""
    import torch

    from deequ_tpu_torch.ops import masked_reduce
    from deequ_tpu_torch.ops.scan_engine import ScanOp, _DeviceFoldPlan

    big = 2**31 - 10
    n = torch.tensor(big, dtype=torch.int64)
    plan = _DeviceFoldPlan([ScanOp((), lambda *a: None, {"n": "sum"})], [{"n": n}], 2, "cpu")
    for _ in range(2):
        plan.merge(plan.flatten([{"n": n}]))
    (result,) = plan.fetch_unflatten()
    assert result["n"].dtype == np.int64
    assert int(result["n"]) == 2 * big  # no i32 wrap
    acc = torch.tensor([float(big)], dtype=torch.float64)
    total = masked_reduce.merge_tags(torch.tensor([True]), torch.tensor([False]), acc, acc)
    assert int(total) == 2 * big
