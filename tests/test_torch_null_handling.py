"""Port twins of the reference's null-handling tests
(tests/test_null_handling.py, the analogue of
analyzers/NullHandlingTests.scala): every analyzer of the port against an
all-null column and a mixed column, on the CPU. The all-null columns give
K1's tasks no valid row (counts 0, min/max at their identities, moments
of nothing), which the states turn into the reference's failures. Each
test keeps its twin's name and assertions."""

import math

import numpy as np
import pytest

from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture
def table():
    """Columns with ALL null values plus a normal one."""
    n = 6
    all_null_num = Column(
        "allNullNum", DType.FRACTIONAL,
        values=np.zeros(n), mask=np.zeros(n, dtype=bool),
    )
    all_null_str = Column(
        "allNullStr", DType.STRING,
        codes=np.full(n, -1, dtype=np.int32),
        dictionary=np.array([], dtype=object),
    )
    some = Column(
        "some", DType.FRACTIONAL,
        values=np.array([1.0, 2.0, 0.0, 4.0, 5.0, 6.0]),
        mask=np.array([True, True, False, True, True, True]),
    )
    return ColumnarTable([all_null_num, all_null_str, some])


def _fails(metric):
    return metric.value.is_failure


def test_completeness_of_all_null_is_zero(table):
    assert Completeness("allNullNum").calculate(table).value.get() == 0.0
    assert Completeness("allNullStr").calculate(table).value.get() == 0.0


def test_extrema_of_all_null_fail(table):
    assert _fails(Minimum("allNullNum").calculate(table))
    assert _fails(Maximum("allNullNum").calculate(table))
    assert _fails(MinLength("allNullStr").calculate(table))
    assert _fails(MaxLength("allNullStr").calculate(table))


def test_mean_sum_stddev_of_all_null_fail(table):
    assert _fails(Mean("allNullNum").calculate(table))
    assert _fails(Sum("allNullNum").calculate(table))
    assert _fails(StandardDeviation("allNullNum").calculate(table))


def test_correlation_with_all_null_fails(table):
    assert _fails(Correlation("allNullNum", "some").calculate(table))


def test_data_type_all_null_is_unknown(table):
    from deequ_tpu_torch.analyzers.scan import DataTypeInstances, determine_type

    dist = DataType("allNullStr").calculate(table).value.get()
    assert dist["Unknown"].absolute == 6
    assert determine_type(dist) == DataTypeInstances.UNKNOWN


def test_approx_count_distinct_all_null_is_zero(table):
    assert ApproxCountDistinct("allNullStr").calculate(table).value.get() == 0.0


def test_sketches_of_all_null_fail(table):
    assert _fails(KLLSketch("allNullNum").calculate(table))
    assert _fails(ApproxQuantile("allNullNum", 0.5).calculate(table))


def test_grouping_of_all_null(table):
    # all rows filtered (no non-null grouping value): num_rows = 0
    m = Uniqueness(("allNullStr",)).calculate(table)
    assert m.value.is_success and math.isnan(m.value.get())
    assert CountDistinct(("allNullStr",)).calculate(table).value.get() == 0.0
    e = Entropy("allNullStr").calculate(table)
    assert e.value.is_success and math.isnan(e.value.get())
    d = Distinctness(("allNullStr",)).calculate(table)
    assert d.value.is_success and math.isnan(d.value.get())


def test_histogram_of_all_null(table):
    dist = Histogram("allNullStr").calculate(table).value.get()
    assert dist.number_of_bins == 1
    assert dist["NullValue"].absolute == 6


def test_pattern_match_of_all_null_is_zero(table):
    m = PatternMatch("allNullStr", r"\d+").calculate(table)
    assert m.value.get() == 0.0


def test_compliance_on_all_null_predicate(table):
    m = Compliance("c", "allNullNum > 0").calculate(table)
    assert m.value.get() == 0.0


def test_empty_table_size():
    t = ColumnarTable.from_pydict({"x": []})
    assert Size().calculate(t).value.get() == 0.0
    assert Completeness("x").calculate(t).value.is_success


def test_analysis_bag(table):
    from deequ_tpu_torch.analyzers.analysis import Analysis

    ctx = (
        Analysis()
        .add_analyzer(Size())
        .add_analyzers([Completeness("some"), Mean("some")])
        .run(table)
    )
    assert ctx.metric_map[Size()].value.get() == 6.0
    assert abs(ctx.metric_map[Mean("some")].value.get() - 3.6) < 1e-12
