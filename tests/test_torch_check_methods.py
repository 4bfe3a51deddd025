"""Port twins of the reference's Check-method tests
(tests/test_check_methods.py), one test a Check method: the methods that
build on frequency tables and the string analyzers
(has_number_of_distinct_values, has_histogram_values,
has_mutual_information, has_min_length, has_max_length, has_pattern, the
four contains_* methods, has_data_type), and below them the scan, grouping,
sketch, predicate and anomaly methods (has_size ...
is_newest_point_non_anomalous, is_primary_key among them). Each runs a
VerificationSuite of the port on the CPU over the reference's fixture
tables (tests/fixtures.py, the same arrays) and asserts the same outcome
the reference test asserts."""

import math
import re

import pytest

from deequ_tpu_torch import (
    Check,
    CheckLevel,
    CheckStatus,
    ColumnarTable,
    ConstrainableDataTypes,
    VerificationSuite,
)
from deequ_tpu_torch.analyzers import Patterns
from fixtures import (
    ref_df_complete_incomplete,
    ref_df_full,
    ref_df_missing,
    ref_df_variable_string_lengths,
    ref_df_with_distinct_values,
    ref_df_with_numeric_values,
    ref_df_with_unique_columns,
)
from torch_parity import port_table

pytestmark = pytest.mark.torch_port


def run(table, check):
    return VerificationSuite.on_data(table, device="cpu").add_check(check).run()


def assert_pass(table, check):
    result = run(table, check)
    failing = [
        r for r in result.check_results_as_rows(result)
        if r["constraint_status"] != "Success"
    ]
    assert result.status == CheckStatus.SUCCESS, failing


def status_of(table, check) -> CheckStatus:
    return run(table, check).status


def assert_fail(table, check):
    assert status_of(table, check) == CheckStatus.ERROR


def C(desc="c"):
    return Check(CheckLevel.ERROR, desc)


def test_has_number_of_distinct_values():
    table = port_table(ref_df_full())
    assert_pass(table, C().has_number_of_distinct_values("att1", lambda n: n == 2))
    assert_fail(table, C().has_number_of_distinct_values("att1", lambda n: n == 3))


def test_has_histogram_values():
    assert_pass(
        port_table(ref_df_complete_incomplete()),
        C().has_histogram_values("att1", lambda d: d.values["a"].absolute == 4),
    )


def test_has_mutual_information():
    expected = -(0.75 * math.log(0.75) + 0.25 * math.log(0.25))
    assert_pass(
        port_table(ref_df_full()),
        C().has_mutual_information("att1", "att2", lambda mi: abs(mi - expected) < 1e-12),
    )


def test_has_min_length():
    assert_pass(
        port_table(ref_df_variable_string_lengths()),
        C().has_min_length("att1", lambda l: l == 0.0),
    )


def test_has_max_length():
    assert_pass(
        port_table(ref_df_variable_string_lengths()),
        C().has_max_length("att1", lambda l: l == 4.0),
    )


def test_has_pattern():
    t = ColumnarTable.from_pydict({"col": ["ab", "cd", "12"]})
    assert_pass(t, C().has_pattern("col", r"^[a-z]+$", lambda f: f == 2.0 / 3))


def test_contains_credit_card_number():
    t = ColumnarTable.from_pydict({"col": ["378282246310005", "not-a-card"]})
    assert_pass(t, C().contains_credit_card_number("col", lambda f: f == 0.5))


def test_contains_email():
    t = ColumnarTable.from_pydict({"col": ["a@b.com", "nope"]})
    assert_pass(t, C().contains_email("col", lambda f: f == 0.5))


def test_contains_url():
    t = ColumnarTable.from_pydict({"col": ["https://example.com/x", "nope"]})
    assert_pass(t, C().contains_url("col", lambda f: f == 0.5))


def test_contains_social_security_number():
    t = ColumnarTable.from_pydict({"col": ["111-05-1130", "nope"]})
    assert_pass(t, C().contains_social_security_number("col", lambda f: f == 0.5))


def test_has_data_type():
    t = ColumnarTable.from_pydict({"col": ["1", "2", "x", "3"]})
    assert_pass(
        t,
        C().has_data_type("col", ConstrainableDataTypes.INTEGRAL, lambda f: f == 0.75),
    )


def test_contains_email_rfc5322_edge_cases():
    """EMAIL carries the reference's full RFC-5322 alternatives
    (PatternMatch.scala:61): quoted local parts and IP-literal domains
    match; malformed forms don't. The fixtures agree with the reference's
    exact regex, pattern by pattern and through contains_email."""
    reference_rx = re.compile(
        r"""(?:[a-z0-9!#$%&'*+/=?^_`{|}~-]+(?:\.[a-z0-9!#$%&'*+/=?^_`{|}~-]+)*|"(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21\x23-\x5b\x5d-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])*")@(?:(?:[a-z0-9](?:[a-z0-9-]*[a-z0-9])?\.)+[a-z0-9](?:[a-z0-9-]*[a-z0-9])?|\[(?:(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?)\.){3}(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?|[a-z0-9-]*[a-z0-9]:(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21-\x5a\x53-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])+)\])"""
    )
    rx = re.compile(Patterns.EMAIL)
    fixtures = [
        "simple@example.com",
        "a.b-c_d+tag@sub.example.org",
        '"quoted.local"@example.com',
        '"a\\ b"@example.com',
        '"a b"@example.com',
        "user@[192.168.0.1]",
        "x@[255.255.255.255]",
        "user@[300.1.1.1]",
        "plainaddress",
        "@no-local.com",
        "two@@ats.com",
        "trailing.dot@example.com.",
        "UPPER@EXAMPLE.COM",
    ]
    hits = 0
    for s in fixtures:
        ours = rx.search(s) is not None
        assert ours == (reference_rx.search(s) is not None), s
        assert (rx.fullmatch(s) is None) == (reference_rx.fullmatch(s) is None), s
        hits += ours
    assert rx.fullmatch('"quoted.local"@example.com')
    assert rx.fullmatch("user@[192.168.0.1]")
    t = ColumnarTable.from_pydict({"col": fixtures})
    assert_pass(t, C().contains_email("col", lambda f: f == hits / len(fixtures)))


# -- the scan, grouping, sketch, predicate and anomaly methods ------------


def test_has_size():
    assert_pass(port_table(ref_df_full()), C().has_size(lambda n: n == 4))
    assert_fail(port_table(ref_df_full()), C().has_size(lambda n: n == 5))


def test_is_complete():
    assert_pass(port_table(ref_df_complete_incomplete()), C().is_complete("att1"))
    assert_fail(port_table(ref_df_complete_incomplete()), C().is_complete("att2"))


def test_has_completeness():
    assert_pass(port_table(ref_df_missing()), C().has_completeness("att2", lambda c: c == 0.75))
    assert_fail(port_table(ref_df_missing()), C().has_completeness("att2", lambda c: c > 0.9))


def test_is_unique():
    assert_pass(port_table(ref_df_with_unique_columns()), C().is_unique("unique"))
    assert_fail(port_table(ref_df_with_unique_columns()), C().is_unique("nonUnique"))


def test_is_primary_key():
    assert_pass(port_table(ref_df_with_unique_columns()), C().is_primary_key("unique"))
    # the reference's isPrimaryKey "currently only checks uniqueness"
    # (Check.scala:152-158): null rows drop out of grouping, so
    # uniqueWithNulls PASSES; a genuinely non-unique column fails
    assert_pass(port_table(ref_df_with_unique_columns()), C().is_primary_key("uniqueWithNulls"))
    assert_fail(port_table(ref_df_with_unique_columns()), C().is_primary_key("nonUnique"))


def test_has_uniqueness():
    assert_pass(
        port_table(ref_df_with_unique_columns()),
        C().has_uniqueness(("unique", "nonUnique"), lambda u: u == 1.0),
    )
    assert_fail(
        port_table(ref_df_with_unique_columns()),
        C().has_uniqueness(("nonUnique",), lambda u: u == 1.0),
    )


def test_has_distinctness():
    assert_pass(
        port_table(ref_df_with_distinct_values()),
        C().has_distinctness(("att1",), lambda d: d == 3.0 / 5),
    )
    assert_fail(
        port_table(ref_df_with_distinct_values()),
        C().has_distinctness(("att2",), lambda d: d == 1.0),
    )


def test_has_unique_value_ratio():
    assert_pass(
        port_table(ref_df_with_distinct_values()),
        C().has_unique_value_ratio(("att1",), lambda r: r == 1.0 / 3),
    )


def test_kll_sketch_satisfies():
    assert_pass(
        port_table(ref_df_with_numeric_values()),
        C().kll_sketch_satisfies(
            "att1", lambda dist: dist.buckets[0].low_value == 1.0
        ),
    )


def test_has_entropy():
    import math

    expected = -(0.75 * math.log(0.75) + 0.25 * math.log(0.25))
    assert_pass(
        port_table(ref_df_full()),
        C().has_entropy("att1", lambda e: abs(e - expected) < 1e-12),
    )


def test_has_approx_quantile():
    assert_pass(
        port_table(ref_df_with_numeric_values()),
        C().has_approx_quantile("att1", 0.5, lambda v: v in (3.0, 4.0)),
    )


def test_has_min():
    assert_pass(port_table(ref_df_with_numeric_values()), C().has_min("att1", lambda v: v == 1.0))


def test_has_max():
    assert_pass(port_table(ref_df_with_numeric_values()), C().has_max("att1", lambda v: v == 6.0))


def test_has_mean():
    assert_pass(port_table(ref_df_with_numeric_values()), C().has_mean("att1", lambda v: v == 3.5))


def test_has_sum():
    assert_pass(port_table(ref_df_with_numeric_values()), C().has_sum("att1", lambda v: v == 21.0))


def test_has_standard_deviation():
    assert_pass(
        port_table(ref_df_with_numeric_values()),
        C().has_standard_deviation(
            "att1", lambda v: abs(v - 1.707825127659933) < 1e-12
        ),
    )


def test_has_approx_count_distinct():
    assert_pass(
        port_table(ref_df_with_unique_columns()),
        C().has_approx_count_distinct("uniqueWithNulls", lambda v: v == 5.0),
    )


def test_has_correlation():
    t = ColumnarTable.from_pydict({"a": [1.0, 2.0, 3.0], "b": [4.0, 5.0, 6.0]})
    assert_pass(t, C().has_correlation("a", "b", lambda r: abs(r - 1.0) < 1e-12))


def test_satisfies():
    assert_pass(
        port_table(ref_df_with_numeric_values()),
        C().satisfies("att1 > 0", "all positive", lambda f: f == 1.0),
    )
    assert_fail(
        port_table(ref_df_with_numeric_values()),
        C().satisfies("att1 > 3", "more than half", lambda f: f > 0.5),
    )


def test_is_non_negative_and_is_positive():
    t = ColumnarTable.from_pydict({"p": [1, 2, 3], "z": [0, 1, 2], "n": [-1, 1, 2]})
    assert_pass(t, C().is_non_negative("z"))
    assert_fail(t, C().is_non_negative("n"))
    assert_pass(t, C().is_positive("p"))
    assert_fail(t, C().is_positive("z"))


def test_inequality_checks():
    df = port_table(ref_df_with_numeric_values())  # att3 <= att2 everywhere, equal on rows 1-3
    assert_pass(df, C().is_less_than_or_equal_to("att3", "att2"))
    assert_fail(df, C().is_less_than("att3", "att2"))  # equal on some rows
    assert_pass(df, C().is_greater_than_or_equal_to("att2", "att3"))
    assert_fail(df, C().is_greater_than("att2", "att3"))


def test_is_contained_in():
    assert_pass(port_table(ref_df_full()), C().is_contained_in("att1", ["a", "b"]))
    assert_fail(port_table(ref_df_full()), C().is_contained_in("att1", ["a"]))


def test_is_contained_in_numeric_range():
    df = port_table(ref_df_with_numeric_values())
    assert_pass(
        df,
        C().is_contained_in(
            "att1", lower_bound=1.0, upper_bound=6.0
        ),
    )
    assert_fail(
        df,
        C().is_contained_in("att1", lower_bound=2.0, upper_bound=6.0),
    )


def test_where_filter_on_last_constraint():
    df = port_table(ref_df_missing())
    # att1 is complete on items 1-2 only
    check = C().is_complete("att1").where("item IN ('1', '2')")
    assert_pass(df, check)


def test_check_level_warning():
    check = Check(CheckLevel.WARNING, "w").has_size(lambda n: n == 99)
    assert status_of(port_table(ref_df_full()), check) == CheckStatus.WARNING


def test_is_newest_point_non_anomalous():
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.anomaly import AbsoluteChangeStrategy
    from deequ_tpu_torch.repository import AnalysisResult, ResultKey
    from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository

    repo = InMemoryMetricsRepository()
    t = port_table(ref_df_full())
    for ts in range(3):
        ctx = AnalysisRunner.do_analysis_run(t, [Size()], device="cpu")
        repo.save(AnalysisResult(ResultKey(ts, {}), ctx))
    check = C().is_newest_point_non_anomalous(
        repo, AbsoluteChangeStrategy(max_rate_increase=1.0), Size(), {},
        None, None,
    )
    assert_pass(t, check)
