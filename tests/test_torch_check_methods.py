"""Port twins of the reference's Check-method tests
(tests/test_check_methods.py) for the methods that build on frequency
tables and the string analyzers: has_number_of_distinct_values,
has_histogram_values, has_mutual_information, has_min_length,
has_max_length, has_pattern, the four contains_* methods and
has_data_type. Each runs a VerificationSuite of the port on the CPU over
the reference's fixture tables (tests/fixtures.py, the same arrays) and
asserts the same outcome the reference test asserts."""

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
    ref_df_variable_string_lengths,
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


def assert_fail(table, check):
    assert run(table, check).status == CheckStatus.ERROR


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
