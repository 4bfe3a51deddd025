"""The expression DSL in the port (``deequ_tpu_torch/expr/``): the twins of
the 16 tests of tests/test_expr.py, on CPU torch — the parser, SQL
three-valued evaluation through ``eval_predicate_on_table`` (each mask
held also against the reference's on the same table), and predicates in
the fused scan.

The reference marks the fractional columns a comparison reads so its
packer moves them off its (hi, lo) f32 pair onto its exact f64 plane
(``_mark_exact_compare_columns``), and warns where a persisted pair
layout cannot move. The port packs every numeric column as f64 — in
memory, persisted and streamed — so the three twins of those tests hold
the port to the exact answers with no mark, and a persisted table warns
of nothing.
"""

import warnings

import numpy as np
import pytest

from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.expr.eval import eval_predicate_on_table as ref_eval_predicate
from deequ_tpu_torch import stream_table, use_device
from deequ_tpu_torch.analyzers import Compliance, Mean
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.expr.eval import eval_predicate_on_table
from deequ_tpu_torch.expr.parser import ExprSyntaxError, parse_expression

pytestmark = pytest.mark.torch_port

DATA = {
    "a": [1.0, 2.0, None, 4.0],
    "b": [10.0, None, 30.0, 40.0],
    "s": ["x", "y", None, "x"],
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture
def table():
    return ColumnarTable.from_pydict(DATA)


def mask(expr, table, data=DATA):
    """The port's mask, held against the reference's on the same data."""
    got = eval_predicate_on_table(expr, table).tolist()
    assert got == ref_eval_predicate(expr, RefTable.from_pydict(data)).tolist(), expr
    return got


def test_comparisons(table):
    assert mask("a > 1", table) == [False, True, False, True]
    assert mask("a >= 2", table) == [False, True, False, True]
    assert mask("a = 2", table) == [False, True, False, False]
    assert mask("a != 2", table) == [True, False, False, True]


def test_null_propagation(table):
    # a null comparison is never true under WHERE semantics
    assert mask("a < b", table) == [True, False, False, True]


def test_is_null(table):
    assert mask("a IS NULL", table) == [False, False, True, False]
    assert mask("a IS NOT NULL", table) == [True, True, False, True]
    assert mask("s IS NULL", table) == [False, False, True, False]


def test_boolean_logic(table):
    assert mask("a > 1 AND b > 20", table) == [False, False, False, True]
    assert mask("a > 1 OR b > 20", table) == [False, True, True, True]
    assert mask("NOT (a > 1)", table) == [True, False, False, False]


def test_string_ops(table):
    assert mask("s = 'x'", table) == [True, False, False, True]
    assert mask("s IN ('x', 'y')", table) == [True, True, False, True]
    assert mask("s LIKE 'x%'", table) == [True, False, False, True]
    assert mask("s RLIKE '^[xy]$'", table) == [True, True, False, True]


def test_arithmetic(table):
    assert mask("a + 1 > 2", table) == [False, True, False, True]
    assert mask("a * 10 = b", table) == [True, False, False, True]
    assert mask("a % 2 = 0", table) == [False, True, False, True]


def test_division_by_zero_is_null(table):
    assert mask("a / 0 > 0", table) == [False, False, False, False]


def test_between_and_coalesce(table):
    assert mask("a BETWEEN 2 AND 4", table) == [False, True, False, True]
    assert mask("COALESCE(a, 0.0) >= 0", table) == [True, True, True, True]
    assert mask("COALESCE(a, -1) < 0", table) == [False, False, True, False]


def test_length_function(table):
    assert mask("length(s) = 1", table) == [True, True, False, True]


def test_backquoted_columns(table):
    assert mask("`a` > 1", table) == [False, True, False, True]


def test_syntax_errors():
    with pytest.raises(ExprSyntaxError):
        parse_expression("a >")
    with pytest.raises(ExprSyntaxError):
        parse_expression("a ! b")
    with pytest.raises(ExprSyntaxError):
        parse_expression("(a > 1")


def test_string_column_vs_string_column():
    data = {"a": ["x", "y", "z", None], "b": ["x", "q", "z", "z"]}
    t = ColumnarTable.from_pydict(data)
    assert mask("a = b", t, data) == [True, False, True, False]
    assert mask("a != b", t, data) == [False, True, False, False]
    assert mask("a <= b", t, data) == [True, False, True, False]
    assert mask("a > b", t, data) == [False, True, False, False]


def test_quote_in_string_literal():
    data = {"name": ["O'Brien", "Smith"]}
    t = ColumnarTable.from_pydict(data)
    assert mask(r"name = 'O\'Brien'", t, data) == [True, False]


_PAIR_UNSAFE = np.array([0.1, 0.2, 0.3, 0.1, 5.0, 1 / 3])


def test_equality_predicate_exact_on_pair_unsafe_values():
    """x == 0.1 and the boundaries at 1/3 match exactly: the port's scan
    packs x as f64 (the reference needs its exact-compare mark for that),
    and an aggregate of another column keeps its f64 value too."""
    t = ColumnarTable([
        Column("x", DType.FRACTIONAL, values=_PAIR_UNSAFE),
        Column("y", DType.FRACTIONAL, values=_PAIR_UNSAFE + 1.0),
    ])
    analyzers = [
        Compliance("eq", "x == 0.1"),
        Compliance("ge", "x >= 1/3"),
        Compliance("bt", "x between 0.1 and 1/3"),
        Mean("y"),
    ]
    ctx = AnalysisRunner.do_analysis_run(t, analyzers)
    assert ctx.metric_map[analyzers[0]].value.get() == 2 / 6
    assert ctx.metric_map[analyzers[1]].value.get() == 2 / 6
    assert ctx.metric_map[analyzers[2]].value.get() == 5 / 6
    assert abs(ctx.metric_map[analyzers[3]].value.get() - np.mean(_PAIR_UNSAFE + 1.0)) < 1e-12
    # no routing mark: every column is on the f64 plane already
    assert not hasattr(t["x"], "_exact_compare")


def test_pinned_pair_layout_with_comparison_warns():
    """A table persisted before the predicate was declared: the reference
    keeps its pair layout and warns of the boundary caveat. The port's
    resident layout is f64, so the comparison is exact and nothing warns."""
    t = ColumnarTable([Column("x", DType.FRACTIONAL, values=_PAIR_UNSAFE)])
    t.persist("cpu", max_bytes=1 << 20)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx = AnalysisRunner.do_analysis_run(t, [Compliance("eq", "x == 0.1")])
        assert not [w for w in caught if "two-float" in str(w.message)]
        assert ctx.metric_map[Compliance("eq", "x == 0.1")].value.get() == 2 / 6
    finally:
        t.unpersist()


def test_equality_predicate_exact_on_streaming_table():
    """x == 0.1 matches exactly out of core too, over uneven batches; the
    stream carries no mark (its batches pack f64 as every table's do)."""
    t = ColumnarTable([Column("x", DType.FRACTIONAL, values=np.tile(_PAIR_UNSAFE, 500))])
    st = stream_table(t, batch_rows=700)
    ctx = AnalysisRunner.do_analysis_run(st, [Compliance("eq", "x == 0.1")])
    assert ctx.metric_map[Compliance("eq", "x == 0.1")].value.get() == 2 / 6
    assert not hasattr(st, "_exact_compare_names")
