"""The port's row-level schema validator and applicability checker
(``deequ_tpu_torch/schema``, ``deequ_tpu_torch/applicability.py``) against
the reference's on the CPU: the twins of the 8 tests of
tests/test_schema_and_applicability.py, and more.

- validation splits identical row for row: every column of the valid and
  the invalid rows, values, nulls and types, equal to the reference's;
- the random table of ``generate_random_data`` identical in both packages
  (the same ``random.Random(42)`` draws), and each applicability verdict,
  failure and constraint verdict the reference's;
- valid rows verified by the port's ``VerificationSuite``.
"""

import numpy as np
import pytest
import torch

import deequ_tpu
import deequ_tpu.applicability as ref_applicability
import deequ_tpu.schema as ref_schema
import deequ_tpu_torch
import deequ_tpu_torch.applicability as port_applicability
from deequ_tpu.data.table import DType as RefDType
from deequ_tpu.data.table import Field as RefField
from deequ_tpu.data.table import Schema as RefSchema
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import Check, CheckLevel, ColumnarTable, VerificationSuite, use_device
from deequ_tpu_torch.data.table import DType, Field, Schema
from deequ_tpu_torch.schema import RowLevelSchema, RowLevelSchemaValidator

pytestmark = pytest.mark.torch_port

RAW = {
    "id": ["1", "2", "three", "4", None],
    "name": ["ab", "x", "cdef", "ghij", "kl"],
    "dec": ["1.23", "4.5", "6.789", "bad", "0.1"],
    "ts": ["2024-01-01", "2024-02-30", "2024-03-03", "nope", "2024-05-05"],
}


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


@pytest.fixture
def raw_table():
    return ColumnarTable.from_pydict(RAW)


def _rows(table):
    return {name: (table[name].dtype.value, table[name].to_pylist())
            for name in table.column_names}


def _validate_both(build):
    """The port's validation result, held row for row against the
    reference's over the same raw table and schema; ``build`` makes the
    schema from a package's RowLevelSchema."""
    port = RowLevelSchemaValidator.validate(ColumnarTable.from_pydict(RAW),
                                            build(RowLevelSchema()))
    ref = ref_schema.RowLevelSchemaValidator.validate(
        deequ_tpu.ColumnarTable.from_pydict(RAW), build(ref_schema.RowLevelSchema()))
    assert (port.num_valid_rows, port.num_invalid_rows) == (
        ref.num_valid_rows, ref.num_invalid_rows)
    assert _rows(port.valid_rows) == _rows(ref.valid_rows)
    assert _rows(port.invalid_rows) == _rows(ref.invalid_rows)
    return port


def test_int_column_validation(raw_table):
    result = _validate_both(lambda s: s.with_int_column("id", is_nullable=False))
    assert result.num_valid_rows == 3
    assert result.num_invalid_rows == 2
    assert result.valid_rows["id"].dtype == DType.INTEGRAL
    assert result.valid_rows["id"].to_pylist() == [1, 2, 4]


def test_int_bounds(raw_table):
    result = _validate_both(lambda s: s.with_int_column("id", min_value=2, max_value=10))
    assert result.num_valid_rows == 3


def test_string_length_and_regex(raw_table):
    result = _validate_both(lambda s: s.with_string_column("name", min_length=2, max_length=4))
    assert result.num_valid_rows == 4
    result2 = _validate_both(lambda s: s.with_string_column("name", matches="^[a-f]+$"))
    assert result2.num_valid_rows == 2


def test_decimal_column(raw_table):
    result = _validate_both(lambda s: s.with_decimal_column("dec", precision=4, scale=3))
    assert result.num_valid_rows == 4
    assert result.valid_rows["dec"].dtype == DType.FRACTIONAL


def test_timestamp_column(raw_table):
    result = _validate_both(lambda s: s.with_timestamp_column("ts", mask="yyyy-MM-dd"))
    assert result.num_valid_rows == 3
    assert result.valid_rows["ts"].dtype == DType.INTEGRAL


def test_combined_schema_quarantine(raw_table):
    result = _validate_both(lambda s: s.with_int_column("id", is_nullable=False)
                            .with_string_column("name", min_length=2))
    assert result.num_valid_rows + result.num_invalid_rows == raw_table.num_rows
    assert result.invalid_rows["id"].dtype == DType.STRING


def _applicability_rows(result):
    return (result.is_applicable,
            [(name, type(exc).__name__, str(exc)) for name, exc in result.failures])


def test_check_applicability():
    schema = Schema([Field("item", DType.STRING), Field("count", DType.INTEGRAL)])
    ref_schema_ = RefSchema([RefField("item", RefDType.STRING),
                             RefField("count", RefDType.INTEGRAL)])
    cases = [
        lambda pkg: pkg.Check(pkg.CheckLevel.ERROR, "ok").is_complete("item")
        .has_min("count", lambda v: v > 0),
        lambda pkg: pkg.Check(pkg.CheckLevel.ERROR, "bad").has_min("item", lambda v: v > 0),
    ]
    verdicts = []
    for case in cases:
        port = VerificationSuite.is_check_applicable_to_data(case(deequ_tpu_torch), schema)
        with use_mesh(None):
            ref = deequ_tpu.VerificationSuite.is_check_applicable_to_data(
                case(deequ_tpu), ref_schema_)
        assert _applicability_rows(port) == _applicability_rows(ref)
        assert port.constraint_applicabilities == ref.constraint_applicabilities
        verdicts.append(port)
    assert verdicts[0].is_applicable
    assert not verdicts[1].is_applicable
    assert len(verdicts[1].failures) == 1


def test_analyzers_applicability():
    import deequ_tpu.analyzers as ref_an
    import deequ_tpu_torch.analyzers as port_an

    schema = Schema([Field("x", DType.FRACTIONAL), Field("s", DType.STRING)])
    ref_schema_ = RefSchema([RefField("x", RefDType.FRACTIONAL),
                             RefField("s", RefDType.STRING)])
    for build, applicable in (
        (lambda an: [an.Completeness("x"), an.Mean("x")], True),
        (lambda an: [an.Mean("s")], False),
    ):
        port = VerificationSuite.are_analyzers_applicable_to_data(build(port_an), schema)
        with use_mesh(None):
            ref = deequ_tpu.VerificationSuite.are_analyzers_applicable_to_data(
                build(ref_an), ref_schema_)
        assert port.is_applicable is applicable
        assert _applicability_rows(port) == _applicability_rows(ref)


# -- beyond the twins ----------------------------------------------------------


def test_generate_random_data_identical():
    """Every column of the random table, value for value, both packages:
    one of each type, nullable and not."""
    specs = [("s", "STRING", True), ("i", "INTEGRAL", True), ("b", "BOOLEAN", False),
             ("f", "FRACTIONAL", True), ("g", "FRACTIONAL", False)]
    port = port_applicability.generate_random_data(
        Schema([Field(n, DType[t], nullable) for n, t, nullable in specs]))
    ref = ref_applicability.generate_random_data(
        RefSchema([RefField(n, RefDType[t], nullable) for n, t, nullable in specs]))
    assert port.num_rows == port_applicability.NUM_RECORDS == 1000
    assert _rows(port) == _rows(ref)


def test_validation_split_and_verify_seeded():
    """A 20,000-row raw table from a seed (integers with junk, decimals,
    dates with invalid days, codes against a pattern): the same split as
    the reference's row for row, and the valid rows verified on the port."""
    rng = np.random.default_rng(11)
    n = 20_000
    ids = [str(v) if rng.random() > 0.03 else "x" + str(v)
           for v in rng.integers(-50, 5000, size=n)]
    ids = [None if rng.random() < 0.01 else v for v in ids]
    amounts = [f"{v:.3f}" if rng.random() > 0.02 else "n/a"
               for v in rng.normal(100, 80, size=n)]
    days = [f"2024-{m:02d}-{d:02d}" for m, d in zip(rng.integers(1, 13, size=n),
                                                   rng.integers(1, 32, size=n))]
    codes = ["".join(rng.choice(list("ABCXYZ09"), size=rng.integers(2, 7)))
             for _ in range(n)]
    raw = {"id": ids, "amount": amounts, "day": days, "code": codes}

    def build(s):
        return (s.with_int_column("id", is_nullable=False, min_value=0, max_value=4000)
                .with_decimal_column("amount", precision=6, scale=3)
                .with_timestamp_column("day", mask="yyyy-MM-dd")
                .with_string_column("code", min_length=3, matches="^[A-Z]"))

    port = RowLevelSchemaValidator.validate(ColumnarTable.from_pydict(raw),
                                            build(RowLevelSchema()))
    ref = ref_schema.RowLevelSchemaValidator.validate(
        deequ_tpu.ColumnarTable.from_pydict(raw), build(ref_schema.RowLevelSchema()))
    assert 0 < port.num_valid_rows < n
    assert _rows(port.valid_rows) == _rows(ref.valid_rows)
    assert _rows(port.invalid_rows) == _rows(ref.invalid_rows)

    valid = port.valid_rows
    check = (Check(CheckLevel.ERROR, "quarantined")
             .has_size(lambda v: v == valid.num_rows)
             .is_complete("id").is_non_negative("id")
             .has_max("id", lambda v: v <= 4000))
    result = VerificationSuite.on_data(valid).add_check(check).run()
    assert result.device == "cpu"
    assert result.status == deequ_tpu_torch.CheckStatus.SUCCESS
