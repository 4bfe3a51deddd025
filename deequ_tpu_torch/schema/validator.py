"""Row-level schema enforcement, the quarantine workflow (reference
schema/RowLevelSchemaValidator.scala:25-282; the port's copy of
``deequ_tpu/schema/validator.py``, host code).

A declarative schema over string-typed input columns; ``validate`` builds
one conjunctive row-match mask (the reference's CNF boolean column),
splits the data into valid and invalid rows, and casts the valid rows to
the declared types. Both are host ``ColumnarTable``s, which a
verification run then checks on its device.

Each column's predicates (castability, length and value bounds, regex,
timestamp mask) are evaluated once a distinct dictionary value on the
host and broadcast to the rows through the int32 codes; the conjunction
over rows is numpy.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnarTable, DType


@dataclass(frozen=True)
class ColumnDefinition:
    name: str
    is_nullable: bool = True


@dataclass(frozen=True)
class StringColumnDefinition(ColumnDefinition):
    min_length: Optional[int] = None
    max_length: Optional[int] = None
    matches: Optional[str] = None


@dataclass(frozen=True)
class IntColumnDefinition(ColumnDefinition):
    min_value: Optional[int] = None
    max_value: Optional[int] = None


@dataclass(frozen=True)
class DecimalColumnDefinition(ColumnDefinition):
    precision: int = 10
    scale: int = 0


@dataclass(frozen=True)
class TimestampColumnDefinition(ColumnDefinition):
    mask: str = "yyyy-MM-dd"


# Java SimpleDateFormat -> python strptime translation for common tokens
_JAVA_TO_STRPTIME = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"),
]


def java_mask_to_strptime(mask: str) -> str:
    out = mask
    for java, py in _JAVA_TO_STRPTIME:
        out = out.replace(java, py)
    return out


class RowLevelSchema:
    """Fluent schema builder (reference schema/RowLevelSchemaValidator.scala:
    72-151)."""

    def __init__(self, column_definitions: Sequence[ColumnDefinition] = ()):
        self.column_definitions: List[ColumnDefinition] = list(column_definitions)

    def with_string_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_length: Optional[int] = None,
        max_length: Optional[int] = None,
        matches: Optional[str] = None,
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [StringColumnDefinition(name, is_nullable, min_length, max_length, matches)]
        )

    def with_int_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_value: Optional[int] = None,
        max_value: Optional[int] = None,
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [IntColumnDefinition(name, is_nullable, min_value, max_value)]
        )

    def with_decimal_column(
        self, name: str, precision: int, scale: int, is_nullable: bool = True
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [DecimalColumnDefinition(name, is_nullable, precision, scale)]
        )

    def with_timestamp_column(
        self, name: str, mask: str, is_nullable: bool = True
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions + [TimestampColumnDefinition(name, is_nullable, mask)]
        )


@dataclass
class RowLevelSchemaValidationResult:
    valid_rows: ColumnarTable
    num_valid_rows: int
    invalid_rows: ColumnarTable
    num_invalid_rows: int


_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")


def _decimal_parseable(value: str, precision: int, scale: int) -> bool:
    try:
        from decimal import Decimal, InvalidOperation

        d = Decimal(value.strip())
    except (InvalidOperation, ValueError, ArithmeticError):
        return False
    # digits before the decimal point must fit precision - scale
    sign, digits, exponent = d.as_tuple()
    if not isinstance(exponent, int):
        return False
    integral_digits = max(len(digits) + exponent, 0)
    return integral_digits <= precision - scale


def _column_str_values(col: Column) -> tuple:
    """Return (per-distinct string values, codes, is_null) for any column."""
    if col.dtype == DType.STRING:
        return col.dictionary, np.maximum(col.codes, 0), col.codes < 0
    # typed columns: stringify values (rare path; schema enforcement targets
    # textual data per the reference)
    values = np.array([str(v) for v in col.values], dtype=object)
    uniques, codes = np.unique(values.astype(str), return_inverse=True)
    return uniques.astype(object), codes.astype(np.int32), ~col.mask


class RowLevelSchemaValidator:
    @staticmethod
    def validate(
        data: ColumnarTable, schema: RowLevelSchema
    ) -> RowLevelSchemaValidationResult:
        matches = np.ones(data.num_rows, dtype=np.bool_)

        for col_def in schema.column_definitions:
            if col_def.name not in data:
                raise ValueError(f"Unable to find column {col_def.name}")
            col = data[col_def.name]
            values, codes, is_null = _column_str_values(col)

            if not col_def.is_nullable:
                matches &= ~is_null

            def lut_ok(fn) -> np.ndarray:
                lut = np.array(
                    [bool(fn(v)) for v in values], dtype=np.bool_
                ) if len(values) else np.zeros(1, dtype=np.bool_)
                ok = lut[codes]
                return is_null | ok  # null passes per-value predicates (CNF)

            if isinstance(col_def, IntColumnDefinition):
                matches &= lut_ok(lambda v: _INT_RE.match(str(v)) is not None)
                if col_def.min_value is not None:
                    matches &= lut_ok(
                        lambda v: _INT_RE.match(str(v)) is not None
                        and int(v) >= col_def.min_value
                    )
                if col_def.max_value is not None:
                    matches &= lut_ok(
                        lambda v: _INT_RE.match(str(v)) is not None
                        and int(v) <= col_def.max_value
                    )
            elif isinstance(col_def, DecimalColumnDefinition):
                matches &= lut_ok(
                    lambda v: _decimal_parseable(
                        str(v), col_def.precision, col_def.scale
                    )
                )
            elif isinstance(col_def, TimestampColumnDefinition):
                fmt = java_mask_to_strptime(col_def.mask)

                def ts_ok(v, fmt=fmt):
                    try:
                        datetime.strptime(str(v), fmt)
                        return True
                    except ValueError:
                        return False

                matches &= lut_ok(ts_ok)
            elif isinstance(col_def, StringColumnDefinition):
                if col_def.min_length is not None:
                    matches &= lut_ok(lambda v: len(str(v)) >= col_def.min_length)
                if col_def.max_length is not None:
                    matches &= lut_ok(lambda v: len(str(v)) <= col_def.max_length)
                if col_def.matches is not None:
                    rx = re.compile(col_def.matches)
                    matches &= lut_ok(lambda v: rx.search(str(v)) is not None)

        valid = data.filter_rows(matches)
        invalid = data.filter_rows(~matches)

        valid = RowLevelSchemaValidator._cast_valid_rows(valid, schema)

        return RowLevelSchemaValidationResult(
            valid, valid.num_rows, invalid, invalid.num_rows
        )

    @staticmethod
    def _cast_valid_rows(
        valid: ColumnarTable, schema: RowLevelSchema
    ) -> ColumnarTable:
        """Cast validated columns to their declared types
        (reference extractAndCastValidRows, scala L209-223)."""
        out = valid
        for col_def in schema.column_definitions:
            col = valid[col_def.name]
            values, codes, is_null = _column_str_values(col)
            card = max(len(values), 1)
            if isinstance(col_def, IntColumnDefinition):
                lut = np.zeros(card, dtype=np.int64)
                for i, v in enumerate(values):
                    try:
                        lut[i] = int(str(v).strip())
                    except ValueError:
                        pass
                out = out.with_column(
                    Column(col_def.name, DType.INTEGRAL,
                           values=lut[codes], mask=~is_null)
                )
            elif isinstance(col_def, DecimalColumnDefinition):
                lut = np.zeros(card, dtype=np.float64)
                for i, v in enumerate(values):
                    try:
                        lut[i] = float(str(v).strip())
                    except ValueError:
                        pass
                out = out.with_column(
                    Column(col_def.name, DType.FRACTIONAL,
                           values=lut[codes], mask=~is_null)
                )
            elif isinstance(col_def, TimestampColumnDefinition):
                fmt = java_mask_to_strptime(col_def.mask)
                lut = np.zeros(card, dtype=np.int64)
                for i, v in enumerate(values):
                    try:
                        parsed = datetime.strptime(str(v), fmt).replace(
                            tzinfo=timezone.utc  # machine-TZ independence
                        )
                        lut[i] = int(parsed.timestamp() * 1000)
                    except ValueError:
                        pass
                out = out.with_column(
                    Column(col_def.name, DType.INTEGRAL,
                           values=lut[codes], mask=~is_null)
                )
        return out
