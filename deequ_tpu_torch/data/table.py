"""Columnar in-memory table — the engine's data substrate.

Each column is a contiguous numpy array plus a validity mask; strings are
dictionary-encoded (int32 codes into a host-side array of distinct
values), so all device work happens on fixed-width numeric tensors and
per-distinct-value host work (predicates over strings) is
O(cardinality) instead of O(rows).

The table lives on the host; the scan engine moves each chunk of it to
the card once per pass (ops/scan_engine.py). Device residency
(``persist()``) and dictionary-encoded numeric columns (``encode()``)
wait for a later slice of the port.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np


class DType(enum.Enum):
    FRACTIONAL = "fractional"  # float64
    INTEGRAL = "integral"      # int64
    BOOLEAN = "boolean"
    STRING = "string"

    @property
    def is_numeric(self) -> bool:
        return self in (DType.FRACTIONAL, DType.INTEGRAL)


_NP_DTYPES = {
    DType.FRACTIONAL: np.float64,
    DType.INTEGRAL: np.int64,
    DType.BOOLEAN: np.bool_,
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)
        self._by_name = {f.name: f for f in self.fields}

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str) -> Field:
        return self._by_name[name]

    def __iter__(self):
        return iter(self.fields)

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.dtype.value}" for f in self.fields)
        return f"Schema({inner})"


class Column:
    """One column: numeric/bool columns hold ``values`` + ``mask`` (True =
    valid); string columns hold int32 ``codes`` (-1 = null) +
    ``dictionary`` of distinct values."""

    def __init__(
        self,
        name: str,
        dtype: DType,
        values: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        codes: Optional[np.ndarray] = None,
        dictionary: Optional[np.ndarray] = None,
    ):
        self.name = name
        self.dtype = dtype
        if dtype == DType.STRING:
            if codes is None or dictionary is None:
                raise ValueError(f"string column {name} needs codes + dictionary")
            self.codes = np.asarray(codes, dtype=np.int32)
            self.dictionary = np.asarray(dictionary, dtype=object)
            self.values = None
            self.mask = self.codes >= 0
        else:
            if values is None:
                raise ValueError(f"column {name} needs values")
            self.values = np.asarray(values, dtype=_NP_DTYPES[dtype])
            self.mask = (
                np.ones(len(self.values), dtype=np.bool_)
                if mask is None
                else np.asarray(mask, dtype=np.bool_)
            )
            if self.mask.shape != self.values.shape:
                raise ValueError(f"column {name}: mask and values differ in shape")
            self.codes = None
            self.dictionary = None

    def __len__(self) -> int:
        if self.dtype == DType.STRING:
            return len(self.codes)
        return len(self.values)

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())

    def numeric_values(self) -> np.ndarray:
        """Values as float64 with nulls zeroed (pair with .mask)."""
        if self.dtype == DType.STRING:
            raise TypeError(f"column {self.name} is not numeric")
        return np.where(self.mask, self.values.astype(np.float64), 0.0)

    def to_pylist(self) -> list:
        """Decode to a Python list with None for nulls (test/debug helper)."""
        if self.dtype == DType.STRING:
            return [
                self.dictionary[c] if c >= 0 else None for c in self.codes.tolist()
            ]
        return [
            v if m else None
            for v, m in zip(self.values.tolist(), self.mask.tolist())
        ]

    def take(self, indices: np.ndarray) -> "Column":
        if self.dtype == DType.STRING:
            return Column(
                self.name, self.dtype, codes=self.codes[indices],
                dictionary=self.dictionary,
            )
        return Column(
            self.name, self.dtype, values=self.values[indices], mask=self.mask[indices]
        )


def _infer_and_build(name: str, raw: Iterable) -> Column:
    """Build a Column from a Python sequence, inferring the dtype."""
    items = list(raw)
    non_null = [x for x in items if x is not None]
    mask = np.array([x is not None for x in items], dtype=np.bool_)
    if all(isinstance(x, bool) for x in non_null) and non_null:
        values = np.array([bool(x) if x is not None else False for x in items])
        return Column(name, DType.BOOLEAN, values=values, mask=mask)
    if all(isinstance(x, int) and not isinstance(x, bool) for x in non_null) and non_null:
        values = np.array([int(x) if x is not None else 0 for x in items], dtype=np.int64)
        return Column(name, DType.INTEGRAL, values=values, mask=mask)
    if all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in non_null) and non_null:
        values = np.array(
            [float(x) if x is not None else 0.0 for x in items], dtype=np.float64
        )
        return Column(name, DType.FRACTIONAL, values=values, mask=mask)
    # everything else (incl. all-null) is a string column
    return _string_column(name, [None if x is None else str(x) for x in items])


def _string_column(name: str, items: Sequence[Optional[str]]) -> Column:
    if len(items) == 0:
        return Column(name, DType.STRING, codes=np.array([], dtype=np.int32),
                      dictionary=np.array([], dtype=object))
    strings = np.array([x if x is not None else "" for x in items], dtype=object)
    is_null = np.array([x is None for x in items], dtype=np.bool_)
    dictionary, codes = np.unique(strings.astype(str), return_inverse=True)
    codes = codes.astype(np.int32)
    codes[is_null] = -1
    return Column(name, DType.STRING, codes=codes, dictionary=dictionary.astype(object))


class ColumnarTable:
    """An immutable columnar table. The unit the analysis engine consumes."""

    def __init__(self, columns: Sequence[Column]):
        self.columns: Dict[str, Column] = {c.name: c for c in columns}
        lengths = {len(c) for c in columns}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.num_rows = lengths.pop() if lengths else 0

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_pydict(data: Mapping[str, Iterable]) -> "ColumnarTable":
        return ColumnarTable([_infer_and_build(k, v) for k, v in data.items()])

    @staticmethod
    def from_rows(
        rows: Sequence[Sequence], column_names: Sequence[str]
    ) -> "ColumnarTable":
        cols = {name: [] for name in column_names}
        for row in rows:
            for name, v in zip(column_names, row):
                cols[name].append(v)
        return ColumnarTable.from_pydict(cols)

    @staticmethod
    def from_columns(columns: Sequence[Column]) -> "ColumnarTable":
        return ColumnarTable(columns)

    # -- schema / access ----------------------------------------------------

    @property
    def schema(self) -> Schema:
        return Schema([Field(c.name, c.dtype) for c in self.columns.values()])

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __len__(self) -> int:
        return self.num_rows

    def select(self, names: Sequence[str]) -> "ColumnarTable":
        return ColumnarTable([self.columns[n] for n in names])

    def filter_rows(self, keep: np.ndarray) -> "ColumnarTable":
        idx = np.nonzero(np.asarray(keep, dtype=bool))[0]
        return ColumnarTable([c.take(idx) for c in self.columns.values()])

    def head(self, n: int) -> "ColumnarTable":
        idx = np.arange(min(n, self.num_rows))
        return ColumnarTable([c.take(idx) for c in self.columns.values()])

    def __repr__(self) -> str:
        return f"ColumnarTable({self.num_rows} rows, {self.schema})"
