"""Columnar in-memory table — the engine's data substrate.

Each column is a contiguous numpy array plus a validity mask; strings are
dictionary-encoded (int32 codes into a host-side array of distinct
values), so all device work happens on fixed-width numeric tensors and
per-distinct-value host work (predicates over strings) is
O(cardinality) instead of O(rows).

The table lives on the host; the scan engine moves each chunk of it to
the card once per pass (ops/scan_engine.py), unless ``persist()`` packed
it onto the device once: every later scan then walks the resident chunks.
A numeric column may carry a dictionary encoding (``encode()``, a
:class:`ColumnChunk` of int16 codes): it then rides the scan's 2-byte
code plane, resident or streamed, and its full-width values decode on
the host only when something asks for them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: widest dictionary an encoded column may carry: codes are int16 (null =
#: -1), so the dictionary indexes [0, 2^15)
MAX_ENCODED_CARDINALITY = (1 << 15) - 1


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


@dataclass
class ColumnChunk:
    """A numeric column in dictionary-encoded form (the reference's
    ``ColumnChunk``):

    - ``codes``: int16 indices into ``dictionary``, -1 for a null row;
    - ``dictionary``: the distinct values (float64 or int64), at most
      :data:`MAX_ENCODED_CARDINALITY` of them;
    - ``validity``: the null bitmap packed with ``np.packbits``, or None
      when every row is valid.
    """

    codes: np.ndarray
    dictionary: np.ndarray
    validity: Optional[np.ndarray]
    num_rows: int

    def mask(self) -> np.ndarray:
        """The validity bitmap as a bool row mask."""
        if self.validity is None:
            return np.ones(self.num_rows, dtype=np.bool_)
        return np.unpackbits(self.validity, count=self.num_rows).astype(np.bool_)

    def decode(self, np_dtype) -> Tuple[np.ndarray, np.ndarray]:
        """(values, mask): a host gather of the dictionary, null rows 0 —
        the full-width form of the column."""
        mask = self.mask()
        if len(self.dictionary) == 0:
            return np.zeros(self.num_rows, dtype=np_dtype), mask
        safe = np.where(mask, self.codes, 0).astype(np.int64)
        values = self.dictionary[safe].astype(np_dtype)
        return np.where(mask, values, values.dtype.type(0)), mask

    def take(self, indices: np.ndarray) -> "ColumnChunk":
        codes = self.codes[indices]
        valid = codes >= 0
        return ColumnChunk(
            codes, self.dictionary,
            None if bool(valid.all()) else np.packbits(valid), len(codes),
        )

    @staticmethod
    def from_values(
        values: np.ndarray,
        mask: np.ndarray,
        max_cardinality: int = MAX_ENCODED_CARDINALITY,
    ) -> Optional["ColumnChunk"]:
        """Dictionary-encode decoded values, or None when more than
        ``max_cardinality`` distinct values (and never more than int16
        codes can index) would need codes. Valid NaNs share one NaN entry
        (the last) and stay valid."""
        valid = np.asarray(mask, dtype=np.bool_)
        vals = np.asarray(values)[valid]
        is_float = np.issubdtype(vals.dtype, np.floating)
        nan_rows = np.isnan(vals) if is_float else np.zeros(len(vals), dtype=bool)
        finite = vals[~nan_rows]
        dictionary = np.unique(finite)
        has_nan = bool(nan_rows.any())
        if len(dictionary) + has_nan > min(max_cardinality, 1 << 15):
            return None
        inner = np.empty(len(vals), dtype=np.int64)
        inner[~nan_rows] = np.searchsorted(dictionary, finite)
        if has_nan:
            dictionary = np.concatenate([dictionary, [np.nan]])
            inner[nan_rows] = len(dictionary) - 1
        codes = np.full(len(valid), -1, dtype=np.int16)
        codes[valid] = inner.astype(np.int16)
        return ColumnChunk(
            codes, dictionary,
            None if bool(valid.all()) else np.packbits(valid), len(valid),
        )


class Column:
    """One column: numeric/bool columns hold ``values`` + ``mask`` (True =
    valid); string columns hold int32 ``codes`` (-1 = null) +
    ``dictionary`` of distinct values. A numeric column may instead carry
    an ``encoded`` :class:`ColumnChunk`: ``values`` and ``mask`` then
    decode from it on first access, while the scan reads the codes."""

    def __init__(
        self,
        name: str,
        dtype: DType,
        values: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        codes: Optional[np.ndarray] = None,
        dictionary: Optional[np.ndarray] = None,
        encoded: Optional[ColumnChunk] = None,
    ):
        self.name = name
        self.dtype = dtype
        self.encoding: Optional[ColumnChunk] = None
        self.codes = None
        self.dictionary = None
        if dtype == DType.STRING:
            if codes is None or dictionary is None:
                raise ValueError(f"string column {name} needs codes + dictionary")
            self.codes = np.asarray(codes, dtype=np.int32)
            self.dictionary = np.asarray(dictionary, dtype=object)
            self._values = None
            self._mask = self.codes >= 0
        elif encoded is not None:
            if not dtype.is_numeric or values is not None or mask is not None:
                raise ValueError(
                    f"column {name}: an encoding replaces values and mask of a "
                    f"numeric column"
                )
            self.encoding = encoded
            self._values = None
            self._mask = None
        else:
            if values is None:
                raise ValueError(f"column {name} needs values")
            self._values = np.asarray(values, dtype=_NP_DTYPES[dtype])
            self._mask = (
                np.ones(len(self._values), dtype=np.bool_)
                if mask is None
                else np.asarray(mask, dtype=np.bool_)
            )
            if self._mask.shape != self._values.shape:
                raise ValueError(f"column {name}: mask and values differ in shape")

    @property
    def values(self) -> Optional[np.ndarray]:
        if self._values is None and self.encoding is not None:
            self._values, self._mask = self.encoding.decode(_NP_DTYPES[self.dtype])
        return self._values

    @property
    def mask(self) -> np.ndarray:
        if self._mask is None and self.encoding is not None:
            # the bitmap alone: reading validity decodes no values
            self._mask = self.encoding.mask()
        return self._mask

    def encode(self, max_cardinality: int = MAX_ENCODED_CARDINALITY) -> bool:
        """Attach a dictionary encoding built from the values. True when
        the column carries one now; False for a string or boolean column
        or one with more than ``max_cardinality`` distinct values."""
        if self.encoding is not None:
            return True
        if not self.dtype.is_numeric:
            return False
        enc = ColumnChunk.from_values(self._values, self._mask, max_cardinality)
        if enc is None:
            return False
        self.encoding = enc
        return True

    def __len__(self) -> int:
        if self.dtype == DType.STRING:
            return len(self.codes)
        if self._values is None and self.encoding is not None:
            return self.encoding.num_rows
        return len(self._values)

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
        if self.encoding is not None:
            return Column(self.name, self.dtype, encoded=self.encoding.take(indices))
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
        self._device_cache = None  # set by persist()

    # -- device residency ---------------------------------------------------

    def persist(
        self, device=None, encode: Optional[bool] = None,
        max_bytes: Optional[int] = None,
    ) -> "ColumnarTable":
        """Pack every column and copy it to ``device`` once (default:
        ``cuda``, or the ambient ``use_device`` scope); every later scan
        of this table on that device walks the resident chunks and packs
        and copies nothing. Encoded columns stay encoded on the device
        unless ``encode=False``. ``max_bytes`` caps the combined resident
        bytes of every persisted table (default on a card: a fixed share
        of its memory, ``scan_engine.RESIDENT_FRACTION``; the CPU has no
        default). Raises MemoryError past the cap."""
        from deequ_tpu_torch.ops.scan_engine import persist_table

        persist_table(self, device, max_bytes=max_bytes, encode=encode)
        return self

    def unpersist(self) -> "ColumnarTable":
        """Free the resident chunks now (not at the next garbage
        collection) and take them off the resident budget."""
        from deequ_tpu_torch.ops.scan_engine import _evict_device_cache

        _evict_device_cache(self)
        return self

    @property
    def is_persisted(self) -> bool:
        return self._device_cache is not None

    def encode(
        self,
        columns: Optional[Sequence[str]] = None,
        max_cardinality: int = MAX_ENCODED_CARDINALITY,
    ) -> "ColumnarTable":
        """Attach dictionary encodings to the named (default: all) numeric
        columns that take one; the others stay as they are. Encode before
        ``persist()``: residency packs the form each column has then."""
        for name in (list(columns) if columns is not None else self.column_names):
            self.columns[name].encode(max_cardinality)
        return self

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
