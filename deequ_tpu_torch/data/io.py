"""Reading and writing tables: CSV, Parquet, Arrow and pandas ->
ColumnarTable, and the streams of Parquet and CSV files (the port's copy
of ``deequ_tpu/data/io.py``).

A reader produces the columnar, dictionary-encoded table the scans
consume, on the host; the scans move it to the device. CSV goes through
the standard library's reader with type inference (an empty field is a
null); Parquet, Arrow and pandas through pyarrow and pandas. A numeric
Arrow DictionaryArray keeps its encoding (a :class:`ColumnChunk`), so it
rides the scans' 2-byte code plane undecoded.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.data.table import (
    MAX_ENCODED_CARDINALITY,
    Column,
    ColumnarTable,
    ColumnChunk,
    DType,
    _string_column,
)

# pyarrow CSV's boolean literals ('1'/'0' included). A column of 0/1 alone
# is claimed by the integer cast first; these decide only columns that mix
# word and digit literals, as pyarrow infers them.
_TRUE = {"true", "True", "TRUE", "1"}
_FALSE = {"false", "False", "FALSE", "0"}


def read_csv(
    path: str,
    delimiter: str = ",",
    header: bool = True,
    column_names: Optional[Sequence[str]] = None,
    infer_types: bool = True,
) -> ColumnarTable:
    """Read a CSV file into a ColumnarTable, each column typed by
    inference (integral, then fractional, then boolean, else string; an
    empty cell is null)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    if not rows:
        return ColumnarTable([])
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = column_names or [f"_c{i}" for i in range(len(rows[0]))]
    columns: Dict[str, list] = {name: [] for name in names}
    for row in rows:
        for i, name in enumerate(names):
            cell = row[i] if i < len(row) else ""
            columns[name].append(cell if cell != "" else None)
    return ColumnarTable([
        _build_typed_column(name, raw, infer_types) for name, raw in columns.items()
    ])


def _build_typed_column(name: str, raw: List[Optional[str]], infer: bool) -> Column:
    non_null = [v for v in raw if v is not None]
    if infer and non_null:
        mask = np.array([v is not None for v in raw])
        if all(_parses(int, v) for v in non_null):
            values = np.array([int(v) if v is not None else 0 for v in raw], dtype=np.int64)
            return Column(name, DType.INTEGRAL, values=values, mask=mask)
        if all(_parses(float, v) for v in non_null):
            values = np.array(
                [float(v) if v is not None else 0.0 for v in raw], dtype=np.float64
            )
            return Column(name, DType.FRACTIONAL, values=values, mask=mask)
        if all(v in _TRUE or v in _FALSE for v in non_null):
            values = np.array([v in _TRUE if v is not None else False for v in raw])
            return Column(name, DType.BOOLEAN, values=values, mask=mask)
    return _string_column(name, raw)


def _parses(kind, v: str) -> bool:
    try:
        kind(v)
        return True
    except ValueError:
        return False


def read_parquet(path: str, columns: Optional[Sequence[str]] = None) -> ColumnarTable:
    """Read a Parquet file through pyarrow."""
    import pyarrow.parquet as pq

    return from_arrow(pq.read_table(path, columns=list(columns) if columns else None))


def _from_arrow_dictionary(name: str, combined) -> Optional[Column]:
    """A Column carrying an Arrow DictionaryArray of numbers encoded, with
    no host decode (indices, dictionary and validity as a
    :class:`ColumnChunk`); None when it must be decoded instead: values
    that are not numbers, or more than ``MAX_ENCODED_CARDINALITY``."""
    import pyarrow as pa

    value_type = combined.type.value_type
    if pa.types.is_integer(value_type):
        dtype, np_dtype = DType.INTEGRAL, np.int64
    elif pa.types.is_floating(value_type):
        dtype, np_dtype = DType.FRACTIONAL, np.float64
    else:
        return None
    dictionary = np.asarray(combined.dictionary, dtype=np_dtype)
    if len(dictionary) > MAX_ENCODED_CARDINALITY:
        return None
    mask = ~np.asarray(combined.is_null())
    codes = np.asarray(combined.indices.fill_null(0))
    return Column(name, dtype, encoded=ColumnChunk.from_codes(codes, dictionary, mask=mask))


def from_arrow(table) -> ColumnarTable:
    """Convert a pyarrow Table. A floating NaN is null (as in
    ``from_pandas``), so it never enters a sum as 0.0; ±inf stays a
    value."""
    import pyarrow as pa

    cols = []
    for name, column in zip(table.column_names, table.columns):
        combined = column.combine_chunks()
        pa_type = combined.type
        if pa.types.is_dictionary(pa_type):
            encoded = _from_arrow_dictionary(name, combined)
            if encoded is not None:
                cols.append(encoded)
                continue
            combined = combined.cast(pa_type.value_type)
            pa_type = combined.type
        if pa.types.is_integer(pa_type):
            mask = ~np.asarray(combined.is_null())
            values = np.asarray(combined.fill_null(0), dtype=np.int64)
            cols.append(Column(name, DType.INTEGRAL, values=values, mask=mask))
        elif pa.types.is_floating(pa_type):
            arr = np.asarray(combined.fill_null(np.nan), dtype=np.float64)
            mask = ~np.isnan(arr)
            cols.append(Column(name, DType.FRACTIONAL, values=np.where(mask, arr, 0.0),
                               mask=mask))
        elif pa.types.is_boolean(pa_type):
            mask = ~np.asarray(combined.is_null())
            values = np.asarray(combined.fill_null(False), dtype=np.bool_)
            cols.append(Column(name, DType.BOOLEAN, values=values, mask=mask))
        else:
            strings = [None if v is None else str(v) for v in combined.to_pylist()]
            cols.append(_string_column(name, strings))
    return ColumnarTable(cols)


def to_arrow(table: ColumnarTable):
    """Convert a ColumnarTable to a pyarrow Table, nulls kept."""
    import pyarrow as pa

    arrays = {}
    for name in table.column_names:
        col = table[name]
        if col.dtype == DType.STRING:
            # decoded in Arrow from the codes and the dictionary, with no
            # Python string a row
            indices = pa.array(col.codes, mask=col.codes < 0)
            values = pa.array(list(col.dictionary), type=pa.string())
            arrays[name] = pa.DictionaryArray.from_arrays(
                indices, values).dictionary_decode()
        elif col.mask.all():
            arrays[name] = pa.array(col.values)
        else:
            arrays[name] = pa.array(col.values, mask=~np.asarray(col.mask, dtype=bool))
    return pa.table(arrays)


def write_parquet(table: ColumnarTable, path: str, row_group_rows: int = 1 << 20) -> None:
    """Write a ColumnarTable to one Parquet file."""
    import pyarrow.parquet as pq

    pq.write_table(to_arrow(table), path, row_group_size=row_group_rows)


def write_parquet_stream(batches, path: str) -> int:
    """Write an iterator of ColumnarTable batches to one Parquet file, a
    row group a batch, never holding more than one batch. Returns the
    rows written."""
    import pyarrow.parquet as pq

    writer = None
    rows = 0
    try:
        for batch in batches:
            arrow = to_arrow(batch)
            if writer is None:
                writer = pq.ParquetWriter(path, arrow.schema)
            writer.write_table(arrow)
            rows += batch.num_rows
    finally:
        if writer is not None:
            writer.close()
    return rows


def stream_parquet(paths, columns=None, batch_rows=None):
    """Parquet file(s) as a StreamingTable: analyses run over it in bounded
    host memory."""
    from deequ_tpu_torch.data.source import ParquetBatchSource
    from deequ_tpu_torch.data.streaming import StreamingTable

    return StreamingTable(ParquetBatchSource(paths, columns, batch_rows))


def stream_csv(path, columns=None, batch_rows=None, delimiter=","):
    """A CSV file as a StreamingTable (pyarrow's incremental parser; the
    file is never materialised)."""
    from deequ_tpu_torch.data.source import CSVBatchSource
    from deequ_tpu_torch.data.streaming import StreamingTable

    return StreamingTable(CSVBatchSource(path, columns, batch_rows, delimiter))


def from_pandas(df) -> ColumnarTable:
    """Convert a pandas DataFrame; a floating NaN is null."""
    import pandas as pd

    cols = []
    for name in df.columns:
        series = df[name]
        if pd.api.types.is_integer_dtype(series.dtype):
            cols.append(Column(str(name), DType.INTEGRAL,
                               values=series.to_numpy(dtype=np.int64)))
        elif pd.api.types.is_float_dtype(series.dtype):
            arr = series.to_numpy(dtype=np.float64)
            mask = ~np.isnan(arr)
            cols.append(Column(str(name), DType.FRACTIONAL,
                               values=np.where(mask, arr, 0.0), mask=mask))
        elif pd.api.types.is_bool_dtype(series.dtype):
            cols.append(Column(str(name), DType.BOOLEAN,
                               values=series.to_numpy(dtype=np.bool_)))
        else:
            strings = [None if pd.isna(v) else str(v) for v in series]
            cols.append(_string_column(str(name), strings))
    return ColumnarTable(cols)
