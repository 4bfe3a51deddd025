"""Out-of-core batch sources — bounded-memory ingestion (the port's copy
of ``deequ_tpu/data/source.py``).

A ``BatchSource`` yields fixed-size ``ColumnarTable`` batches straight off
storage; the streaming scan (``ops/scan_engine.py``) packs each batch into
chunks on the host while a reader thread decodes the next one, and stages
each chunk's copy to the card behind the previous chunk's work. Host RSS
stays bounded by O(batch_rows x row_width x read-ahead), whatever the
dataset's size.

``ParquetBatchSource`` streams row batches through
``pyarrow.ParquetFile.iter_batches``: the schema and the row count come
from the file's metadata, so nothing is read until batches are consumed.
``CSVBatchSource`` streams through pyarrow's incremental CSV reader.
pyarrow is imported inside the functions that need it: the package, the
table source and the generator source work without it.
"""

from __future__ import annotations

import itertools
from typing import Collection, Dict, Iterator, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.data.table import (
    MAX_ENCODED_CARDINALITY,
    ColumnarTable,
    DType,
    Field,
    Schema,
)

#: target host bytes per streamed batch (host representation, before packing)
DEFAULT_BATCH_BYTES = 256 << 20


def batch_rows_for_schema(
    schema: Schema,
    target_bytes: int = DEFAULT_BATCH_BYTES,
    encoded: Collection[str] = (),
) -> int:
    """Rows per batch so one batch is ~``target_bytes`` on the host.

    ``encoded`` names the columns the source delivers dictionary-encoded:
    those arrive as int16 codes (and a small dictionary), 2 bytes a row,
    not the 9 bytes a row of a decoded value and mask."""
    encoded = set(encoded)
    bytes_per_row = 0
    for f in schema:
        if f.dtype == DType.STRING:
            bytes_per_row += 4  # i32 codes
        elif f.name in encoded:
            bytes_per_row += 2  # i16 dictionary codes (validity rides in them)
        else:
            bytes_per_row += 9  # value + mask
    bytes_per_row = max(bytes_per_row, 1)
    return int(min(max(target_bytes // bytes_per_row, 1 << 16), 1 << 24))


class BatchSource:
    """Protocol for bounded-memory batch producers."""

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def num_rows(self) -> Optional[int]:
        """Total rows if the metadata knows them, else None."""
        return None

    @property
    def encoded_column_names(self) -> frozenset:
        """Columns this source delivers dictionary-encoded (a
        ``ColumnChunk`` as the Column's payload). It sizes the batches
        (``batch_rows_for_schema``); the scan routes off each batch's own
        ``Column.encoding``. Default: none."""
        return frozenset()

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        raise NotImplementedError

    def batches_from(
        self,
        start: int = 0,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        """Batches from batch index ``start`` — the seek a retried read
        reopens at (``resilience/retry.py``). Batch boundaries are fixed
        for a fixed ``batch_rows``, so index k names the same rows every
        call. Default: read again and drop the first ``start`` batches;
        sources that can seek override it."""
        return itertools.islice(
            self.batches(columns=columns, batch_rows=batch_rows), start, None
        )

    def with_retry(self, policy=None):
        """This source with every batch read run under a RetryPolicy
        (``resilience/retry.py``: reopen and fast-forward on a transient
        error)."""
        from deequ_tpu_torch.resilience.retry import RetryingBatchSource

        return RetryingBatchSource(self, policy)


def _restrict_arrow_schema(arrow_schema, names, what: str):
    """Requested column names on an arrow schema -> the engine's Fields."""
    fields = []
    for name in names:
        idx = arrow_schema.get_field_index(name)
        if idx < 0:
            raise ValueError(f"column {name!r} not in {what}")
        fields.append(Field(name, _arrow_field_dtype(arrow_schema.field(idx).type)))
    return fields


def _arrow_field_dtype(pa_type) -> DType:
    import pyarrow as pa

    if pa.types.is_dictionary(pa_type):
        pa_type = pa_type.value_type
    if pa.types.is_integer(pa_type):
        return DType.INTEGRAL
    if pa.types.is_floating(pa_type):
        return DType.FRACTIONAL
    if pa.types.is_boolean(pa_type):
        return DType.BOOLEAN
    return DType.STRING


def _dictionary_encoded_columns(pf, names, schema) -> frozenset:
    """The numeric columns of one ParquetFile whose every column chunk was
    written with a dictionary encoding (metadata only). A column whose
    dictionary overflowed (the writer's high-cardinality fallback) is
    caught later, per batch, by the density cap of
    :func:`_encode_arrow_batch`."""
    meta = pf.metadata
    phys_names = [meta.schema.column(i).path for i in range(meta.num_columns)]
    wanted = {
        n for n in names if schema[n].dtype in (DType.INTEGRAL, DType.FRACTIONAL)
    }
    encoded = set(wanted) if meta.num_row_groups else set()
    for rg in range(meta.num_row_groups):
        group = meta.row_group(rg)
        for i, name in enumerate(phys_names):
            if name not in encoded:
                continue
            if not set(group.column(i).encodings) & {"PLAIN_DICTIONARY", "RLE_DICTIONARY"}:
                encoded.discard(name)
    return frozenset(encoded)


def _encode_arrow_batch(table, encode_names: set, batch_rows: int):
    """Dictionary-encode the named columns of one Arrow table in Arrow
    (``pc.dictionary_encode``), so ``from_arrow`` carries codes,
    dictionary and validity as the Column's encoded payload and the
    decoded numpy form never exists. A column past the density cap — more
    than one dictionary entry per 4 rows of a full batch, or past
    ``MAX_ENCODED_CARDINALITY`` — is dropped from ``encode_names``
    (mutated) and stays plain for the rest of the stream. The denominator
    is the full batch size, never this batch's length, so a short last
    batch cannot demote a low-cardinality column."""
    import pyarrow.compute as pc

    for name in sorted(encode_names & set(table.column_names)):
        idx = table.column_names.index(name)
        combined = table.column(idx).combine_chunks()
        encoded = pc.dictionary_encode(combined)
        cap = min(MAX_ENCODED_CARDINALITY, max(max(batch_rows, len(combined)) // 4, 1))
        if len(encoded.dictionary) > cap:
            encode_names.discard(name)
            continue
        table = table.set_column(idx, name, encoded)
    return table


class ParquetBatchSource(BatchSource):
    """Stream one or more Parquet files as ColumnarTable batches.

    Schema and total row count come from the files' metadata (no data
    read); ``batches`` decodes ``pyarrow.ParquetFile.iter_batches`` one
    batch at a time — the whole file is never materialised.
    ``pre_buffer=False`` (the default here; pyarrow's is True) reads row
    groups on demand instead of all of them ahead."""

    def __init__(
        self,
        paths,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
        pre_buffer: bool = False,
    ):
        import pyarrow.parquet as pq

        self.pre_buffer = pre_buffer
        self.paths: List[str] = [paths] if isinstance(paths, str) else list(paths)
        if not self.paths:
            raise ValueError("ParquetBatchSource needs at least one path")
        self._restrict = list(columns) if columns is not None else None
        self._batch_rows = batch_rows
        first = pq.ParquetFile(self.paths[0])
        arrow_schema = first.schema_arrow
        names = self._restrict if self._restrict is not None else list(arrow_schema.names)
        self._schema = Schema(_restrict_arrow_schema(arrow_schema, names, "parquet schema"))
        # a column counts as encoded when every row group of every file
        # wrote it dictionary-encoded
        self._encoded = _dictionary_encoded_columns(first, names, self._schema)
        n = first.metadata.num_rows
        for path in self.paths[1:]:
            pf = pq.ParquetFile(path)
            self._encoded &= _dictionary_encoded_columns(pf, names, self._schema)
            # only the SELECTED columns, by name, and by the engine's dtype
            # (int32 and int64 files stream alike)
            other = pf.schema_arrow
            for name in names:
                idx = other.get_field_index(name)
                if idx < 0 or _arrow_field_dtype(other.field(idx).type) != _arrow_field_dtype(
                    arrow_schema.field(name).type
                ):
                    raise ValueError(
                        f"parquet schema mismatch: column {name!r} in {path!r} is "
                        f"{other.field(idx).type if idx >= 0 else 'missing'}, "
                        f"expected {arrow_schema.field(name).type} "
                        f"(from {self.paths[0]!r})"
                    )
            n += pf.metadata.num_rows
        self._num_rows = int(n)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_rows(self) -> Optional[int]:
        return self._num_rows

    @property
    def encoded_column_names(self) -> frozenset:
        return self._encoded

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        import pyarrow as pa
        import pyarrow.parquet as pq

        from deequ_tpu_torch.data.io import from_arrow

        names = list(columns) if columns is not None else self._schema.column_names
        names = [n for n in self._schema.column_names if n in set(names)]
        rows = batch_rows or self._batch_rows or batch_rows_for_schema(
            Schema([self._schema[n] for n in names]),
            encoded=self._encoded & set(names),
        )
        # columns the metadata reports encoded stay encoded end to end:
        # re-encoded in Arrow a batch, carried by from_arrow as ColumnChunks
        enc_active = set(self._encoded & set(names))
        # the density denominator: a full batch, or the whole smaller source
        cap_rows = min(rows, self._num_rows) if self._num_rows else rows
        for path in self.paths:
            pf = pq.ParquetFile(path, pre_buffer=self.pre_buffer)
            for record_batch in pf.iter_batches(batch_size=rows, columns=names):
                tab = pa.Table.from_batches([record_batch])
                if enc_active:
                    tab = _encode_arrow_batch(tab, enc_active, cap_rows)
                yield from_arrow(tab)


def _bool_literals() -> frozenset:
    """The lowered boolean literals of ``read_csv`` (its _TRUE/_FALSE), so
    the two CSV readers cannot drift apart."""
    from deequ_tpu_torch.data.io import _FALSE, _TRUE

    return frozenset(s.lower() for s in (_TRUE | _FALSE))


def _classify_string_values(col):
    """(can_int, can_float, can_bool) of one block's non-null strings.
    The flags AND across blocks and the final type takes ``read_csv``'s
    precedence (int > float > bool > string), so a block-local view never
    disagrees with a whole-file pass."""
    import pyarrow as pa
    import pyarrow.compute as pc

    def can_cast(t):
        try:
            pc.cast(col, t)
            return True
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            return False

    can_int = can_cast(pa.int64())
    can_float = can_int or can_cast(pa.float64())
    lowered = set(pc.utf8_lower(col).unique().to_pylist())
    can_bool = lowered <= _bool_literals()
    return can_int, can_float, can_bool


class CSVBatchSource(BatchSource):
    """Stream a CSV file as ColumnarTable batches through pyarrow's
    incremental CSV reader (the file is never materialised).

    Nulls as ``read_csv``: only the empty cell is null ('NA' and 'nan'
    are data). Schema: ``column_types`` pins dtypes (the bounded path for
    huge files); otherwise one streaming pass infers each column's widened
    type over the WHOLE file (int64 -> float64 -> string), so a value late
    in the file cannot break the analysis."""

    def __init__(
        self,
        path: str,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
        delimiter: str = ",",
        column_types: Optional[Dict[str, DType]] = None,
    ):
        import pyarrow as pa

        self.path = path
        self.delimiter = delimiter
        self._restrict = list(columns) if columns is not None else None
        self._batch_rows = batch_rows
        if column_types is not None:
            arrow_of = {
                DType.INTEGRAL: pa.int64(),
                DType.FRACTIONAL: pa.float64(),
                DType.BOOLEAN: pa.bool_(),
                DType.STRING: pa.string(),
            }
            header = self._open(block_rows=1 << 12).schema
            arrow_schema = pa.schema([
                pa.field(n, arrow_of[column_types.get(n, DType.STRING)])
                for n in header.names
            ])
        else:
            arrow_schema = self._infer_schema_streaming()
        names = self._restrict if self._restrict is not None else list(arrow_schema.names)
        self._schema = Schema(_restrict_arrow_schema(arrow_schema, names, "CSV header"))
        self._arrow_schema = arrow_schema
        # CSV has no encoding metadata: the first block's cardinality
        # decides, sniffed on first use (None: not yet), so a source built
        # for its schema alone reads no block
        self._encoded: Optional[frozenset] = None

    def _infer_schema_streaming(self):
        """One streaming pass over the file, widening each column's type
        across blocks. Every column is read as a string and classified on
        the host: pyarrow's reader pins a column's type from its first
        block and would raise on a widening value in a later one."""
        import pyarrow as pa

        header = self._open(block_rows=1 << 12).schema
        all_string = pa.schema([pa.field(n, pa.string()) for n in header.names])
        caps = {}  # name -> (can_int, can_float, can_bool), AND across blocks
        for record_batch in self._open(block_rows=1 << 16, pin_schema=all_string):
            for i, field in enumerate(record_batch.schema):
                name = field.name
                if caps.get(name) == (False, False, False):
                    continue  # already a string: it cannot widen further
                col = record_batch.column(i).drop_null()
                if len(col) == 0:
                    continue  # an all-null block says nothing
                c = _classify_string_values(col)
                prev = caps.get(name)
                caps[name] = c if prev is None else tuple(a and b for a, b in zip(prev, c))
        out = []
        for name in header.names:
            c = caps.get(name)
            if c is None:
                t = pa.string()  # an all-null column
            else:
                can_int, can_float, can_bool = c
                if can_int:
                    t = pa.int64()
                elif can_float:
                    t = pa.float64()
                elif can_bool:
                    t = pa.bool_()
                else:
                    t = pa.string()
            out.append(pa.field(name, t))
        return pa.schema(out)

    def _open(self, block_rows: int, pin_schema=None, include=None):
        import pyarrow.csv as pacsv

        # the reader's block size in bytes, at ~64 bytes a row
        block_bytes = max(block_rows * 64, 1 << 16)
        convert = pacsv.ConvertOptions(
            column_types=dict(zip(pin_schema.names, pin_schema.types))
            if pin_schema is not None else None,
            include_columns=include if include is not None else self._restrict,
            # read_csv's nulls: only the empty cell, in string columns too
            null_values=[""],
            strings_can_be_null=True,
        )
        return pacsv.open_csv(
            self.path,
            read_options=pacsv.ReadOptions(block_size=block_bytes),
            parse_options=pacsv.ParseOptions(delimiter=self.delimiter),
            convert_options=convert,
        )

    def _sniff_encoded_first_block(self) -> frozenset:
        """The numeric columns whose first block passes the encoded
        ingest's density rule (at most one distinct value per 4 rows,
        within the int16 code space). ``_encode_arrow_batch`` checks the
        rule again a batch, so a column that only looked low-cardinality
        at first leaves the code plane mid-stream."""
        import pyarrow.compute as pc

        numeric = [
            f.name for f in self._schema if f.dtype in (DType.INTEGRAL, DType.FRACTIONAL)
        ]
        if not numeric:
            return frozenset()
        reader = self._open(block_rows=1 << 16, pin_schema=self._arrow_schema,
                            include=numeric)
        try:
            block = reader.read_next_batch()
        except StopIteration:
            return frozenset()  # a header-only file
        finally:
            reader.close()
        cap = min(MAX_ENCODED_CARDINALITY, max(block.num_rows // 4, 1))
        out = set()
        for i, name in enumerate(block.schema.names):
            distinct = len(pc.unique(block.column(i).drop_null()))
            if 0 < distinct <= cap:
                out.add(name)
        return frozenset(out)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_rows(self) -> Optional[int]:
        return None  # CSV has no row-count metadata; Size() measures it

    @property
    def encoded_column_names(self) -> frozenset:
        if self._encoded is None:
            self._encoded = self._sniff_encoded_first_block()
        return self._encoded

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        import pyarrow as pa

        from deequ_tpu_torch.data.io import from_arrow

        encoded = self.encoded_column_names
        keep = (
            [n for n in self._schema.column_names if n in set(columns)]
            if columns is not None else None
        )
        rows = batch_rows or self._batch_rows or batch_rows_for_schema(
            self._schema, encoded=encoded
        )
        # the reader prunes: pyarrow converts no excluded column
        reader = self._open(block_rows=rows, pin_schema=self._arrow_schema, include=keep)
        enc_active = set(encoded if keep is None else encoded & set(keep))
        for record_batch in reader:
            tab = pa.Table.from_batches([record_batch])
            if enc_active:
                tab = _encode_arrow_batch(tab, enc_active, rows)
            yield from_arrow(tab)


class TableBatchSource(BatchSource):
    """An in-memory ColumnarTable cut into batches (tests, and pipelines
    that hold their batches already). A batch's string columns keep the
    table's dictionary."""

    def __init__(self, table: ColumnarTable, batch_rows: Optional[int] = None):
        self.table = table
        self._batch_rows = batch_rows

    @property
    def schema(self) -> Schema:
        return self.table.schema

    @property
    def num_rows(self) -> Optional[int]:
        return self.table.num_rows

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        yield from self.batches_from(0, columns=columns, batch_rows=batch_rows)

    def batches_from(
        self,
        start: int = 0,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        # a seek is row arithmetic: the table is in memory
        rows = batch_rows or self._batch_rows or batch_rows_for_schema(self.schema)
        names = (
            [n for n in self.table.column_names if n in set(columns)]
            if columns is not None else self.table.column_names
        )
        n = self.table.num_rows
        view = self.table.select(names)
        for row0 in range(start * rows, max(n, 1) if start == 0 else n, rows):
            idx = np.arange(row0, min(row0 + rows, n))
            yield ColumnarTable([view[c].take(idx) for c in names])
            if row0 + rows >= n:
                break


class GeneratorBatchSource(BatchSource):
    """Batches from a factory of iterators (synthetic streams: the data is
    made on the fly and never held whole). The factory's batches carry
    their own size: the streaming scan takes its chunk rows from the
    first one."""

    def __init__(self, schema: Schema, factory, num_rows: Optional[int] = None):
        self._schema = schema
        self._factory = factory  # () -> Iterator[ColumnarTable]
        self._num_rows = num_rows

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_rows(self) -> Optional[int]:
        return self._num_rows

    def batches(
        self,
        columns: Optional[Sequence[str]] = None,
        batch_rows: Optional[int] = None,
    ) -> Iterator[ColumnarTable]:
        keep = set(columns) if columns is not None else None
        for batch in self._factory():
            if keep is not None:
                yield batch.select([n for n in batch.column_names if n in keep])
            else:
                yield batch
