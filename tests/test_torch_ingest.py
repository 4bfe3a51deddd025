"""Encoded numeric columns in the port — ``ColumnChunk``, ``Column.encode``
and ``ColumnarTable.encode``, the scan's int16 code plane, decoded on the
device by a gather of the dictionary — on the CPU. Twins of the
reference's ``tests/test_ingest.py``, its streaming cases among them: the
Parquet and CSV sources' encoding detection (file metadata, the first
block's cardinality), the density rule that keeps near-unique columns
plain, an encoded CSV stream, the double buffer's overlap with encoded
and decoded streams bit for bit, and an encoding lost partway through a
stream.

Bounds: an encoded column decodes on the device to the very f64 values
its decoded plane would hold, and both layouts cut the table at the same
rows, so every metric of an encoded run equals the decoded run's bit for
bit, streamed or persisted. Against the reference (an encoded table
carried over with ``interop.table_from_arrays``) the bounds of
``tests/torch_parity.py``.
"""

import math

import numpy as np
import pytest

import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu.analyzers.runner import AnalysisRunner as RefRunner
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers.runner import AnalysisRunner as PortRunner
from deequ_tpu_torch.data.table import (
    MAX_ENCODED_CARDINALITY,
    Column,
    ColumnarTable,
    ColumnChunk,
    DType,
)
from deequ_tpu_torch.interop import table_from_arrays
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, persist_table
from torch_parity import assert_metric_parity, parity_env, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port

BUDGET = 1 << 30


def _dict_heavy(n=20000, seed=11):
    """Low-cardinality fractional and integral columns (the encodable
    shape) beside a string column, with nulls, -0.0 and a valid NaN."""
    rng = np.random.default_rng(seed)
    f = (rng.integers(0, 50, n) * 0.25 - 3.0).astype(np.float64)
    f[rng.integers(0, n, 30)] = -0.0
    f[rng.integers(0, n, 5)] = np.nan
    return ColumnarTable([
        Column("f", DType.FRACTIONAL, values=f, mask=rng.random(n) > 0.05),
        Column("i", DType.INTEGRAL, values=rng.integers(-20, 20, n)),
        Column("s", DType.STRING, codes=rng.integers(0, 30, n).astype(np.int32),
               dictionary=np.array([f"v{k}" for k in range(30)], dtype=object)),
    ])


def _null_heavy(n=20000, seed=12):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) > 0.6  # 60% null
    f = rng.integers(0, 25, n).astype(np.float64) * 1.5
    return ColumnarTable([Column("f", DType.FRACTIONAL, values=np.where(mask, f, 0.0),
                                 mask=mask)])


def _all_unique(n=5000, seed=13):
    rng = np.random.default_rng(seed)
    return ColumnarTable([Column("f", DType.FRACTIONAL, values=rng.normal(size=n))])


def _families(pkg, extra=False):
    out = [
        pkg.Size(), pkg.Completeness("f"), pkg.Mean("f"), pkg.StandardDeviation("f"),
        pkg.Minimum("f"), pkg.Maximum("f"), pkg.Sum("f"),       # monoids
        pkg.ApproxQuantile("f", 0.5), pkg.KLLSketch("f"),        # KLL
        pkg.ApproxCountDistinct("f"),                            # HLL
        pkg.Histogram("f"), pkg.Uniqueness(["f"]),               # grouping
        pkg.Compliance("f big", "f > 2"),                        # predicates
    ]
    if extra:
        out += [pkg.Mean("i"), pkg.Uniqueness(["i"]), pkg.Correlation("f", "i"),
                pkg.ApproxQuantiles("i", (0.1, 0.9)), pkg.Completeness("s"),
                pkg.Entropy("s")]
    return out


def _metrics(ctx, analyzers):
    out = []
    for a in analyzers:
        m = ctx.metric(a)
        assert m.value.is_success, (a, m.value)
        v = m.value.get()
        out.append(np.float64(v).view(np.int64) if isinstance(v, float) else repr(v))
    return out


# -- ColumnChunk / Column encoding --------------------------------------------


def test_column_chunk_round_trip_with_nulls():
    values = np.array([1.5, 0.0, 2.5, 1.5, 0.0])
    mask = np.array([True, False, True, True, False])
    enc = ColumnChunk.from_values(values, mask)
    assert enc.codes.dtype == np.int16 and list(enc.codes >= 0) == list(mask)
    dec_values, dec_mask = enc.decode(np.float64)
    assert np.array_equal(dec_mask, mask)
    assert np.array_equal(dec_values, np.where(mask, values, 0.0))
    assert enc.validity.nbytes == (len(values) + 7) // 8  # packed bits
    assert list(enc.dictionary) == [1.5, 2.5]
    assert ColumnChunk.from_values(values, np.ones(5, bool)).validity is None


def test_column_chunk_valid_nan_round_trips():
    values = np.array([1.0, np.nan, 1.0, np.nan])
    mask = np.array([True, True, True, False])
    enc = ColumnChunk.from_values(values, mask)
    dec_values, dec_mask = enc.decode(np.float64)
    assert list(dec_mask) == [True, True, True, False]
    assert dec_values[0] == 1.0 and np.isnan(dec_values[1]) and dec_values[3] == 0.0
    assert np.isnan(enc.dictionary[-1])


def test_all_unique_column_refuses_encoding():
    col = Column("u", DType.FRACTIONAL, values=np.arange(40000.0))
    assert col.encode() is False and col.encoding is None
    assert Column("b", DType.BOOLEAN, values=np.array([True, False])).encode() is False
    strings = Column("s", DType.STRING, codes=np.array([0], np.int32),
                     dictionary=np.array(["a"], dtype=object))
    assert strings.encode() is False
    edge = Column("e", DType.INTEGRAL, values=np.arange(MAX_ENCODED_CARDINALITY + 1))
    assert edge.encode() is False
    past = Column("e", DType.INTEGRAL, values=np.arange((1 << 15) + 1))
    assert past.encode(max_cardinality=1 << 16) is False  # past what int16 codes index
    fits = Column("e", DType.INTEGRAL, values=np.arange(MAX_ENCODED_CARDINALITY))
    assert fits.encode() is True and fits.encoding.codes.max() == MAX_ENCODED_CARDINALITY - 1


def test_encoded_take_stays_encoded_and_decode_is_lazy():
    t = _dict_heavy(1000)
    values, mask = t["f"].values.copy(), t["f"].mask.copy()
    t.encode()
    sliced = t["f"].take(np.arange(100, 200))
    assert sliced.encoding is not None
    assert np.array_equal(sliced.values, np.where(mask, values, 0.0)[100:200], equal_nan=True)
    col = Column("f", DType.FRACTIONAL, encoded=t["f"].encoding)
    assert np.array_equal(col.mask, mask) and col._values is None  # mask alone decodes nothing
    assert len(col) == 1000 and col._values is None
    with pytest.raises(ValueError):
        Column("f", DType.FRACTIONAL, values=values, encoded=t["f"].encoding)


def test_table_encode_picks_the_encodable_columns():
    t = _dict_heavy(2000)
    assert t.encode() is t
    assert [n for n in t.column_names if t[n].encoding is not None] == ["f", "i"]
    u = _all_unique(40000).encode()
    assert u["f"].encoding is None


# -- encoded against decoded, bit for bit --------------------------------------


@pytest.mark.parametrize("resident", [False, True], ids=["streamed", "persisted"])
@pytest.mark.parametrize("build", [_dict_heavy, _null_heavy, _all_unique],
                         ids=["dict_heavy", "null_heavy", "all_unique"])
def test_encoded_bit_identical_all_families(parity_env, monkeypatch, build, resident):
    """Several chunks; every analyzer family bit for bit."""
    import deequ_tpu_torch.ops.scan_engine as port_scan_engine

    monkeypatch.setattr(port_scan_engine, "_auto_chunk_rows", lambda cols, *a, **k: 5000)
    analyzers = _families(port_analyzers, extra=build is _dict_heavy)
    decoded, encoded = build(), build().encode()
    with use_device("cpu"):
        if resident:
            decoded.persist(max_bytes=BUDGET)
            encoded.persist(max_bytes=BUDGET)
        want = _metrics(PortRunner.do_analysis_run(decoded, analyzers), analyzers)
        SCAN_STATS.reset()
        got = _metrics(PortRunner.do_analysis_run(encoded, analyzers), analyzers)
        stats = SCAN_STATS.snapshot()
        decoded.unpersist()
        encoded.unpersist()
    assert got == want
    assert stats["encoded_scan_passes"] == 1  # 5,000 distinct values still encode
    assert stats["resident_passes"] == int(resident)


def test_encoded_resident_bytes_drop_at_least_2x():
    """On the encodable columns: f 8 + 1 bytes a row, i 8 → 2 and 2."""
    enc = _dict_heavy(20000).select(["f", "i"]).encode()
    dec = _dict_heavy(20000).select(["f", "i"])
    enc_bytes = persist_table(enc, "cpu", chunk_rows=4096, max_bytes=BUDGET).nbytes
    dec_bytes = persist_table(dec, "cpu", chunk_rows=4096, max_bytes=BUDGET).nbytes
    assert enc._device_cache.packer.enc_names == ["f", "i"]
    assert enc_bytes * 2 <= dec_bytes, (enc_bytes, dec_bytes)
    # persist(encode=False) keeps the decoded planes for an encoded table
    again = persist_table(_dict_heavy(20000).select(["f", "i"]).encode(), "cpu",
                          chunk_rows=4096, max_bytes=BUDGET * 2, encode=False)
    assert again.nbytes == dec_bytes and again.packer.enc_names == []
    for t in (enc, dec):
        t.unpersist()
    again.device_chunks, again.nbytes = [], 0


def test_encoded_streaming_packs_at_least_2x_fewer_bytes(parity_env):
    analyzers = [port_analyzers.Mean("f"), port_analyzers.Minimum("f"),
                 port_analyzers.Maximum("f")]
    with use_device("cpu"):
        SCAN_STATS.reset()
        PortRunner.do_analysis_run(_null_heavy(30000), analyzers)
        raw = SCAN_STATS.bytes_packed
        SCAN_STATS.reset()
        PortRunner.do_analysis_run(_null_heavy(30000).encode(), analyzers)
        enc = SCAN_STATS.bytes_packed
    assert enc * 2 <= raw and SCAN_STATS.encoded_scan_passes == 1


# -- against the reference ----------------------------------------------------


def _encoded_spec(col):
    enc = col.encoding
    return {"name": col.name, "dtype": col.dtype.value, "codes": enc.codes,
            "dictionary": enc.dictionary, "validity": enc.validity,
            "num_rows": enc.num_rows}


@pytest.mark.parametrize("resident", [False, True], ids=["streamed", "persisted"])
def test_encoded_table_parity_with_reference_encode(parity_env, monkeypatch, resident):
    """The reference encodes a table; its ColumnChunk fields go across with
    table_from_arrays; both packages give the same metrics (the reference
    under DEEQU_TPU_COMPUTE=f64 and on one device, the KLL states then
    bit for bit — its sort against the port's select when persisted)."""
    monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    rng = np.random.default_rng(5)
    n = 9000
    ref = RefTable([
        ref_column("f", "fractional", np.round(rng.normal(3, 2, n), 1), rng.random(n) > 0.1),
        ref_column("i", "integral", rng.integers(-500, 500, n), np.ones(n, bool)),
    ]).encode()
    assert ref["f"].encoding is not None and ref["i"].encoding is not None
    port = table_from_arrays([_encoded_spec(ref[c]) for c in ("f", "i")])
    assert port["f"].encoding is not None
    assert np.array_equal(port["f"].values, np.where(ref["f"].mask, ref["f"].values, 0.0))
    ref_list, port_list = _families(ref_analyzers), _families(port_analyzers)
    ref_list.append(ref_analyzers.ApproxQuantile("i", 0.25))
    port_list.append(port_analyzers.ApproxQuantile("i", 0.25))
    with use_mesh(None):
        if resident:
            ref.persist()
        ref_ctx = RefRunner.do_analysis_run(ref, ref_list)
        ref.unpersist()
    with use_device("cpu"):
        if resident:
            port.persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        port_ctx = PortRunner.do_analysis_run(port, port_list)
        assert SCAN_STATS.encoded_scan_passes == 1
        port.unpersist()
    for r, p in zip(ref_list, port_list):
        want, got = ref_ctx.metric(r), port_ctx.metric(p)
        if type(r).__name__ == "Histogram":
            dist = lambda d: (d.number_of_bins, {k: (v.absolute, v.ratio)  # noqa: E731
                                                 for k, v in d.values.items()})
            assert dist(got.value.get()) == dist(want.value.get())
        elif type(r).__name__ == "KLLSketch":
            a, b = want.value.get(), got.value.get()
            assert [bk.count for bk in a.buckets] == [bk.count for bk in b.buckets]
            assert [list(x) for x in a.data] == [list(x) for x in b.data]
        else:
            assert_metric_parity(want, got)
            assert not math.isnan(got.value.get())


# -- encoded columns on a stream (twins of tests/test_ingest.py's streaming cases) --


def test_batch_rows_sized_by_encoded_bytes():
    from deequ_tpu_torch.data.source import batch_rows_for_schema
    from deequ_tpu_torch.data.table import Field, Schema

    schema = Schema([Field("a", DType.FRACTIONAL), Field("b", DType.FRACTIONAL)])
    plain = batch_rows_for_schema(schema, target_bytes=4 << 20)
    enc = batch_rows_for_schema(schema, target_bytes=4 << 20, encoded=("a", "b"))
    # 9 bytes a row decoded against 2 encoded: ~4.5x the rows a batch
    assert enc > 4 * plain


def _concat(batches):
    merged = batches[0]
    for b in batches[1:]:
        merged = merged.concat(b)
    return merged


def test_parquet_source_detects_and_carries_encoding(tmp_path):
    from deequ_tpu_torch.data.io import write_parquet
    from deequ_tpu_torch.data.source import ParquetBatchSource

    t = _dict_heavy(8000)
    path = str(tmp_path / "enc.parquet")
    write_parquet(t, path)
    src = ParquetBatchSource(path)
    assert {"f", "i"} <= set(src.encoded_column_names)
    batches = list(src.batches(batch_rows=2048))
    assert all(b["f"].encoding is not None for b in batches)
    assert all(b["i"].encoding is not None for b in batches)
    merged = _concat(batches)
    assert np.array_equal(merged["f"].mask, t["f"].mask & ~np.isnan(t["f"].values))
    assert np.array_equal(merged["i"].values, t["i"].values)


def test_parquet_near_unique_column_stays_plain(tmp_path):
    """The density rule: a column the writer dictionary-encoded whose
    cardinality is near its rows decodes to the plain path."""
    from deequ_tpu_torch.data.io import write_parquet
    from deequ_tpu_torch.data.source import ParquetBatchSource

    rng = np.random.default_rng(7)
    t = ColumnarTable([Column("u", DType.FRACTIONAL, values=rng.normal(size=4000))])
    path = str(tmp_path / "uniq.parquet")
    write_parquet(t, path)
    batches = list(ParquetBatchSource(path).batches())
    assert all(b["u"].encoding is None for b in batches)
    assert np.array_equal(batches[0]["u"].values[:10], t["u"].values[:10])


def _write_csv(path, n=4000, card=13):
    """Low-cardinality int and float columns, a near-unique float, a string
    column, and an empty-cell null every 53rd row."""
    with open(path, "w") as f:
        f.write("i,f,u,s\n")
        for k in range(n):
            i = "" if k % 53 == 0 else str(k % card)
            f.write(f"{i},{(k % card) / 2},{k * 1.5},s{k % 5}\n")


def test_csv_source_sniffs_and_carries_encoding(tmp_path):
    """CSV has no encoding metadata: the source sniffs the first block's
    cardinality and carries the qualifying numeric columns encoded."""
    from deequ_tpu_torch.data.io import read_csv
    from deequ_tpu_torch.data.source import CSVBatchSource

    path = str(tmp_path / "enc.csv")
    _write_csv(path)
    src = CSVBatchSource(path)
    assert src.encoded_column_names == frozenset({"i", "f"})
    batches = list(src.batches(batch_rows=1024))
    assert all(b["i"].encoding is not None for b in batches)
    assert all(b["f"].encoding is not None for b in batches)
    assert all(b["u"].encoding is None for b in batches)
    merged, ref = _concat(batches), read_csv(path)
    assert merged.num_rows == ref.num_rows
    for name in ("i", "f", "u"):
        assert np.array_equal(merged[name].values, ref[name].values)
        assert np.array_equal(merged[name].mask, ref[name].mask)


def test_csv_density_rule_keeps_near_unique_plain(tmp_path):
    from deequ_tpu_torch.data.source import CSVBatchSource

    path = str(tmp_path / "uniq.csv")
    _write_csv(path)
    src = CSVBatchSource(path)
    assert "u" not in src.encoded_column_names  # near-unique: fails the density rule
    assert "s" not in src.encoded_column_names  # strings have their own plane
    empty = str(tmp_path / "empty.csv")
    with open(empty, "w") as f:
        f.write("a,b\n")
    assert CSVBatchSource(empty).encoded_column_names == frozenset()


def test_csv_encoded_stream_metrics_match_decoded(tmp_path):
    """An encoded CSV stream gives the in-memory decoded run's metrics bit
    for bit (one batch of the stream is one chunk of the in-memory run
    here: 4,000 rows)."""
    from deequ_tpu_torch.data.io import read_csv, stream_csv

    path = str(tmp_path / "m.csv")
    _write_csv(path)
    analyzers = [port_analyzers.Size(), port_analyzers.Completeness("i"),
                 port_analyzers.Mean("f"), port_analyzers.Minimum("f"),
                 port_analyzers.Maximum("f"), port_analyzers.Sum("i")]
    with use_device("cpu"):
        ref = PortRunner.do_analysis_run(read_csv(path), analyzers)
        SCAN_STATS.reset()
        got = PortRunner.do_analysis_run(stream_csv(path, batch_rows=4000), analyzers)
        assert SCAN_STATS.encoded_scan_passes == 1
    assert _metrics(got, analyzers) == _metrics(ref, analyzers)


def test_stream_overlap_and_bit_identity(monkeypatch):
    """The streaming loop double-buffers: every chunk's copy after the
    first is issued while the previous chunk is staged and not yet scanned,
    ingest_overlap_frac = (n - 1) / n; the encoded and decoded streams agree
    bit for bit, the encoded one staging at most half the bytes, and a
    stream of monoid ops fetches once."""
    from deequ_tpu_torch.data.streaming import stream_table

    monoid = [port_analyzers.Size(), port_analyzers.Completeness("f"),
              port_analyzers.Mean("f"), port_analyzers.Minimum("f"),
              port_analyzers.Maximum("f")]

    def stream(encode):
        t = _dict_heavy(16000)
        if encode:
            t.encode()
        return stream_table(t, batch_rows=2048)

    with use_device("cpu"):
        monkeypatch.setenv("DEEQU_TORCH_ENCODED_INGEST", "0")
        SCAN_STATS.reset()
        ref = _metrics(PortRunner.do_analysis_run(stream(False), monoid), monoid)
        raw_staged = SCAN_STATS.bytes_staged
        assert SCAN_STATS.ingest_overlap_frac >= 0.5
        monkeypatch.delenv("DEEQU_TORCH_ENCODED_INGEST")
        SCAN_STATS.reset()
        got = _metrics(PortRunner.do_analysis_run(stream(True), monoid), monoid)
        snap = SCAN_STATS.snapshot()
    assert got == ref
    assert snap["chunks_staged"] == 8
    assert snap["ingest_overlap_frac"] == 7 / 8
    assert 0 < snap["bytes_staged"] * 2 <= raw_staged
    assert snap["device_fetches"] == 1
    assert snap["encoded_scan_passes"] == 1


def test_stream_layout_demotes_encoding_lost_midstream():
    """A source whose later batch loses the encoding (a high-cardinality
    fallback mid-stream) packs that batch decoded; the metrics are those of
    the whole data."""
    from deequ_tpu_torch.data.streaming import StreamingTable
    from deequ_tpu_torch.data.table import Field, Schema

    rng = np.random.default_rng(21)
    f1 = rng.integers(0, 10, 4000).astype(np.float64)
    f2 = rng.normal(size=4000)  # not encodable
    b1 = ColumnarTable([Column("f", DType.FRACTIONAL, values=f1)])
    b1.encode()
    b2 = ColumnarTable([Column("f", DType.FRACTIONAL, values=f2)])
    assert b1["f"].encoding is not None and b2["f"].encoding is None

    class TwoBatchSource:
        schema = Schema([Field("f", DType.FRACTIONAL)])
        num_rows = 8000
        _batch_rows = 4000

        def batches(self, columns=None, batch_rows=None):
            yield b1
            yield b2

    analyzers = [port_analyzers.Size(), port_analyzers.Mean("f"), port_analyzers.Minimum("f")]
    with use_device("cpu"):
        SCAN_STATS.reset()
        ctx = PortRunner.do_analysis_run(StreamingTable(TwoBatchSource()), analyzers)
        assert SCAN_STATS.encoded_scan_passes == 1
        whole = PortRunner.do_analysis_run(
            ColumnarTable([Column("f", DType.FRACTIONAL, values=np.concatenate([f1, f2]))]),
            analyzers)
    assert ctx.metric(analyzers[0]).value.get() == 8000
    assert ctx.metric(analyzers[2]).value.get() == np.concatenate([f1, f2]).min()
    assert ctx.metric(analyzers[1]).value.get() == pytest.approx(
        whole.metric(analyzers[1]).value.get(), rel=1e-12)
