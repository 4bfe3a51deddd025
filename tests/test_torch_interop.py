"""Import of deequ's (Scala/Spark) persisted artifacts into the port
(``deequ_tpu_torch/interop``) against the reference's import on the CPU:
the twins of the 11 tests of tests/test_interop.py.

The fixtures are the reference test's, built by hand from deequ's format
(big-endian binary states, StateProvider.scala:186-311; Gson repository
JSON, AnalysisResultSerde.scala:38-635). Held to:

- the murmur3 hashes and state identifiers equal to the reference's;
- every state the port loads equal to the reference's load of the same
  files, through the shared state format: ``state_to_bytes`` of the
  port's state equals the reference's ``serialize_state`` byte for byte;
- imported repository JSON giving the same AnalysisResults: the port's
  repository serde of them equals the reference's byte for byte;
- the sketch states refused with the same rationale;
- ``interop``'s carrying helpers (``table_from_arrays``,
  ``state_from_fields``, ``state_from_bytes``, ``state_to_bytes``) still
  under the same import path.
"""

import json
import struct

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_an
import deequ_tpu.interop as ref_interop
import deequ_tpu.repository as ref_repo
import deequ_tpu.repository.serde as ref_serde
import deequ_tpu_torch.analyzers as port_an
from deequ_tpu.states.serde import serialize_state as ref_serialize_state
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Correlation,
    DataType,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Uniqueness,
)
from deequ_tpu_torch.interop import (
    import_repository_json,
    load_reference_state,
    murmur3_x86_32,
    reference_state_identifier,
    scala_murmur3_string_hash,
    state_from_bytes,
    state_from_fields,
    state_to_bytes,
    table_from_arrays,
)
from deequ_tpu_torch.repository import serde as port_serde
from test_interop import _GSON_FIXTURE

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _same_state(port_state, ref_state):
    """The two packages' states of one analyzer, equal in the shared state
    format, byte for byte."""
    assert state_to_bytes(port_state) == ref_serialize_state(ref_state)


def _ref_twin(analyzer):
    """The reference's analyzer of the same class and arguments."""
    return getattr(ref_an, type(analyzer).__name__)(
        *[getattr(analyzer, f.name) for f in analyzer.__dataclass_fields__.values()])


def test_scala_murmur3_known_relations():
    h1 = scala_murmur3_string_hash("Size(None)", 42)
    assert h1 == scala_murmur3_string_hash("Size(None)", 42)
    assert h1 != scala_murmur3_string_hash("Size(None)", 43)
    assert h1 != scala_murmur3_string_hash("Size(None) ", 42)
    assert -(2 ** 31) <= h1 < 2 ** 31
    assert reference_state_identifier(Size()) == str(h1)
    assert reference_state_identifier("Size(None)") == str(h1)
    assert h1 == ref_interop.scala_murmur3_string_hash("Size(None)", 42)
    for analyzer in (Size(), Completeness("att1"), Mean("price", "x > 0"),
                     Uniqueness(["a", "b"]), Correlation("a", "b")):
        assert reference_state_identifier(analyzer) == ref_interop.reference_state_identifier(
            _ref_twin(analyzer))


def _write(prefix, analyzer, payload, tmp_path):
    ident = reference_state_identifier(analyzer)
    (tmp_path / f"{prefix}-{ident}.bin").write_bytes(payload)
    return str(tmp_path / prefix)


def test_portable_binary_states_round_trip(tmp_path):
    cases = [
        (Size(), struct.pack(">q", 12345), ("num_matches", 12345)),
        (Completeness("att1"), struct.pack(">qq", 80, 100), ("num_matches", 80)),
        (Mean("price"), struct.pack(">dq", 199.5, 42), ("total", 199.5)),
        (Minimum("x"), struct.pack(">d", -3.25), ("min_value", -3.25)),
        (StandardDeviation("x"), struct.pack(">ddd", 100.0, 5.5, 250.0), ("m2", 250.0)),
        (Correlation("a", "b"), struct.pack(">6d", 10.0, 1.0, 2.0, 3.0, 4.0, 5.0),
         ("ck", 3.0)),
        (DataType("mixed"), struct.pack(">i", 40) + struct.pack(">5q", 1, 2, 3, 4, 5),
         ("num_string", 5)),
    ]
    for analyzer, payload, (attr, want) in cases:
        prefix = _write("states", analyzer, payload, tmp_path)
        state = load_reference_state(prefix, analyzer)
        assert getattr(state, attr) == want, analyzer
        _same_state(state, ref_interop.load_reference_state(prefix, _ref_twin(analyzer)))


def test_mean_state_metric_matches_reference_semantics(tmp_path):
    prefix = _write("s", Mean("p"), struct.pack(">dq", 15.0, 6), tmp_path)
    state = load_reference_state(prefix, Mean("p"))
    assert state.metric_value() == 15.0 / 6
    assert state.metric_value() == ref_interop.load_reference_state(
        prefix, ref_an.Mean("p")).metric_value()


def test_sketch_states_refuse_with_algebra_rationale(tmp_path):
    for port, ref in ((ApproxCountDistinct("x"), ref_an.ApproxCountDistinct("x")),
                      (ApproxQuantile("x", 0.5), ref_an.ApproxQuantile("x", 0.5))):
        with pytest.raises(ValueError, match="algebra differs") as got:
            load_reference_state(str(tmp_path / "s"), port)
        with pytest.raises(ValueError) as want:
            ref_interop.load_reference_state(str(tmp_path / "s"), ref)
        assert str(got.value) == str(want.value)


def _freq_files(tmp_path, analyzer, columns: dict, num_rows: int):
    """The reference's Parquet frequency table and num_rows file, written
    through the port's writer."""
    from deequ_tpu_torch.data.io import write_parquet
    from deequ_tpu_torch.data.table import ColumnarTable

    ident = reference_state_identifier(analyzer)
    write_parquet(ColumnarTable.from_pydict(columns),
                  str(tmp_path / f"s-{ident}-frequencies.pqt"))
    (tmp_path / f"s-{ident}-num_rows.bin").write_bytes(struct.pack(">q", num_rows))
    return str(tmp_path / "s")


def test_frequency_state_from_parquet(tmp_path):
    analyzer = Uniqueness(["att1"])
    prefix = _freq_files(tmp_path, analyzer, {"att1": ["a", "b", "c"],
                                              "absolute": [5, 1, 1]}, 7)
    state = load_reference_state(prefix, analyzer)
    assert state.num_rows == 7
    assert state.as_dict() == {("a",): 5, ("b",): 1, ("c",): 1}
    assert analyzer.compute_metric_from(state).value.get() == 2 / 7
    _same_state(state, ref_interop.load_reference_state(prefix, ref_an.Uniqueness(["att1"])))


def test_repository_json_import_and_anomaly_continuity():
    from deequ_tpu_torch.anomaly import AnomalyDetector, RelativeRateOfChangeStrategy
    from deequ_tpu_torch.anomaly.history import DataPoint
    from deequ_tpu_torch.metrics import Entity
    from deequ_tpu_torch.repository import InMemoryMetricsRepository

    repo = InMemoryMetricsRepository()
    assert import_repository_json(json.dumps(_GSON_FIXTURE), repo) == 2
    loaded = repo.load().with_tag_values({"env": "prod"}).get()
    assert len(loaded) == 2
    by_date = {r.result_key.data_set_date: r for r in loaded}
    first = by_date[1630000000000].analyzer_context.metric_map
    assert first[Size()].value.get() == 1000.0
    comp = [m for a, m in first.items() if type(a).__name__ == "Compliance"][0]
    assert comp.value.get() == 0.95
    assert comp.entity == Entity.MULTICOLUMN
    hist = [m for a, m in first.items() if type(a).__name__ == "Histogram"][0]
    assert hist.value.get().values["a"].absolute == 6

    ref_store = ref_repo.InMemoryMetricsRepository()
    ref_interop.import_repository_json(json.dumps(_GSON_FIXTURE), ref_store)
    ref_loaded = ref_store.load().with_tag_values({"env": "prod"}).get()
    assert port_serde.serialize(loaded) == ref_serde.serialize(ref_loaded)

    sizes = sorted((r.result_key.data_set_date, r.analyzer_context.metric_map[Size()])
                   for r in loaded)
    history = [DataPoint(t, m.value.get()) for t, m in sizes]
    detector = AnomalyDetector(
        RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0))
    assert len(detector.is_new_point_anomalous(
        history, DataPoint(1630000200000, 1005.0)).anomalies) == 0
    assert len(detector.is_new_point_anomalous(
        history, DataPoint(1630000300000, 10.0)).anomalies) == 1


def test_scala_murmur3_utf16_surrogates_and_null_count_rows(tmp_path):
    h_emoji = scala_murmur3_string_hash("\U0001F600", 42)
    h_bmp2 = scala_murmur3_string_hash("ab", 42)
    h_bmp1 = scala_murmur3_string_hash("a", 42)
    assert len({h_emoji, h_bmp2, h_bmp1}) == 3
    assert h_emoji == scala_murmur3_string_hash(chr(0xD83D) + chr(0xDE00), 42)
    assert h_emoji == ref_interop.scala_murmur3_string_hash("\U0001F600", 42)

    analyzer = Uniqueness(["k"])
    prefix = _freq_files(tmp_path, analyzer, {"k": ["a", "b", "c"],
                                              "absolute": [5, None, 2]}, 7)
    state = load_reference_state(prefix, analyzer)
    assert state.as_dict() == {("a",): 5, ("c",): 2}
    _same_state(state, ref_interop.load_reference_state(prefix, ref_an.Uniqueness(["k"])))


def test_murmur3_x86_32_published_vectors():
    vectors = [
        (b"", 0x00000000, 0x00000000),
        (b"", 0x00000001, 0x514E28B7),
        (b"", 0xFFFFFFFF, 0x81F16F39),
        (b"\x00\x00\x00\x00", 0x00000000, 0x2362F9DE),
        (b"\x21\x43\x65\x87", 0x00000000, 0xF55B516B),
        (b"\x21\x43\x65\x87", 0x5082EDEE, 0x2362F9DE),
        (b"\x21\x43\x65", 0x00000000, 0x7E4A8634),
        (b"\x21\x43", 0x00000000, 0xA0F7B07A),
        (b"\x21", 0x00000000, 0x72661CF4),
    ]
    for data, seed, want in vectors:
        assert murmur3_x86_32(data, seed) == want, (data, hex(seed))
    h = murmur3_x86_32(b"foo", 0)
    assert (h - (1 << 32) if h >= (1 << 31) else h) == -156908512


def test_scala_murmur3_composition_from_verified_primitives():
    from deequ_tpu_torch.interop.deequ_import import _fmix, _mix, _mix_last

    def expect(units, seed):
        h = seed & 0xFFFFFFFF
        i = 0
        while i + 1 < len(units):
            h = _mix(h, ((units[i] << 16) + units[i + 1]) & 0xFFFFFFFF)
            i += 2
        if i < len(units):
            h = _mix_last(h, units[i])
        return _fmix((h ^ len(units)) & 0xFFFFFFFF)

    def signed(h):
        return h - (1 << 32) if h >= (1 << 31) else h

    cases = [("", []), ("a", [0x61]), ("ab", [0x61, 0x62]), ("abc", [0x61, 0x62, 0x63]),
             ("Size(None)", [ord(c) for c in "Size(None)"]),
             ("\U0001D11E", [0xD834, 0xDD1E]), ("\U0001D11Ex", [0xD834, 0xDD1E, 0x78]),
             ("\ud834", [0xD834])]
    for s, units in cases:
        for seed in (42, 0, 1):
            got = scala_murmur3_string_hash(s, seed)
            assert got == signed(expect(units, seed)), (s, seed)
            assert got == ref_interop.scala_murmur3_string_hash(s, seed)


def test_frequency_state_multicolumn_mixed_dtypes(tmp_path):
    from deequ_tpu_torch.analyzers import CountDistinct
    from deequ_tpu_torch.data.table import ColumnarTable
    from deequ_tpu_torch.ops.segment import group_counts_state

    analyzer = Uniqueness(["cat", "num"])
    prefix = _freq_files(tmp_path, analyzer, {"cat": ["a", "a", "b", None],
                                              "num": [1, 2, 1, 3],
                                              "absolute": [4, 1, 1, 2]}, 8)
    state = load_reference_state(prefix, analyzer)
    assert state.columns == ("cat", "num")
    assert state.num_rows == 8
    d = state.as_dict()
    assert d[("a", 1)] == 4 and d[("a", 2)] == 1 and d[("b", 1)] == 1 and d[(None, 3)] == 2
    assert analyzer.compute_metric_from(state).value.get() == 2 / 8
    assert CountDistinct(["cat", "num"]).compute_metric_from(state).value.get() == 4.0
    _same_state(state, ref_interop.load_reference_state(
        prefix, ref_an.Uniqueness(["cat", "num"])))

    native = ColumnarTable.from_pydict({"cat": ["a", "z"], "num": [1, 9]})
    merged = state.sum(group_counts_state(native, ["cat", "num"], torch.device("cpu")))
    md = merged.as_dict()
    assert md[("a", 1)] == 5 and md[("z", 9)] == 1
    assert merged.num_rows == 10


def test_histogram_state_round_trip_compute_metric_from(tmp_path):
    from deequ_tpu_torch.analyzers import Histogram

    analyzer = Histogram("cat", max_detail_bins=2)
    prefix = _freq_files(tmp_path, analyzer, {"cat": ["x", "y", "NullValue", "z"],
                                              "absolute": [5, 3, 1, 1]}, 10)
    state = load_reference_state(prefix, analyzer)
    dist = analyzer.compute_metric_from(state).value.get()
    assert dist.number_of_bins == 4
    assert set(dist.values) == {"x", "y"}
    assert dist.values["x"].absolute == 5 and dist.values["x"].ratio == 0.5
    assert dist.values["y"].absolute == 3
    back = state_from_bytes(state_to_bytes(state))
    assert back.as_dict() == state.as_dict()
    assert analyzer.compute_metric_from(back).value.get().values == dist.values
    _same_state(state, ref_interop.load_reference_state(
        prefix, ref_an.Histogram("cat", max_detail_bins=2)))


def test_carrying_helpers_keep_their_import_path():
    """``deequ_tpu_torch.interop`` is a package now; its carrying helpers
    answer as before."""
    table = table_from_arrays([{"name": "x", "dtype": "fractional",
                                "values": np.array([1.0, 2.0]), "mask": None}])
    assert table["x"].to_pylist() == [1.0, 2.0]
    state = state_from_fields("MeanState", {"total": 3.0, "count": 2})
    assert state_from_bytes(state_to_bytes(state)) == state
    assert port_an.Mean("x").compute_metric_from(state).value.get() == 1.5
