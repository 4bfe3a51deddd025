"""The port's state format (``deequ_tpu_torch/states/serde.py``) against the
reference's (``deequ_tpu/states/serde.py``), byte for byte:

- every golden blob of tests/test_state_serde.py decodes through the port
  and re-encodes to the bytes the reference re-encodes it to (the v4
  goldens to themselves);
- each of the 13 states of its STATES list, built in the port, round-trips;
- each state kind carried across by its fields serialises to identical
  bytes in both packages, and each package decodes the other's bytes to
  equal fields — frequency tables over str, int, float and bool keys with
  nulls, NaN and -0.0 keys; KLL's rng_count and HLL's hash_version ride;
- bad magic, a newer version and a pickle header fail as the reference
  fails; tag 13 (the spilled frequencies) decodes to a disk-backed state
  (its cross-package parity is in tests/test_torch_spill.py);
- state files: checksummed and atomic; a truncated file raises
  CorruptStateException in both packages, whichever wrote it.
"""

import dataclasses
import struct
import sys

import numpy as np
import pytest

import deequ_tpu.analyzers.grouping as ref_grouping
import deequ_tpu.analyzers.sketches as ref_sketches
import deequ_tpu.analyzers.states as ref_states
import deequ_tpu.states as ref_provider
import deequ_tpu.states.serde as ref_serde
import deequ_tpu_torch.states as port_provider
import deequ_tpu_torch.states.serde as port_serde
from deequ_tpu.exceptions import CorruptStateException as RefCorrupt
from deequ_tpu.ops.kll import KLLSketchState as RefSketch
from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.interop import state_from_bytes, state_from_fields, state_to_bytes

pytestmark = pytest.mark.torch_port


def _ref_kll_state():
    sketch = RefSketch(sketch_size=64)
    sketch.update_batch(np.arange(500, dtype=np.float64))
    return ref_sketches.KLLState(sketch, 0.0, 499.0)


def _ref_states():
    """tests/test_state_serde.py's STATES, built in the reference."""
    S = ref_states
    F = ref_grouping.FrequenciesAndNumRows
    return [
        S.NumMatches(42),
        S.NumMatchesAndCount(7, 10),
        S.MinState(-3.5),
        S.MaxState(99.25),
        S.MeanState(55.5, 11),
        S.SumState(-123.75),
        S.StandardDeviationState(10.0, 2.5, 7.25),
        S.CorrelationState(5.0, 1.0, 2.0, 3.0, 4.0, 5.0),
        S.DataTypeHistogram(1, 2, 3, 4, 5),
        ref_sketches.ApproxCountDistinctState(tuple(np.arange(512) % 9)),
        _ref_kll_state(),
        F.from_dict(("a", "b"), {("x", 1): 3, (None, 2): 1, ("y", None): 2}, 6),
        F.from_dict(("c", "d"), {(True, 2.5): 4, (False, None): 1, (None, -0.5): 2}, 7),
    ]


STATE_IDS = [
    "NumMatches", "NumMatchesAndCount", "MinState", "MaxState", "MeanState",
    "SumState", "StandardDeviationState", "CorrelationState",
    "DataTypeHistogram", "ApproxCountDistinctState", "KLLState",
    "Frequencies-str-int", "Frequencies-bool-float",
]


def _fields(state):
    """(kind, fields) of a state of either package — the interop form."""
    kind = type(state).__name__
    if kind == "ApproxCountDistinctState":
        return kind, {"registers": list(state.registers),
                      "hash_version": state.hash_version}
    if kind == "KLLState":
        s = state.sketch
        return kind, {"compactors": [np.asarray(c) for c in s.compactors],
                      "count": s.count, "rng_count": s.rng_count,
                      "sketch_size": s.sketch_size,
                      "shrinking_factor": s.shrinking_factor,
                      "global_min": state.global_min, "global_max": state.global_max}
    if kind == "FrequenciesAndNumRows":
        return kind, {"columns": state.columns, "key_values": state.key_values,
                      "key_nulls": state.key_nulls, "counts": state.counts,
                      "num_rows": state.num_rows}
    return kind, dataclasses.asdict(state)


def _same(a, b) -> bool:
    """Equal fields: arrays by dtype kind and bits (NaN and -0.0 count)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not isinstance(a, str):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            return (a.shape == b.shape and a.dtype == b.dtype
                    and np.array_equal(a.view(np.uint64), b.view(np.uint64)))
        return a.dtype.kind == b.dtype.kind and np.array_equal(a, b)
    floats = (float, np.floating)
    if isinstance(a, floats) or isinstance(b, floats):
        return (isinstance(a, floats) and isinstance(b, floats)
                and struct.pack("<d", a) == struct.pack("<d", b))
    return a == b


def _port_state(ref_state):
    kind, fields = _fields(ref_state)
    return state_from_fields(kind, fields)


# -- goldens --------------------------------------------------------------

GOLDENS = {
    "num_matches": "44515453" "0400" "0100" "2a00000000000000",
    "mean_state": "44515453" "0400" "0500" "000000000000f83f" "0300000000000000",
    "v1_kll": (
        "44515453" "0100" "0b00" "0008000000000000" "7b14ae47e17ae43f"
        "0100000000000000" "000000000000f83f" "000000000000f83f"
        "0100000000000000" "0100000000000000" "000000000000f83f"
    ),
    "v1_scalar": "44515453" "0100" "0100" "2a00000000000000",
}


def _v2_frequency_blob() -> bytes:
    """tests/test_state_serde.py's hand-built v2 frequency envelope."""
    def pack_str(s):
        raw = s.encode("utf-8")
        return struct.pack("<q", len(raw)) + raw

    payload = struct.pack("<q", 1) + pack_str("g")
    payload += struct.pack("<q", 3) + struct.pack("<q", 2)
    payload += bytes([1]) + pack_str("a") + struct.pack("<q", 2)
    payload += bytes([0]) + struct.pack("<q", 1)
    return b"DQTS" + struct.pack("<HH", 2, 12) + payload


def _golden_blobs():
    blobs = {name: bytes.fromhex(h) for name, h in GOLDENS.items()}
    regs = tuple([2, 0, 5] + [0] * 509)
    blobs["hll"] = ref_serde.serialize_state(ref_sketches.ApproxCountDistinctState(regs))
    assert blobs["hll"].hex().startswith(
        "44515453" "0400" "0a00" "0002000000000000" "020005")
    blobs["v2_frequencies"] = _v2_frequency_blob()
    return blobs


@pytest.mark.parametrize("name", ["num_matches", "mean_state", "hll", "v1_kll",
                                  "v1_scalar", "v2_frequencies"])
def test_goldens_decode_and_reencode_like_the_reference(name):
    blob = _golden_blobs()[name]
    port = port_serde.deserialize_state(blob)
    ref = ref_serde.deserialize_state(blob)
    assert _same(_fields(port), _fields(ref))
    again = port_serde.serialize_state(port)
    assert again == ref_serde.serialize_state(ref)
    if blob[4:6] == struct.pack("<H", port_serde.VERSION):
        assert again == blob


def test_old_blobs_take_the_reference_defaults():
    blobs = _golden_blobs()
    kll = port_serde.deserialize_state(blobs["v1_kll"])
    assert kll.sketch.rng_count == 0 and kll.sketch.count == 1
    assert kll.sketch.quantile(0.5) == 1.5
    freq = port_serde.deserialize_state(blobs["v2_frequencies"])
    assert freq.as_dict() == {("a",): 2, (None,): 1} and freq.num_rows == 3
    pre_v4 = bytearray(blobs["hll"][:-2])  # a v3 HLL blob: no hash_version
    pre_v4[4:6] = struct.pack("<H", 3)
    assert port_serde.deserialize_state(bytes(pre_v4)).hash_version == 1


# -- round trips and cross-package bytes ------------------------------------


@pytest.mark.parametrize("index", range(13), ids=STATE_IDS)
def test_round_trip_in_the_port(index):
    state = _port_state(_ref_states()[index])
    data = port_serde.serialize_state(state)
    assert data[:4] == b"DQTS"
    back = port_serde.deserialize_state(data)
    assert type(back) is type(state)
    assert _same(_fields(back), _fields(state))
    assert port_serde.serialize_state(back) == data
    if type(state).__name__ == "KLLState":
        for q in (0.1, 0.5, 0.9):
            assert back.sketch.quantile(q) == state.sketch.quantile(q)
    elif type(state).__name__ != "FrequenciesAndNumRows":
        assert back == state


@pytest.mark.parametrize("index", range(13), ids=STATE_IDS)
def test_states_cross_packages_byte_for_byte(index):
    ref = _ref_states()[index]
    port = _port_state(ref)
    ref_bytes = ref_serde.serialize_state(ref)
    assert state_to_bytes(port) == ref_bytes
    assert _same(_fields(state_from_bytes(ref_bytes)), _fields(ref))
    assert _same(_fields(ref_serde.deserialize_state(state_to_bytes(port))), _fields(port))


def _key_column_state(pkg_grouping, kind: str):
    """A one-column frequency state of each key kind, with a null key."""
    if kind == "str":
        values = np.array(["", "a", "zz", "été", "x"], dtype=np.str_)
    elif kind == "int":
        values = np.array([-(2 ** 62), -1, 0, 7, 2 ** 62], dtype=np.int64)
    elif kind == "float":
        values = np.array([np.nan, -0.0, 5e-324, -np.inf, 1.5])
    else:
        values = np.array([True, False, True, False, False])
    nulls = np.array([False, False, False, False, True])
    return pkg_grouping.FrequenciesAndNumRows(
        ("k",), (values,), (nulls,), np.array([3, 1, 4, 1, 5], dtype=np.int64), 14
    )


@pytest.mark.parametrize("kind", ["str", "int", "float", "bool"])
def test_key_column_kinds_cross_packages(kind):
    import deequ_tpu_torch.analyzers.grouping as port_grouping

    ref = _key_column_state(ref_grouping, kind)
    port = _key_column_state(port_grouping, kind)
    ref_bytes = ref_serde.serialize_state(ref)
    assert port_serde.serialize_state(port) == ref_bytes
    back = port_serde.deserialize_state(ref_bytes)
    assert _same(_fields(back), _fields(port))
    assert port_serde.serialize_state(back) == ref_bytes
    assert _same(_fields(ref_serde.deserialize_state(port_serde.serialize_state(back))),
                 _fields(ref))


def test_nan_keys_are_one_shared_object_after_decode():
    import deequ_tpu_torch.analyzers.grouping as port_grouping

    state = _key_column_state(port_grouping, "float")
    back = port_serde.deserialize_state(port_serde.serialize_state(state))
    assert back == state  # one canonical NaN: the state equals itself
    merged = back.sum(back)  # each key meets itself: no group is added
    assert merged.num_groups == state.num_groups
    keys = [k for (k,), _ in merged.frequencies]
    assert sum(1 for k in keys if k is not None and k != k) == 1


def test_kll_rng_count_and_hll_hash_version_ride():
    ref = _ref_kll_state()
    ref.sketch.rng_count = 12345
    port = state_from_bytes(ref_serde.serialize_state(ref))
    assert port.sketch.rng_count == 12345
    hll = ref_sketches.ApproxCountDistinctState(tuple([1] * 512), hash_version=1)
    assert state_from_bytes(ref_serde.serialize_state(hll)).hash_version == 1


# -- refusals ---------------------------------------------------------------


def _newer(data: bytes) -> bytes:
    out = bytearray(data)
    out[4:6] = (99).to_bytes(2, "little")
    return bytes(out)


@pytest.mark.parametrize("blob", [
    b"NOPE" + b"\x00" * 16,
    _newer(ref_serde.serialize_state(ref_states.NumMatches(1))),
    b"\x80\x04\x95" + b"\x00" * 16,
    b"DQTS" + struct.pack("<HH", 4, 99) + b"\x00" * 8,
], ids=["bad-magic", "newer-version", "pickle-header", "unknown-tag"])
def test_refusals_match_the_reference(blob):
    with pytest.raises(ValueError) as ref_err:
        ref_serde.deserialize_state(blob)
    with pytest.raises(ValueError) as port_err:
        port_serde.deserialize_state(blob)
    assert str(port_err.value) == str(ref_err.value)


def test_spilled_frequencies_tag_is_not_yet_ported():
    """Tag 13 is ported: a blob of no column, no row and no block decodes
    to an empty disk-backed state that encodes back to the same bytes."""
    from deequ_tpu_torch.spill import SpilledFrequencies

    blob = (b"DQTS" + struct.pack("<HH", 4, 13) + struct.pack("<q", 0) * 2
            + struct.pack("<q", 1 << 20) + struct.pack("<q", -1))
    state = port_serde.deserialize_state(blob)
    assert isinstance(state, SpilledFrequencies)
    assert state.num_rows == 0 and state.columns == ()
    assert port_serde.serialize_state(state) == blob


def test_unknown_state_type_raises():
    with pytest.raises(TypeError):
        port_serde.serialize_state(object())  # type: ignore[arg-type]


# -- state files ------------------------------------------------------------


def test_state_files_are_checksummed_binary(tmp_path):
    from deequ_tpu_torch.analyzers import Mean, MeanState
    from deequ_tpu_torch.resilience import unwrap_checksum

    provider = port_provider.FileSystemStateProvider(str(tmp_path))
    provider.persist(Mean("x"), MeanState(10.0, 4))
    files = list(tmp_path.glob("*.state"))
    assert [f.name for f in files] == [port_provider.state_file_name(Mean("x"))]
    raw = files[0].read_bytes()
    assert raw[:4] == b"DQX1" and unwrap_checksum(raw, "state")[:4] == b"DQTS"
    assert provider.load(Mean("x")) == MeanState(10.0, 4)
    assert not list(tmp_path.glob("*.tmp.*"))  # the temp file was renamed away


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_truncated_state_file_is_corrupt_in_both_packages(tmp_path, writer):
    import deequ_tpu.analyzers as ref_analyzers
    import deequ_tpu_torch.analyzers as port_analyzers

    ref_p = ref_provider.FileSystemStateProvider(str(tmp_path))
    port_p = port_provider.FileSystemStateProvider(str(tmp_path))
    if writer == "port":
        port_p.persist(port_analyzers.Sum("x"), port_analyzers.SumState(1.5))
    else:
        ref_p.persist(ref_analyzers.Sum("x"), ref_states.SumState(1.5))
    (path,) = tmp_path.glob("*.state")
    assert port_p.load(port_analyzers.Sum("x")).total == 1.5
    path.write_bytes(path.read_bytes()[:-3])
    with pytest.raises(CorruptStateException, match="torn write"):
        port_p.load(port_analyzers.Sum("x"))
    with pytest.raises(RefCorrupt, match="torn write"):
        ref_p.load(ref_analyzers.Sum("x"))


def test_object_store_path_without_fsspec_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="fsspec"):
        port_provider.FileSystemStateProvider("s3://bucket/states")


def test_registered_in_memory_filesystem_carries_state_files():
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.states import NumMatches
    from deequ_tpu_torch.data import fs

    mem = fs.InMemoryFileSystem()
    fs.register_filesystem("memtest", lambda path: mem)
    try:
        provider = port_provider.FileSystemStateProvider("memtest://states")
        provider.persist(Size(), NumMatches(9))
        assert list(mem.files) == [
            "memtest://states/" + port_provider.state_file_name(Size())]
        assert provider.load(Size()) == NumMatches(9)
    finally:
        fs._REGISTRY.pop("memtest")


def test_retry_policy_retries_transient_errors_then_gives_up():
    from deequ_tpu_torch.exceptions import RetryExhaustedException
    from deequ_tpu_torch.resilience import RetryPolicy

    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert policy.call(flaky) == "ok" and len(calls) == 3
    with pytest.raises(RetryExhaustedException) as err:
        policy.call(lambda: (_ for _ in ()).throw(OSError("down")), what="read x")
    assert err.value.attempts == 3 and isinstance(err.value.__cause__, OSError)
    with pytest.raises(KeyError):  # not retryable: raised at once
        policy.call(lambda: {}["k"])
