"""The port's frame transport and durable request ledger
(deequ_tpu_torch/serve: transport.py, ledger.py) and the in-process
fleet's ``ledger_dir`` replay on the CPU, each held against the reference.

- The codec (twins of the six codec tests of tests/test_process_fleet.py):
  a frame round trip, a stream read to a clean EOF, a stream torn at every
  byte typed, a bad magic, length or crc typed, blobs carrying closures
  and typing damage, the loopback's close; and one message dict encodes to
  the same frame bytes in both packages (the wire and the ledger are the
  reference's byte for byte), a frame of either decodes in the other, and
  frames cross a real socket pair.
- The ledger (twins of the four ledger tests of tests/test_process_fleet.py
  and the two ledger-only tests of tests/test_lease_fencing.py): accept,
  tombstone and outstanding, torn-tail recovery at every byte to a
  ``.corrupt`` sidecar, the raise mode typed, damage mid-file distrusting
  the rest, reconciliation across epochs, the stale duplicate losing; and
  each package reads the ledger file the other wrote.
- Without cloudpickle (stdlib pickle forced): tables, analyzers and
  results still travel, and a check holding a lambda fails at submit with
  the same error in both packages.
- The in-process fleet's ledger: accepted requests stopped before they
  resolve replay on a fresh fleet over the same directory, onto their
  original futures, exactly once and bit for bit their serial runs — held
  against the reference's ``VerificationFleet(ledger_dir=...)`` on the
  same submissions: the same outstanding set, the same replayed results.
"""

import io
import os
import pickle
import socket
import struct
import time

import numpy as np
import pytest
import torch

import deequ_tpu.serve.ledger as ref_ledger
import deequ_tpu.serve.transport as ref_tr
import deequ_tpu_torch.serve.ledger as port_ledger
import deequ_tpu_torch.serve.transport as port_tr
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.exceptions import CorruptStateException as RefCorrupt
from deequ_tpu_torch import use_device
from deequ_tpu_torch.exceptions import CorruptStateException as PortCorrupt
from deequ_tpu_torch.parallel.mesh import use_mesh as port_use_mesh
from torch_parity import assert_metric_parity, port_table, ref_column

pytestmark = [pytest.mark.torch_port, pytest.mark.pfleet]

SIDES = {"ref": (ref_tr, ref_ledger, RefCorrupt), "port": (port_tr, port_ledger, PortCorrupt)}


@pytest.fixture(autouse=True)
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), port_use_mesh(None):
        yield
    torch.set_num_threads(threads)


def _ref_table(n, seed):
    r = np.random.default_rng(seed)
    return RefTable([
        ref_column("x", "fractional", r.normal(100, 5, n), r.random(n) > 0.05),
        ref_column("i", "integral", r.integers(0, 50, n).astype(np.float64), np.ones(n, bool)),
    ])


def _twin(scenario):
    """``scenario(transport, ledger, corrupt_type)`` on both packages: the
    two records must be equal. Returns the port's."""
    want = scenario(*SIDES["ref"])
    got = scenario(*SIDES["port"])
    assert got == want, f"port {got!r}\nreference {want!r}"
    return got


# -- the frame codec -------------------------------------------------------------


def test_frame_roundtrip():
    def scenario(tr, _, __):
        msgs = ({"t": "ping", "seq": 7},
                {"t": "submit", "id": "a" * 32, "deadline_left_s": None,
                 "slo": {"cls": "standard", "weight": 1.0, "deadline_ms": None}},
                {})
        for msg in msgs:
            assert tr.decode_frame(tr.encode_frame(msg)) == msg
        return [tr.encode_frame(m) for m in msgs]

    _twin(scenario)


def test_frame_stream_reads_to_clean_eof():
    def scenario(tr, _, __):
        a, b = {"t": "hello", "pid": 1}, {"t": "pong", "seq": 2}
        stream = io.BytesIO(tr.encode_frame(a) + tr.encode_frame(b))
        out = [tr.read_frame(stream), tr.read_frame(stream), tr.read_frame(stream)]
        assert out == [a, b, None]
        return out

    _twin(scenario)


def test_frame_torn_at_every_byte_boundary_is_typed():
    def scenario(tr, _, corrupt):
        whole = tr.encode_frame({"t": "result", "id": "x" * 32, "ok": True,
                                 "payload_blob": "QUJD"})
        messages = []
        for cut in range(len(whole)):
            stream = io.BytesIO(whole[:cut])
            if cut == 0:
                assert tr.read_frame(stream) is None
                continue
            with pytest.raises(corrupt) as e:
                tr.read_frame(stream)
            messages.append(str(e.value))
        stream = io.BytesIO(whole + whole[: tr.FRAME_HEADER_BYTES + 3])
        assert tr.read_frame(stream) is not None
        with pytest.raises(corrupt):
            tr.read_frame(stream)
        return messages

    _twin(scenario)


def test_frame_bad_magic_and_length_typed():
    def scenario(tr, _, corrupt):
        whole = bytearray(tr.encode_frame({"t": "ping"}))
        bad_magic = bytes([whole[0] ^ 0xFF]) + bytes(whole[1:])
        bad_len = bytearray(whole)
        bad_len[8:16] = (1 << 40).to_bytes(8, "little")
        flipped = bytearray(whole)
        flipped[-1] ^= 0x01
        out = []
        for damaged in (bad_magic, bytes(bad_len), bytes(flipped)):
            with pytest.raises(corrupt) as e:
                tr.read_frame(io.BytesIO(damaged))
            out.append(str(e.value))
        return out

    _twin(scenario)


def test_blob_carries_closures_and_types_corruption():
    pytest.importorskip("cloudpickle")

    def scenario(tr, _, corrupt):
        fn = tr.load_blob(tr.dump_blob(lambda x: x + 41))
        assert fn(1) == 42
        with pytest.raises(corrupt):
            tr.load_blob("!!not base64!!")
        with pytest.raises(corrupt):
            tr.load_blob(tr.dump_blob({"k": 1})[:-10] + "AAAAAAAAAA")
        return fn(1)

    _twin(scenario)


def test_loopback_transport_close_semantics():
    def scenario(tr, _, __):
        a, b = tr.LoopbackTransport.pair()
        a.send({"t": "ping", "seq": 1})
        got = b.recv(timeout=1.0)
        assert got == {"t": "ping", "seq": 1}
        assert b.recv(timeout=0.01) is None
        a.close()
        with pytest.raises(tr.TransportClosedError):
            b.recv(timeout=1.0)
        with pytest.raises(tr.TransportClosedError):
            b.send({"t": "pong"})
        return got

    _twin(scenario)


def test_one_message_is_one_frame_in_both_packages():
    """The same dict encodes to the same bytes in both packages, and a
    frame of either decodes in the other: the wire and the ledger are the
    reference's format byte for byte."""
    msg = {"t": "submit", "id": "f" * 32, "tenant_blob": "QUJD", "epoch": 3,
           "slo": {"cls": "critical", "deadline_ms": 250.0, "weight": 2.0},
           "deadline_left_s": 0.125, "unicode": "é✓", "nested": [1, [2.5, None]]}
    frame = port_tr.encode_frame(msg)
    assert frame == ref_tr.encode_frame(msg)
    assert frame[:4] == b"DQX1" and port_tr.FRAME_HEADER_BYTES == ref_tr.FRAME_HEADER_BYTES
    assert ref_tr.decode_frame(frame) == msg
    assert port_tr.decode_frame(ref_tr.encode_frame(msg)) == msg
    assert port_tr.MAX_FRAME_BYTES == ref_tr.MAX_FRAME_BYTES


def test_socket_transport_carries_frames_and_reports_a_closed_peer():
    """Frames cross a real socket pair; a closed peer is
    TransportClosedError on the other end, and a poll with nothing to read
    returns None."""
    left, right = socket.socketpair()
    a, b = port_tr.SocketTransport(left), port_tr.SocketTransport(right)
    try:
        assert b.recv(timeout=0.01) is None
        for seq in range(3):
            a.send({"t": "ping", "seq": seq, "blob": port_tr.dump_blob(list(range(seq)))})
        got = [b.recv(timeout=1.0) for _ in range(3)]
        assert [m["seq"] for m in got] == [0, 1, 2]
        assert port_tr.load_blob(got[2]["blob"]) == [0, 1]
        a.close()
        with pytest.raises(port_tr.TransportClosedError):
            b.recv(timeout=1.0)
        with pytest.raises(port_tr.TransportClosedError):
            a.send({"t": "late"})
    finally:
        b.close()


# -- the durable ledger ---------------------------------------------------------------


def _mk_ledger(led_mod, path, n_accepts=3, resolve_first=0, mode="recover"):
    ledger = led_mod.RequestLedger(str(path), mode=mode)
    ids = []
    for i in range(n_accepts):
        accept_id = f"req{i:02d}" + "0" * 26
        ids.append(accept_id)
        ledger.append_accept(
            accept_id, tenant=f"t{i}", digest=f"d{i}", slo_cls="standard", deadline_ms=None,
            weight=1.0, deadline_left_s=None, work=(f"data{i}", (f"check{i}",), ()),
            quarantine={"t9": 3} if i == n_accepts - 1 else None)
    for i in range(resolve_first):
        ledger.append_resolve(ids[i])
    ledger.close()
    return ids


def _frame_ids(path, tr):
    """The record kinds and ids of a ledger file, frame by frame."""
    out = []
    with open(path, "rb") as f:
        while True:
            msg = tr.read_frame(f)
            if msg is None:
                return out
            out.append((msg["kind"], msg["id"]))


def test_ledger_accept_tombstone_outstanding(tmp_path):
    def scenario(tr, led, _):
        d = tmp_path / tr.__name__.split(".")[0]
        ids = _mk_ledger(led, d, n_accepts=3, resolve_first=1)
        reopened = led.RequestLedger(str(d))
        out = reopened.outstanding()
        assert list(out) == ids[1:]
        rec = out[ids[1]]
        assert led.RequestLedger.load_tenant(rec) == "t1"
        assert led.RequestLedger.load_work(rec) == ("data1", ("check1",), ())
        assert rec["accepted_wall"] > 0
        assert reopened.latest_quarantine() == {"t9": 3}
        reopened.close()
        return list(out), _frame_ids(os.path.join(str(d), led.LEDGER_FILENAME), tr)

    _twin(scenario)


def test_ledger_torn_tail_recovery_at_every_byte(tmp_path):
    def scenario(tr, led, _):
        d = tmp_path / tr.__name__.split(".")[0]
        ids = _mk_ledger(led, d, n_accepts=3)
        path = os.path.join(str(d), led.LEDGER_FILENAME)
        whole = open(path, "rb").read()
        bounds = []
        stream = io.BytesIO(whole)
        while tr.read_frame(stream) is not None:
            bounds.append(stream.tell())
        assert len(bounds) == 3
        last_start = bounds[1]
        torn = []
        for cut in range(last_start + 1, bounds[2]):
            with open(path, "wb") as f:
                f.write(whole[:cut])
            sidecar = path + led.CORRUPT_SUFFIX
            if os.path.exists(sidecar):
                os.unlink(sidecar)
            ledger = led.RequestLedger(str(d), mode="recover")
            assert [r["id"] for r in ledger.records] == ids[:2], cut
            assert ledger.torn_tail_bytes == cut - last_start, cut
            assert open(sidecar, "rb").read() == whole[last_start:cut], cut
            assert os.path.getsize(path) == last_start, cut
            ledger.append_resolve(ids[0])
            assert list(ledger.outstanding()) == [ids[1]]
            ledger.close()
            torn.append(ledger.torn_tail_bytes)
        # a second recovery keeps the first one's evidence
        with open(path, "ab") as f:
            f.write(b"\x01" * 5)
        led.RequestLedger(str(d), mode="recover").close()
        # the frames' sizes differ a little with the accept stamps' digits
        return (torn == list(range(1, bounds[2] - last_start)),
                sorted(p for p in os.listdir(str(d)) if "corrupt" in p))

    _twin(scenario)


def test_ledger_torn_tail_raise_mode_typed(tmp_path):
    def scenario(tr, led, corrupt):
        d = tmp_path / tr.__name__.split(".")[0]
        _mk_ledger(led, d, n_accepts=2)
        path = os.path.join(str(d), led.LEDGER_FILENAME)
        with open(path, "ab") as f:
            f.write(b"\x00" * 7)
        with pytest.raises(corrupt):
            led.RequestLedger(str(d), mode="raise")
        ledger = led.RequestLedger(str(d), mode="recover")
        assert len(ledger.records) == 2
        assert ledger.torn_tail_bytes == 7
        ledger.close()
        with pytest.raises(ValueError):
            led.RequestLedger(str(d), mode="ignore")
        return ledger.torn_tail_bytes

    _twin(scenario)


def test_ledger_mid_file_damage_distrusts_everything_after(tmp_path):
    def scenario(tr, led, _):
        d = tmp_path / tr.__name__.split(".")[0]
        ids = _mk_ledger(led, d, n_accepts=3)
        path = os.path.join(str(d), led.LEDGER_FILENAME)
        whole = bytearray(open(path, "rb").read())
        stream = io.BytesIO(bytes(whole))
        tr.read_frame(stream)
        first_end = stream.tell()
        whole[first_end + tr.FRAME_HEADER_BYTES + 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(whole))
        ledger = led.RequestLedger(str(d), mode="recover")
        assert [r["id"] for r in ledger.records] == ids[:1]
        assert ledger.torn_tail_bytes == len(whole) - first_end
        ledger.close()
        return [r["id"] for r in ledger.records]

    _twin(scenario)


def _accept(led, accept_id, epoch):
    led.append_accept(accept_id, tenant=f"t-{accept_id}", digest=f"d-{accept_id}",
                      slo_cls="standard", deadline_ms=None, weight=1.0, deadline_left_s=None,
                      work=("data", (), ()), epoch=epoch)


def test_ledger_cross_epoch_reconciliation(tmp_path):
    def scenario(tr, led_mod, _):
        d = str(tmp_path / tr.__name__.split(".")[0])
        led = led_mod.RequestLedger(d)
        _accept(led, "a", 1)
        _accept(led, "a", 3)
        _accept(led, "b", 2)
        led.append_reaccept("b", 4)
        led.append_reaccept("b", 2)
        _accept(led, "c", 5)
        led.append_resolve("c", epoch=2)
        out = led.outstanding()
        assert set(out) == {"a", "b"}
        assert out["a"]["epoch"] == 3
        assert out["b"]["epoch"] == 4
        assert led.cross_epoch_duplicates == 1
        assert led.cross_epoch_reaccepts == 1
        assert led.stale_tombstones == 1
        assert led.max_epoch() == 5
        led.close()
        led2 = led_mod.RequestLedger(d)
        out2 = led2.outstanding()
        assert set(out2) == {"a", "b"}
        assert out2["a"]["epoch"] == 3 and out2["b"]["epoch"] == 4
        assert led2.max_epoch() == 5
        led2.close()
        return sorted((k, v["epoch"]) for k, v in out2.items()), led2.max_epoch()

    _twin(scenario)


def test_ledger_stale_duplicate_accept_loses(tmp_path):
    def scenario(tr, led_mod, _):
        led = led_mod.RequestLedger(str(tmp_path / tr.__name__.split(".")[0]))
        _accept(led, "a", 4)
        _accept(led, "a", 2)
        out = led.outstanding()
        assert out["a"]["epoch"] == 4
        assert led.cross_epoch_duplicates == 1
        led.close()
        return out["a"]["epoch"], led.cross_epoch_duplicates

    _twin(scenario)


def test_each_package_reads_the_others_ledger(tmp_path):
    """A ledger file written by either package opens in the other with the
    same outstanding records (plain payloads: a blob names its package's
    classes, so only builtins cross)."""
    for writer, reader in ((ref_ledger, port_ledger), (port_ledger, ref_ledger)):
        d = tmp_path / writer.__name__.split(".")[0]
        ids = _mk_ledger(writer, d, n_accepts=4, resolve_first=2)
        opened = reader.RequestLedger(str(d))
        out = opened.outstanding()
        assert list(out) == ids[2:]
        assert reader.RequestLedger.load_work(out[ids[3]]) == ("data3", ("check3",), ())
        assert opened.latest_quarantine() == {"t9": 3}
        opened.close()


# -- without cloudpickle ---------------------------------------------------------------


def test_stdlib_pickle_fallback(monkeypatch, tmp_path):
    """With stdlib pickle forced as the blob pickler (cloudpickle is not
    everywhere): tables and analyzers travel, a check holding a lambda
    fails at submit with the same error in both packages, and a ledger
    fleet stopped without draining replays its required_analyzers
    submissions on a fresh fleet, exactly once and bit for bit."""
    import deequ_tpu_torch.analyzers as port_an
    from deequ_tpu import Check as RefCheck
    from deequ_tpu import CheckLevel as RefLevel
    from deequ_tpu_torch import Check, CheckLevel
    from deequ_tpu_torch.serve import VerificationFleet

    monkeypatch.setattr(ref_tr, "_blob_pickler", pickle)
    monkeypatch.setattr(port_tr, "_blob_pickler", pickle)
    table = port_table(_ref_table(48, 5))
    analyzers = [port_an.Size(), port_an.Mean("x")]
    back = port_tr.load_blob(port_tr.dump_blob((table, tuple(analyzers))))
    assert back[1] == tuple(analyzers)
    assert np.array_equal(back[0]["x"].values, table["x"].values)
    with pytest.raises((pickle.PicklingError, AttributeError)) as port_err:
        port_tr.dump_blob(Check(CheckLevel.ERROR, "c").has_size(lambda n: n > 0))
    with pytest.raises((pickle.PicklingError, AttributeError)) as ref_err:
        ref_tr.dump_blob(RefCheck(RefLevel.ERROR, "c").has_size(lambda n: n > 0))
    assert type(port_err.value) is type(ref_err.value)

    # a ledger fleet stopped without draining, its workers stalled: the
    # accepted requests stay unresolved, and a fresh fleet replays them
    from deequ_tpu_torch import VerificationSuite

    want = VerificationSuite.run(table, [], required_analyzers=analyzers)
    d = str(tmp_path / "ledger")
    fleet = VerificationFleet(n_workers=2, monitor=False, distinct_devices=False,
                              ledger_dir=d, worker_knobs={"coalesce_window": 0.0})
    try:
        with pytest.raises((pickle.PicklingError, AttributeError)):
            fleet.submit(table, [Check(CheckLevel.ERROR, "c").has_size(lambda n: n > 0)],
                         tenant="closure")
        fleet.flush()
        for wid in range(2):
            fleet.stall_worker(wid, 30.0)
        time.sleep(0.2)
        futures = [fleet.submit(table, required_analyzers=analyzers, tenant=f"p{k}")
                   for k in range(4)]
    finally:
        t0 = time.monotonic()
        leftovers = fleet.stop(drain=False)
    assert time.monotonic() - t0 < 10.0  # the stop ends the stalls
    assert set(leftovers) == set(futures) and not any(f.done() for f in futures)
    second = VerificationFleet(n_workers=2, monitor=False, distinct_devices=False,
                               ledger_dir=d, resume_futures={f.accept_id: f for f in futures})
    try:
        results = [f.result(timeout=60) for f in futures]
    finally:
        second.stop()
    assert len(second.resumed) == 4
    for f, result in zip(futures, results):
        assert f.resolve_count == 1
        for a, m in want.metrics.items():
            assert _bits(result.metrics[a].value.get()) == _bits(m.value.get())


# -- the in-process fleet's ledger -----------------------------------------------------


def _bits(value):
    return struct.pack("<d", value) if isinstance(value, float) else value


def _replay_scenario(side, tmp_path):
    """Stall every worker, accept 12 requests with the ledger on, and let
    the fleet die before any resolves; a fresh fleet on the same directory
    replays them onto the original futures. Returns (record, {tenant:
    result})."""
    if side == "ref":
        import deequ_tpu.analyzers as an
        from deequ_tpu import VerificationSuite
        from deequ_tpu.obs.registry import REGISTRY
        from deequ_tpu.parallel.mesh import use_mesh
        from deequ_tpu.serve import VerificationFleet
    else:
        import deequ_tpu_torch.analyzers as an
        from deequ_tpu_torch import VerificationSuite
        from deequ_tpu_torch.obs.registry import REGISTRY
        from deequ_tpu_torch.parallel.mesh import use_mesh
        from deequ_tpu_torch.serve import VerificationFleet

    def analyzers():
        return [an.Size(), an.Completeness("x"), an.Mean("x"), an.Sum("i")]

    tables = {}
    for k in range(12):
        ref = _ref_table(48 + 16 * (k % 4), 600 + k)
        tables[f"r{k}"] = ref if side == "ref" else port_table(ref)
    with use_mesh(None):
        serial = {t: VerificationSuite.run(tbl, [], required_analyzers=analyzers())
                  for t, tbl in tables.items()}
    d = str(tmp_path / f"ledger-{side}")
    appends = REGISTRY.snapshot()["instruments"]["fleet_ledger_appends"]
    first = VerificationFleet(n_workers=3, monitor=False, distinct_devices=False, ledger_dir=d,
                              worker_knobs={"coalesce_window": 0.0})
    for wid in range(3):
        first.stall_worker(wid, 5.0)
    time.sleep(0.2)  # every idle worker takes its stall
    futures = {t: first.submit(tbl, required_analyzers=analyzers(), tenant=t)
               for t, tbl in tables.items()}
    # the first fleet dies: its workers halt unjoined (a stalled thread
    # wakes to an empty queue) and its ledger closes, no tombstone written
    for worker in first._workers.values():
        worker.service.stop(drain=False, join=False)
    first._ledger.close()
    assert not any(f.done() for f in futures.values())
    accept_ids = {t: f.accept_id for t, f in futures.items()}
    after_accepts = REGISTRY.snapshot()["instruments"]["fleet_ledger_appends"] - appends

    second = VerificationFleet(n_workers=3, monitor=False, distinct_devices=False,
                               ledger_dir=d, worker_knobs={"coalesce_window": 0.0},
                               resume_futures={accept_ids[t]: f for t, f in futures.items()})
    try:
        assert set(second.resumed) == set(accept_ids.values())
        assert all(second.resumed[accept_ids[t]] is f for t, f in futures.items())
        results = {t: f.result(timeout=120) for t, f in futures.items()}
        for t, f in futures.items():
            assert f.resolve_count == 1 and f.late_resolutions == 0, t
            for a, m in serial[t].metrics.items():
                assert _bits(results[t].metrics[a].value.get()) == _bits(m.value.get()), (t, a)
        second.flush()
    finally:
        second.stop()
    third = ref_ledger if side == "ref" else port_ledger
    reopened = third.RequestLedger(d)
    outstanding = reopened.outstanding()
    reopened.close()
    return ((len(second.resumed), after_accepts, len(outstanding),
             sorted(tables), sorted(tables) == sorted(futures)), results)


def test_fleet_ledger_replay_matches_the_reference(tmp_path):
    want, ref_results = _replay_scenario("ref", tmp_path)
    got, port_results = _replay_scenario("port", tmp_path)
    assert got == want
    assert got[:3] == (12, 12, 0)
    for t, ref_res in ref_results.items():
        port_res = port_results[t]
        ref_metrics = sorted(ref_res.metrics.items(), key=lambda kv: repr(kv[0]))
        port_metrics = sorted(port_res.metrics.items(), key=lambda kv: repr(kv[0]))
        for (_, m1), (_, m2) in zip(ref_metrics, port_metrics):
            assert_metric_parity(m1, m2)
