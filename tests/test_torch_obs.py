"""The port's flight recorder and metrics registry (deequ_tpu_torch/obs) on
the CPU: twins of tests/test_obs.py, each held against the reference.

Every test drives the reference (``deequ_tpu``, one device,
``use_mesh(None)``) and the port (the CPU) through the same calls on the
same seeded tables, asserts the reference test's properties on both, and
asserts that the two record the same thing: the same records with the
same parents and arguments, the same ring bound and drop count, the same
span tree of a scan (the reference's ``trace`` span, its XLA program
trace, has no counterpart: the port builds no program), the same
instrument snapshots and the same serving spans. The Perfetto export is
held field for field: the port's recording, copied into a reference
recorder, exports through both packages' ``to_chrome_trace`` to the same
events.

- Recorder semantics: nesting and parenting, the ring bound and its drop
  count, the thread-local scope, and the seams — every device boundary a
  span inside its ``scan_attempt``, an ``oom_bisect`` rung an event inside
  the attempt it degraded, budget charges as events, a disarmed run that
  records nothing and writes no instrument, ``trace=False`` suppressing a
  global recorder, ``trace=True`` leaking nothing, ``DEEQU_TORCH_TRACE``
  arming one (a malformed value raising typed).
- The verification surface: ``with_tracing()``'s summary on the result,
  and the summary's phases against ``ScanStats``'s dispatch and drain
  seconds.
- The Perfetto export: valid, well-nested JSON, a truncated recording
  included.
- The registry: histogram quantiles, bounded label cardinality,
  ``execution_report()`` as the unified snapshot read through (not a
  copy), and its sections beside the reference's.
- The serving layer: the latency histograms against the futures, a traced
  coalesced batch (one execute and one fetch span under K tenant spans),
  and a killed service's truncated trace completed by a resumed one.

The reference's three ``span_in_jit`` repo-lint tests and its repo-lint
gate wait for the port's lint (its tooling slice)."""

import collections
import contextlib
import dataclasses
import importlib
import json
import threading

import numpy as np
import pytest
import torch

from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu_torch import use_device
from deequ_tpu_torch.obs import FlightRecorder
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from torch_parity import port_table, ref_column

pytestmark = [pytest.mark.torch_port, pytest.mark.obs]

#: span names only the reference records: its XLA program trace
REF_ONLY = {"trace"}


@pytest.fixture(autouse=True)
def _cpu():
    from deequ_tpu_torch.parallel.mesh import use_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_device("cpu"), use_mesh(None):
        yield
    torch.set_num_threads(threads)


class _Side:
    """One package's observability surface (the two share module paths)
    and its tables from a seed."""

    def __init__(self, pkg):
        def mod(path=""):
            return importlib.import_module(pkg + path)

        self.name = "ref" if pkg == "deequ_tpu" else "port"
        self.pkg, self.obs, self.recorder = mod(), mod(".obs"), mod(".obs.recorder")
        self.registry, self.export = mod(".obs.registry"), mod(".obs.export")
        self.an, self.runner = mod(".analyzers"), mod(".analyzers.runner").AnalysisRunner
        self.engine = mod(".ops.scan_engine")
        self.stats = self.engine.SCAN_STATS
        self.policy, self.faults = mod(".ops.device_policy"), mod(".resilience.faults")
        self.gov, self.envcfg = mod(".resilience.governance"), mod(".envcfg")
        self.exc = mod(".exceptions")
        self.suite, self.serve = mod(".verification").VerificationSuite, mod(".serve")
        self.prefix = "DEEQU_TPU_" if self.name == "ref" else "DEEQU_TORCH_"
        if self.name == "ref":
            self.scope = lambda: mod(".parallel.mesh").use_mesh(None)
        else:
            self.scope = contextlib.nullcontext

    def table(self, n=4096, cols=2, seed=7):
        rng = np.random.default_rng(seed)
        ref = RefTable([
            ref_column(f"c{i}", "fractional", rng.normal(100.0 + i, 5.0, n),
                       rng.random(n) > 0.05)
            for i in range(cols)
        ])
        return ref if self.name == "ref" else port_table(ref)

    def tenant_table(self, seed, n=64):
        r = np.random.default_rng(seed)
        ref = RefTable([ref_column("x", "fractional", r.normal(0, 1, n), np.ones(n, bool))])
        return ref if self.name == "ref" else port_table(ref)

    def tenant_check(self, n=64):
        return (self.pkg.Check(self.pkg.CheckLevel.ERROR, "s").has_size(lambda k: k == n)
                .has_completeness("x", lambda c: c == 1.0))

    def analyzers(self, cols=2):
        out = [self.an.Size()]
        for i in range(cols):
            out += [self.an.Completeness(f"c{i}"), self.an.Mean(f"c{i}"),
                    self.an.Minimum(f"c{i}"), self.an.Maximum(f"c{i}")]
        return out

    def oom_once(self):
        self.policy.install_scan_fault_hook(
            self.faults.FaultInjectingScanHook(faults={0: ("oom", 1)}, relative=True))

    def run_scan(self, table, ops, trace):
        if self.name == "ref":
            return self.engine.run_scan(table, ops, trace=trace)
        return self.engine.run_scan(table, ops, "cpu", trace=trace)


REF, PORT = _Side("deequ_tpu"), _Side("deequ_tpu_torch")


def _twin(scenario):
    """``scenario(side)`` on the reference and on the port: the two traces
    must be equal. Returns the port's."""
    with REF.scope():
        want = scenario(REF)
    got = scenario(PORT)
    assert got == want, f"port {got!r}\nreference {want!r}"
    return got


def _spans(rec, name=None):
    return [r for r in rec.records() if r.kind == "span" and (name is None or r.name == name)]


def _events(rec, name=None):
    return [r for r in rec.records() if r.kind == "instant" and (name is None or r.name == name)]


def _tree(rec):
    """A recording as the sorted multiset of (kind, name, parent's name),
    without the reference's program trace."""
    by_id = {r.span_id: r for r in rec.records()}
    return sorted(
        collections.Counter(
            (r.kind, r.name, by_id[r.parent_id].name if r.parent_id in by_id else None)
            for r in rec.records() if r.name not in REF_ONLY
        ).items()
    )


def _ref_copy(rec):
    """The port's recording as a reference ``FlightRecorder`` holding the
    same records, open spans and drop count."""
    copy = REF.obs.FlightRecorder(capacity=rec.capacity)
    ref_record = REF.recorder.SpanRecord
    for r in rec.records():
        copy._ring.append(ref_record(**dataclasses.asdict(r)))
    for r in rec.open_spans():
        copy._open[r.span_id] = ref_record(**dataclasses.asdict(r))
    copy.dropped = rec.dropped
    return copy


def _assert_exports_agree(rec):
    """The port's recording exports through the port's ``to_chrome_trace``
    to the events the reference's gives the same records: every field but
    the category and the producer, which name the package."""
    port = json.loads(json.dumps(PORT.obs.to_chrome_trace(rec)))
    ref = json.loads(json.dumps(REF.obs.to_chrome_trace(_ref_copy(rec))))
    for trace in (port, ref):
        for e in trace["traceEvents"]:
            e.pop("cat", None)
        trace["otherData"].pop("producer")
    assert port == ref
    return port


# -- recorder semantics --------------------------------------------------------


def test_span_nesting_and_parenting():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        with rec.span("outer", a=1):
            with rec.span("inner"):
                rec.event("ping", x=2)
        records = {r.name: r for r in rec.records()}
        assert records["inner"].parent_id == records["outer"].span_id
        assert records["ping"].parent_id == records["inner"].span_id
        assert records["outer"].parent_id is None
        assert records["outer"].t_end >= records["inner"].t_end
        assert records["ping"].args == {"x": 2}
        return _tree(rec), [(r.name, r.kind, r.args, r.track, r.truncated)
                            for r in rec.records()]

    tree, records = _twin(scenario)
    assert records[0][0] == "ping"  # completion order
    assert records[0][3] == threading.current_thread().name


def test_ring_buffer_bounded_with_drop_count():
    def scenario(s):
        rec = s.obs.FlightRecorder(capacity=8)
        for i in range(30):
            rec.event("e", i=i)
        return len(rec), rec.dropped, [r.args["i"] for r in rec.records()]

    assert _twin(scenario) == (8, 22, list(range(22, 30)))


def test_recording_scope_is_thread_local_and_restores():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        seen = [s.obs.current_recorder() is None]
        with s.obs.recording_scope(rec):
            seen.append(s.obs.current_recorder() is rec)
            other = []
            worker = threading.Thread(target=lambda: other.append(s.obs.current_recorder()))
            worker.start()
            worker.join()
            seen.append(other == [None])  # another thread must not see this scope
            with s.obs.recording_scope(None):  # a suppression wins over the outer scope
                seen.append(s.obs.current_recorder() is None)
            seen.append(s.obs.current_recorder() is rec)
        seen.append(s.obs.current_recorder() is None)
        return seen

    assert _twin(scenario) == [True] * 6


def test_scan_spans_nest_under_attempt():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        with s.obs.recording_scope(rec):
            ctx = s.runner.do_analysis_run(s.table(), s.analyzers())
        assert all(m.value.is_success for m in ctx.all_metrics())
        attempts = _spans(rec, "scan_attempt")
        assert len(attempts) == 1
        seams = [r for r in _spans(rec) if r.name in ("transfer", "execute", "fetch")]
        by_id = {r.span_id: r for r in rec.records()}
        for r in seams:
            cur = r
            while cur.parent_id is not None and cur.parent_id in by_id:
                cur = by_id[cur.parent_id]
            assert cur.span_id == attempts[0].span_id, (r.name, r.args)
        return _tree(rec), attempts[0].args.get("attempt")

    tree, attempt = _twin(scenario)
    assert {name for (_, name, _), _ in tree} == {"scan_attempt", "transfer", "execute", "fetch"}
    assert attempt == 0


def test_oom_bisect_rung_event_lands_under_its_attempt_span():
    """Attempt 0 faults, its ``oom_bisect`` event records inside attempt
    0's span, and the retry opens attempt 1."""
    def scenario(s):
        rec = s.obs.FlightRecorder()
        with s.gov.fault_state_scope():
            s.oom_once()
            with s.obs.recording_scope(rec):
                ctx = s.runner.do_analysis_run(s.table(n=8192), s.analyzers())
        assert all(m.value.is_success for m in ctx.all_metrics())
        attempts = sorted(_spans(rec, "scan_attempt"), key=lambda r: r.args["attempt"])
        assert len(attempts) >= 2
        rungs = _events(rec, "oom_bisect")
        assert len(rungs) == 1
        assert rungs[0].parent_id == attempts[0].span_id
        assert rungs[0].args["chunk_to"] < rungs[0].args["chunk_from"]
        return ([r.args["attempt"] for r in attempts], sorted(rungs[0].args),
                [r.name for r in rec.records() if r.kind == "instant"])

    attempts, rung_args, instants = _twin(scenario)
    assert attempts[0] == 0
    assert {"chunk_from", "chunk_to"} <= set(rung_args)
    assert "oom_bisect" in instants


def test_budget_charge_events_on_recording():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        with s.gov.fault_state_scope():
            s.oom_once()
            budget = s.gov.RunPolicy(max_total_attempts=16).arm()
            with s.obs.recording_scope(rec), s.gov.run_budget_scope(budget):
                s.runner.do_analysis_run(s.table(n=8192), s.analyzers())
        charges = _events(rec, "budget_charge")
        return len(charges), budget.attempts, [c.args["charge_kind"] for c in charges]

    assert _twin(scenario) == (1, 1, ["oom_bisect"])


def test_disarmed_run_records_nothing_and_writes_no_instruments():
    def scenario(s):
        assert s.obs.current_recorder() is None
        serve_before = s.registry.REGISTRY.snapshot()["serve"]
        ctx = s.runner.do_analysis_run(s.table(), s.analyzers())
        assert all(m.value.is_success for m in ctx.all_metrics())
        serve_after = s.registry.REGISTRY.snapshot()["serve"]
        # structurally disarmed: the armed count stays 0 (every seam's
        # disarmed path reads only it) and no global recorder appeared
        return (s.recorder._armed, s.recorder.global_recorder(),
                serve_after["submitted"] - serve_before["submitted"],
                serve_after["latency"]["count"] - serve_before["latency"]["count"])

    assert _twin(scenario) == (0, None, 0, 0)


def test_trace_false_suppresses_env_armed_global():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        prev = s.obs.install_global_recorder(rec)
        try:
            s.suite.do_verification_run(s.table(), [], s.analyzers(), trace=False)
            suppressed = len(rec)
            s.suite.do_verification_run(s.table(), [], s.analyzers())
            return suppressed, len(rec) > 0, _tree(rec)
        finally:
            s.obs.install_global_recorder(prev)

    suppressed, picked_up, _ = _twin(scenario)
    assert suppressed == 0, "trace=False must suppress the global recorder"
    assert picked_up, "the global recorder was not picked up"


def test_trace_true_does_not_leak_process_wide():
    def scenario(s):
        seen = [s.recorder.global_recorder() is None and s.obs.current_recorder() is None]
        result = s.suite.do_verification_run(s.table(), [], s.analyzers(), trace=True)
        seen += [result.trace_recorder is not None, result.run_trace["spans"] > 0,
                 s.recorder.global_recorder() is None and s.obs.current_recorder() is None]
        n = len(result.trace_recorder)
        s.suite.do_verification_run(s.table(), [], s.analyzers())
        seen.append(len(result.trace_recorder) == n)
        return seen, sorted(set(result.run_trace) - {"wall_seconds"})

    seen, keys = _twin(scenario)
    assert seen == [True] * 5
    assert "phases" in keys and "spans" in keys


def test_env_var_arms_global_recorder(monkeypatch):
    def scenario(s):
        prev = s.obs.install_global_recorder(None)
        try:
            monkeypatch.setenv(s.prefix + "TRACE", "1")
            monkeypatch.setenv(s.prefix + "TRACE_CAPACITY", "128")
            rec = s.recorder.maybe_arm_from_env()
            armed = rec is not None and s.recorder.global_recorder() is rec
            ctx = s.runner.do_analysis_run(s.table(), s.analyzers())
            return (armed, rec.capacity, all(m.value.is_success for m in ctx.all_metrics()),
                    len(rec) > 0, _tree(rec))
        finally:
            s.obs.install_global_recorder(prev)

    armed, capacity, ok, recorded, _ = _twin(scenario)
    assert (armed, capacity, ok, recorded) == (True, 128, True, True)


def test_env_var_trace_garbage_raises_typed(monkeypatch):
    def scenario(s):
        out = []
        for name, value in (("TRACE", "yes"), ("TRACE_CAPACITY", "-5")):
            monkeypatch.setenv(s.prefix + name, value)
            with pytest.raises(s.exc.EnvConfigError) as e:
                s.envcfg.env_value(s.prefix + name)
            out.append((type(e.value).__name__, s.prefix + name in str(e.value),
                        str(e.value).replace(s.prefix, "")))
        return out

    got = _twin(scenario)
    assert [(name, named) for name, named, _ in got] == [("EnvConfigError", True)] * 2


# -- the verification surface --------------------------------------------------


def test_with_tracing_summary_on_result():
    def scenario(s):
        result = (s.suite.on_data(s.table())
                  .add_check(s.pkg.Check(s.pkg.CheckLevel.ERROR, "t")
                             .has_size(lambda n: n == 4096))
                  .with_tracing()
                  .run())
        plain = s.suite.run(s.table(), [])
        with pytest.raises(ValueError, match="not both"):
            s.suite.on_data(s.table()).with_tracing(s.obs.FlightRecorder(), capacity=8)
        return (str(result.status).split(".")[-1], result.trace_recorder is not None,
                result.run_trace["spans"] > 0,
                sorted(set(result.run_trace["phases"]) - REF_ONLY),
                plain.run_trace, plain.trace_recorder)

    status, armed, spans, phases, plain_trace, plain_recorder = _twin(scenario)
    assert status == "SUCCESS" and armed and spans
    assert "verification_run" in phases and "scan_attempt" in phases
    assert plain_trace == {} and plain_recorder is None


def test_run_trace_reconciles_with_scan_stats():
    """The phases' walls against the ScanStats wall counters: the attempt
    span holds the execute and fetch walls, and the boundary spans cover
    the seconds dispatch_seconds and drain_wait_seconds count (slack for
    the host lines between the two clocks)."""
    def scenario(s):
        before = (s.stats.dispatch_seconds, s.stats.drain_wait_seconds)
        result = s.suite.do_verification_run(
            s.table(n=50_000), [], s.analyzers(), trace=s.obs.FlightRecorder())
        dispatch = s.stats.dispatch_seconds - before[0]
        drain = s.stats.drain_wait_seconds - before[1]
        assert dispatch > 0 and drain > 0
        if s is PORT:  # the port also reports the run's walls on its result
            assert result.scan_stats["dispatch_seconds"] == dispatch
            assert result.scan_stats["drain_wait_seconds"] == drain
        phases = result.run_trace["phases"]
        slack = 0.25
        attempt_wall = phases["scan_attempt"]["wall_seconds"]
        assert attempt_wall + slack >= dispatch + drain
        boundary = sum(phases.get(name, {"wall_seconds": 0.0})["wall_seconds"]
                       for name in ("transfer", "trace", "execute", "fetch"))
        assert boundary >= dispatch + drain - slack
        assert boundary <= attempt_wall + slack
        assert phases["verification_run"]["wall_seconds"] + slack >= attempt_wall
        return sorted(set(phases) - REF_ONLY), sorted(phases["scan_attempt"])

    phases, fields = _twin(scenario)
    assert {"verification_run", "scan_attempt", "execute", "fetch"} <= set(phases)
    assert "wall_seconds" in fields


# -- the export ----------------------------------------------------------------


def _assert_tracks_well_formed(trace: dict) -> None:
    """Spans of one track never overlap partly: sorted by start, each pair
    is disjoint or nested."""
    by_tid = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    for tid, events in by_tid.items():
        events.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in events:
            start, end = e["ts"], e["ts"] + e["dur"]
            while stack and start >= stack[-1] - 1e-6:
                stack.pop()
            if stack:
                assert end <= stack[-1] + 1e-6, f"partly overlapping spans on track {tid}: {e}"
            stack.append(end)


def test_perfetto_export_is_valid_and_well_formed():
    recordings = {}

    def scenario(s):
        rec = recordings[s.name] = s.obs.FlightRecorder()
        with s.gov.fault_state_scope():
            s.oom_once()
            with s.obs.recording_scope(rec):
                s.runner.do_analysis_run(s.table(n=8192), s.analyzers())
        trace = json.loads(json.dumps(s.obs.to_chrome_trace(rec)))
        assert trace["traceEvents"]
        for e in trace["traceEvents"]:
            assert "pid" in e and "tid" in e and "name" in e
            if e["ph"] == "X":
                assert e["ts"] >= 0 and e["dur"] >= 0
        _assert_tracks_well_formed(trace)
        named = {e["tid"] for e in trace["traceEvents"] if e["ph"] == "M"}
        assert {e["tid"] for e in trace["traceEvents"] if e["ph"] != "M"} <= named
        # the names, not their counts: the reference's bisection executes
        # its halves as programs of their own
        return sorted({(e["ph"], e["name"]) for e in trace["traceEvents"]
                       if e["name"] not in REF_ONLY})

    events = _twin(scenario)
    assert {"X", "M", "i"} <= {ph for ph, _ in events}
    exported = _assert_exports_agree(recordings["port"])
    assert exported["otherData"]["dropped_records"] == 0


def test_truncated_trace_is_well_formed():
    recordings = {}

    def scenario(s):
        rec = recordings[s.name] = s.obs.FlightRecorder()
        with s.obs.recording_scope(rec):
            span = rec.span("outer_work", phase="doomed")
            span.__enter__()
            rec.event("mid", ok=True)
            with rec.span("finished_child"):
                pass
        open_before = len(rec.open_spans())
        trace = json.loads(json.dumps(s.obs.to_chrome_trace(rec)))
        _assert_tracks_well_formed(trace)
        truncated = [(e["name"], e["args"]) for e in trace["traceEvents"]
                     if e["ph"] == "X" and e["args"].get("truncated")]
        return open_before, truncated, len(rec.open_spans())  # the export copies

    assert _twin(scenario) == (1, [("outer_work", {"phase": "doomed", "truncated": True})], 1)
    _assert_exports_agree(recordings["port"])


# -- the registry ----------------------------------------------------------------


def test_histogram_quantiles_and_bounds():
    def scenario(s):
        h = s.registry.Histogram("h", buckets=(0.001, 0.01, 0.1, 1.0))
        for v in (0.0005, 0.005, 0.005, 0.05, 0.5, 2.0):
            h.observe(v)
        with pytest.raises(ValueError, match="sorted"):
            s.registry.Histogram("bad", buckets=(1.0, 0.1))
        return h.snapshot()

    snap = _twin(scenario)
    assert snap["count"] == 6
    assert snap["min"] == 0.0005 and snap["max"] == 2.0
    assert snap["p50"] == 0.01
    assert snap["p99"] == 2.0
    assert abs(snap["sum"] - 2.5605) < 1e-9


def test_histogram_family_bounds_label_cardinality():
    def scenario(s):
        fam = s.registry.HistogramFamily("f", max_labels=4, buckets=(0.1, 1.0))
        for i in range(10):
            fam.observe(f"tenant-{i}", 0.05 * (i + 1))
        return fam.labels(), fam.evicted_labels, fam.snapshot()

    labels, evicted, snap = _twin(scenario)
    assert len(labels) == 4 and evicted == 6
    assert snap["_all"]["count"] == 10


def _line_names(text, prefix):
    """The metric names a text report renders, without its prefix; a
    histogram's quantile lines render only once it has a sample, so they
    are left out (the process's earlier tests decide that)."""
    return sorted({line.split()[0].split("{")[0].replace(prefix, "", 1)
                   for line in text.splitlines()
                   if line and not line.startswith("#") and "{quantile=" not in line})


def test_execution_report_is_unified_registry_snapshot():
    def scenario(s):
        report = s.pkg.execution_report()
        for section in ("scan", "retry", "hbm", "serve", "env", "kernels", "planner",
                        "repository", "instruments"):
            assert section in report, section
        legacy = s.pkg.scan_execution_report()
        assert set(report["scan"]) == set(legacy)
        assert report["scan"]["scan_passes"] == legacy["scan_passes"]
        assert s.prefix + "TRACE" in report["env"]
        names = _line_names(s.pkg.execution_report_text(), s.pkg.__name__ + "_")
        return [n for n in names if n.startswith(("serve_", "planner_", "kernels_", "hbm_"))]

    names = _twin(scenario)
    assert "serve_latency_seconds_count" in names
    text = PORT.pkg.execution_report_text()
    assert "deequ_tpu_torch_scan_scan_passes" in text


def test_registry_reads_through_not_forked():
    def scenario(s):
        before = s.registry.REGISTRY.snapshot()["scan"]["rows_scanned"]
        s.stats.rows_scanned += 1234
        return s.registry.REGISTRY.snapshot()["scan"]["rows_scanned"] - before

    assert _twin(scenario) == 1234


def test_registry_sections_match_the_reference():
    """The port's registry has the reference's sections but those of the
    slices still to come (control, windows, the fleets), and the serve
    section and the instruments carry the reference's keys."""
    import deequ_tpu
    import deequ_tpu_torch

    ref = deequ_tpu.execution_report()
    port = deequ_tpu_torch.execution_report()
    later = {"control", "windows", "fleet", "pfleet"}
    assert set(port) == set(ref) - later
    assert set(port["serve"]) == set(ref["serve"])
    assert set(port["kernels"]) == set(ref["kernels"])
    assert set(port["planner"]) == set(ref["planner"])
    assert set(port["hbm"]) == set(ref["hbm"])
    ref_serve = {k for k in ref["instruments"] if k.startswith("serve_")}
    assert {k for k in port["instruments"] if k.startswith("serve_")} == ref_serve


def test_reset_execution_report_zeroes_counters_and_instruments():
    def scenario(s):
        s.stats.rows_scanned += 5
        s.registry.SERVE_SUBMITTED.inc()
        s.pkg.reset_execution_report()
        report = s.pkg.execution_report()
        return report["scan"]["rows_scanned"], report["serve"]["submitted"]

    assert _twin(scenario) == (0, 0)


# -- the serving layer -----------------------------------------------------------


def test_serve_latency_histograms_match_futures():
    def scenario(s):
        latency = s.registry.SERVE_LATENCY
        latency.reset()
        with s.serve.VerificationService(max_batch=8, coalesce_window=0.005) as svc:
            futures = {f"t{i}": svc.submit(s.tenant_table(i), [s.tenant_check()],
                                           tenant=f"t{i}")
                       for i in range(5)}
            results = {t: f.result(timeout=60) for t, f in futures.items()}
        snap = latency.snapshot()
        assert abs(snap["_all"]["sum"] - sum(f.latency_seconds for f in futures.values())) < 1e-6
        for tenant, fut in futures.items():
            h = latency.label(tenant)
            assert h is not None and h.count == 1
            assert h.min <= fut.latency_seconds <= (h.max or np.inf)
        assert snap["_all"]["p50"] >= min(f.latency_seconds for f in futures.values())
        return (sorted(str(r.status).split(".")[-1] for r in results.values()),
                snap["_all"]["count"], sorted(latency.labels()))

    statuses, count, labels = _twin(scenario)
    assert statuses == ["SUCCESS"] * 5 and count == 5
    assert labels == [f"t{i}" for i in range(5)]


def _coalesced(rec, name):
    return [r for r in _spans(rec, name) if "coalesced" in r.args.get("what", "")]


def test_traced_coalesced_serve_exports_tenant_spans(tmp_path):
    """One coalesced batch: K tenant submit->resolve spans around ONE
    execute and ONE fetch span, an assembly span, and a Perfetto file
    that loads."""
    K = 4

    def scenario(s):
        rec = s.obs.FlightRecorder()
        svc = s.serve.VerificationService(trace=rec, start=False, max_batch=K,
                                          coalesce_window=0.0)
        futures = [svc.submit(s.tenant_table(9), [s.tenant_check()], tenant=f"t{i}")
                   for i in range(K)]
        svc.start()
        try:
            statuses = [str(f.result(timeout=60).status).split(".")[-1] for f in futures]
        finally:
            svc.stop()
        tenant_spans = _spans(rec, "serve_request")
        exec_spans, fetch_spans = _coalesced(rec, "execute"), _coalesced(rec, "fetch")
        assert len(exec_spans) == 1 and len(fetch_spans) == 1
        for r in tenant_spans:
            assert r.t_start <= exec_spans[0].t_start
            assert r.t_end >= fetch_spans[0].t_end - 1e-6
        path = s.obs.write_chrome_trace(rec, str(tmp_path / f"{s.name}.json"))
        with open(path) as fh:
            _assert_tracks_well_formed(json.load(fh))
        return (statuses, sorted(r.track for r in tenant_spans),
                len(_spans(rec, "coalesce_assembly")), len(_events(rec, "serve_submit")),
                sorted(sorted(r.args) for r in tenant_spans))

    statuses, tracks, assemblies, submits, _ = _twin(scenario)
    assert statuses == ["SUCCESS"] * K
    assert tracks == [f"tenant/t{i}" for i in range(K)]
    assert assemblies == 1 and submits == K


def test_serve_kill_and_resume_trace_is_truncated_then_completes():
    def scenario(s):
        rec = s.obs.FlightRecorder()
        svc = s.serve.VerificationService(trace=rec, start=False, max_batch=4,
                                          coalesce_window=0.0)
        futures = [svc.submit(s.tenant_table(3), [s.tenant_check()], tenant=f"t{i}")
                   for i in range(3)]
        pending = svc.stop(drain=False)
        killed = (len(pending), any(f.done() for f in futures))
        trace = json.loads(json.dumps(s.obs.to_chrome_trace(rec)))
        _assert_tracks_well_formed(trace)
        before = (len(_events(rec, "serve_submit")), len(_spans(rec, "serve_request")))
        svc2 = s.serve.VerificationService(trace=rec, max_batch=4, coalesce_window=0.0)
        try:
            svc2.resume(pending)
            statuses = [str(f.result(timeout=60).status).split(".")[-1] for f in futures]
        finally:
            svc2.stop()
        return killed, before, statuses, len(_spans(rec, "serve_request"))

    assert _twin(scenario) == ((3, False), (3, 0), ["SUCCESS"] * 3, 3)


def test_traced_serve_spans_reconcile_with_scan_stats():
    """A traced load: the coalesced execute and fetch spans count the
    batches ScanStats counts, and every batch's assembly, execute and
    fetch spans lie on the worker's track under its recording."""
    def scenario(s):
        rec = s.obs.FlightRecorder()
        batches = s.stats.coalesced_batches
        svc = s.serve.VerificationService(trace=rec, start=False, max_batch=3,
                                          coalesce_window=0.0)
        futures = [svc.submit(s.tenant_table(i), [s.tenant_check()], tenant=f"t{i}")
                   for i in range(7)]
        svc.start()
        try:
            for f in futures:
                f.result(timeout=60)
        finally:
            svc.stop()
        counts = {}
        for name in ("coalesce_assembly", "execute", "fetch"):
            spans = (_spans(rec, name) if name == "coalesce_assembly"
                     else _coalesced(rec, name))
            assert len({r.track for r in spans}) == 1
            counts[name] = len(spans)
        return s.stats.coalesced_batches - batches, counts

    new, counts = _twin(scenario)
    assert new == 3  # 3 + 3 + 1
    assert counts == {"coalesce_assembly": 3, "execute": 3, "fetch": 3}
    # the port's coalesced transfer is a boundary of its own, one a batch
    rec = FlightRecorder()
    svc = PORT.serve.VerificationService(trace=rec, start=False, max_batch=3,
                                         coalesce_window=0.0)
    futures = [svc.submit(PORT.tenant_table(i), [PORT.tenant_check()], tenant=f"t{i}")
               for i in range(7)]
    svc.start()
    try:
        for f in futures:
            f.result(timeout=60)
    finally:
        svc.stop()
    transfers = _coalesced(rec, "transfer")
    assert len(transfers) == 3 and {r.track for r in transfers} == {"deequ-torch-serve"}


def test_run_scan_trace_argument_scopes_a_recorder():
    """``run_scan(trace=...)``: the recorder records this scan's attempt and
    boundaries and is scoped to the call; ``trace=False`` suppresses a
    global recorder for it."""
    def scenario(s):
        table = s.table()
        ops, _, _ = s.runner._build_scan_ops(table, s.analyzers())
        rec = s.obs.FlightRecorder()
        s.run_scan(table, ops, rec)
        scoped = s.obs.current_recorder() is None
        glob = s.obs.FlightRecorder()
        prev = s.obs.install_global_recorder(glob)
        try:
            s.run_scan(table, ops, False)
        finally:
            s.obs.install_global_recorder(prev)
        return _tree(rec), scoped, len(glob)

    tree, scoped, suppressed = _twin(scenario)
    assert {name for (_, name, _), _ in tree} >= {"scan_attempt", "transfer", "execute", "fetch"}
    assert scoped and suppressed == 0
    assert SCAN_STATS.scan_passes > 0
