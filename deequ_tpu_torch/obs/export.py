"""Chrome-trace / Perfetto JSON export of a flight recording (the
counterpart of ``deequ_tpu/obs/export.py``).

:func:`to_chrome_trace` renders a :class:`FlightRecorder`'s records in the
Chrome Trace Event Format, which Perfetto's importer and
``chrome://tracing`` both load:

- one track a thread (a ``tid`` for each distinct ``SpanRecord.track``;
  the serving layer's per-tenant submit->resolve spans are tracks of their
  own);
- spans as complete events (``ph="X"``, ``ts``/``dur`` in microseconds),
  nested within a track by time, which each thread's span stack
  guarantees;
- instant events (rungs, budget charges) as ``ph="i"``, thread-scoped;
- spans still open at export (a killed service, a crashed run) close at
  the recording's last timestamp and carry ``"truncated": true``: a
  truncated trace is well-formed and says so.

Timestamps are monotonic seconds rebased to the earliest record.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from deequ_tpu_torch.obs.recorder import FlightRecorder, SpanRecord

#: the one process id every track hangs off
_PID = 1


def _collect(recorder: FlightRecorder) -> List[SpanRecord]:
    """The closed records, plus copies of the open spans closed at the
    recording's end and marked truncated (the live records stay open)."""
    records = recorder.records()
    open_spans = recorder.open_spans()
    if not open_spans:
        return records
    t_last = max(
        [r.t_end for r in records if r.t_end is not None]
        + [r.t_start for r in records] + [s.t_start for s in open_spans],
        default=0.0,
    )
    for s in open_spans:
        records.append(SpanRecord(
            name=s.name, kind=s.kind, t_start=s.t_start, t_end=max(t_last, s.t_start),
            track=s.track, span_id=s.span_id, parent_id=s.parent_id,
            args=dict(s.args), truncated=True,
        ))
    return records


def to_chrome_trace(recorder: FlightRecorder) -> Dict[str, Any]:
    """The recording as a Chrome-trace dict (``json.dump`` it, or use
    :func:`write_chrome_trace`)."""
    records = _collect(recorder)
    t0 = min((r.t_start for r in records), default=0.0)
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for r in records:
        tid = tids.get(r.track)
        if tid is None:
            tid = tids[r.track] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                           "args": {"name": r.track}})
        args = dict(r.args)
        if r.parent_id is not None:
            args["parent_span"] = r.parent_id
        if r.truncated:
            args["truncated"] = True
        event = {"name": r.name, "cat": "deequ_tpu_torch", "pid": _PID, "tid": tid,
                 "ts": round((r.t_start - t0) * 1e6, 3), "id": r.span_id, "args": args}
        if r.kind == "span":
            event["ph"] = "X"
            event["dur"] = round(max((r.t_end or r.t_start) - r.t_start, 0.0) * 1e6, 3)
        else:
            event["ph"] = "i"
            event["s"] = "t"
        events.append(event)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "deequ_tpu_torch.obs", "dropped_records": recorder.dropped},
    }


def write_chrome_trace(recorder: FlightRecorder, path: str) -> str:
    """Write the recording to ``path`` as Perfetto-loadable JSON; returns
    the path."""
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_chrome_trace(recorder), fh)
    return path
