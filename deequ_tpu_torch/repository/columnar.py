"""Columnar metrics repository (the port's copy of
``deequ_tpu/repository/columnar.py``; either package reads the segment
directory the other wrote).

The key-value repositories (``memory.py``, ``fs.py``) keep JSON documents;
the filesystem one rewrites the whole history a save. This backend keeps
the history as a columnar table the engine can scan:

- **append segments**: each ``save()`` appends one immutable segment
  (atomic and checksummed, ``resilience/atomic.py``) holding the result's
  scalar metric rows as planes: ``dataset_date`` as i64, the (analyzer,
  instance, metric name) identity and every tag value as int16 codes into
  per-segment dictionaries, the values as f64. A save costs O(rows of
  that result). A re-save of a key appends a superseding segment (last
  write wins, as the reference); ``compact()`` batches the live results
  into ``DEEQU_TORCH_REPO_SEGMENT_ROWS``-row segments and drops dead ones
  and, with ``DEEQU_TORCH_REPO_TTL`` set, results wholly older than the
  newest live dataset date minus the TTL.
- **loader bit-identity**: ``load()`` / ``load_by_key`` decode segments
  back into :class:`AnalysisResult`s through the same
  ``MetricsRepositoryMultipleResultsLoader``: scalars ride the exact f64
  plane, other metrics (Histogram, KLL, keyed) a per-result serde
  overflow, and each result's ``metric_map`` order is kept, so loader
  results equal :class:`~deequ_tpu_torch.repository.memory.
  InMemoryMetricsRepository`'s on the same saves bit for bit.
- **queries are scans**: :meth:`history_table` builds the live history as
  one ``ColumnarTable`` with ``dataset_date`` and ``value`` dictionary-
  encoded (cached until the next save), and ``repository/query.py`` runs a
  trend-window, tag-filtered or cross-tenant aggregate query over it as
  one fused scan on the card.

Torn appends: a crash mid-save leaves the previous complete segment set
(atomic rename) or a partial the checksum detects. A torn TAIL segment
raises :class:`CorruptStateException` on open (``on_torn_segment=
"recover"`` quarantines it and keeps every prior segment); damage before
a valid segment always raises.
"""

from __future__ import annotations

import functools
import json
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.analyzers.runner import AnalyzerContext
from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.metrics import DoubleMetric, Entity
from deequ_tpu_torch.repository import serde
from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.tryresult import Success

SEGMENT_MAGIC = b"DQMR"
SEGMENT_VERSION = 1
SEGMENT_SUFFIX = ".dqmr"
#: torn tail segments recovered past are renamed, not deleted — kept
#: for forensics, excluded from replay by the suffix filter
CORRUPT_SUFFIX = ".corrupt"

#: int16 code planes cap their per-segment dictionaries exactly like
#: ColumnChunk (data/table.py): identities or tag values past the cap
#: ride the serde overflow instead of a code plane
MAX_SEGMENT_DICT = (1 << 15) - 1

#: superseded (dead) results tolerated before a persisted repository
#: auto-compacts on the next save
AUTO_COMPACT_DEAD = 64

_u16 = struct.Struct("<H")
_i64 = struct.Struct("<q")


class _RepoStats:
    """Process-wide repository observables (saves, segments, compactions,
    queries), read like ScanStats."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.saves = 0
        self.segments_written = 0
        self.segment_rows_written = 0
        self.bytes_appended = 0
        self.compactions = 0
        self.dead_results_dropped = 0
        self.ttl_dropped = 0
        self.torn_segments_dropped = 0
        self.nonserializable_dropped = 0
        self.queries = 0
        self.query_scan_passes = 0
        self.query_rows_scanned = 0
        self.table_builds = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


REPO_STATS = _RepoStats()


def series_identity(analyzer, metric) -> Optional[str]:
    """The canonical identity label of one scalar metric series: the
    analyzer's serde JSON plus (entity, name, instance), serialized
    deterministically. None when the analyzer is not serializable (such
    metrics ride the overflow path or, like the reference serde, drop)."""
    return _identity(analyzer, metric.entity.value, metric.name, metric.instance)


@functools.lru_cache(maxsize=1 << 16)
def _identity(analyzer, entity: str, name: str, instance: str) -> Optional[str]:
    """:func:`series_identity`, memoised: a fleet's saves repeat the same
    few hundred series, and the label is a pure function of these four."""
    try:
        a_json = serde.analyzer_to_json(analyzer)
    except ValueError:
        return None
    return json.dumps(
        {"a": a_json, "e": entity, "m": name, "i": instance},
        sort_keys=True,
        separators=(",", ":"),
    )


@functools.lru_cache(maxsize=1 << 16)
def _identity_from_label(label: str) -> Tuple[Any, Entity, str, str]:
    """label -> (analyzer, entity, metric name, instance), memoised: every
    segment of a series repeats its label, and the analyzer is immutable,
    so one object serves every decoded row of the series."""
    meta = json.loads(label)
    analyzer = serde.analyzer_from_json(meta["a"])
    return analyzer, Entity(meta["e"]), meta["m"], meta["i"]


class _Segment:
    """One immutable append batch: N scalar metric rows as planes plus a
    JSON header carrying the result keys, per-segment dictionaries, and
    the non-scalar overflow. Decoded results are cached (segments never
    mutate)."""

    def __init__(
        self,
        header: Dict[str, Any],
        dates: np.ndarray,
        series: np.ndarray,
        values: np.ndarray,
        tag_codes: Dict[str, np.ndarray],
        seq: int = -1,
        file: Optional[str] = None,
    ):
        self.header = header
        self.dates = dates          # i64[N]
        self.series = series        # int16[N] -> header["series_dict"]
        self.values = values        # f64[N]
        self.tag_codes = tag_codes  # key -> int16[N] (-1 = absent)
        self.seq = seq
        self.file = file
        self._decoded: Optional[List[AnalysisResult]] = None

    @property
    def num_rows(self) -> int:
        return len(self.dates)

    @property
    def num_results(self) -> int:
        return len(self.header["results"])

    @property
    def nbytes(self) -> int:
        planes = (
            self.dates.nbytes + self.series.nbytes + self.values.nbytes
            + sum(c.nbytes for c in self.tag_codes.values())
        )
        return planes

    # -- encode ----------------------------------------------------------

    @staticmethod
    def encode(results: Sequence[AnalysisResult], seq: int = -1) -> "_Segment":
        """Batch one or more AnalysisResults into a segment. Scalar
        (successful DoubleMetric, float-valued) entries become plane
        rows; everything else serde-serializable rides the per-result
        overflow; non-serializable analyzers drop like the reference
        serde (counted). The per-result ``order`` string records the
        original metric_map interleaving so decode reconstructs the
        exact insertion order."""
        series_dict: List[str] = []
        series_index: Dict[str, int] = {}
        tag_dicts: Dict[str, List[str]] = {}
        tag_index: Dict[str, Dict[str, int]] = {}
        dates: List[int] = []
        series: List[int] = []
        values: List[float] = []
        tag_rows: Dict[str, List[int]] = {}
        header_results: List[Dict[str, Any]] = []

        for result in results:
            key = result.result_key
            row_start = len(dates)
            overflow: List[Dict[str, Any]] = []
            order: List[str] = []
            # this result's tag codes, resolved once (constant per row)
            row_tag_code: Dict[str, int] = {}
            for tk, tv in key.tags:
                idx_map = tag_index.setdefault(tk, {})
                code = idx_map.get(tv)
                if code is None and len(idx_map) < MAX_SEGMENT_DICT:
                    code = len(idx_map)
                    idx_map[tv] = code
                    tag_dicts.setdefault(tk, []).append(tv)
                row_tag_code[tk] = -1 if code is None else code
            date = int(key.data_set_date)
            for analyzer, metric in result.analyzer_context.metric_map.items():
                label = None
                if (
                    isinstance(metric, DoubleMetric)
                    and metric.value.is_success
                    and isinstance(metric.value.get(), float)
                ):
                    label = series_identity(analyzer, metric)
                if label is not None:
                    code = series_index.get(label)
                    if code is None and len(series_index) < MAX_SEGMENT_DICT:
                        code = len(series_index)
                        series_index[label] = code
                        series_dict.append(label)
                    if code is not None:
                        dates.append(date)
                        series.append(code)
                        values.append(metric.value.get())
                        order.append("r")
                        continue
                # non-scalar / dict-overflow metrics: serde JSON
                try:
                    entry = {
                        "analyzer": serde.analyzer_to_json(analyzer),
                        "metric": serde.metric_to_json(metric),
                    }
                except ValueError:
                    REPO_STATS.nonserializable_dropped += 1
                    continue
                overflow.append(entry)
                order.append("o")
            # the tag codes of this result's rows: one code a tag key, the
            # rows of earlier results backfilled with -1 where this result
            # brings a new key
            added = len(dates) - row_start
            if added:
                for tk in row_tag_code:
                    if tk not in tag_rows:
                        tag_rows[tk] = [-1] * row_start
                for tk, rows in tag_rows.items():
                    rows.extend([row_tag_code.get(tk, -1)] * added)
            header_results.append(
                {
                    "key": {
                        "dataSetDate": date,
                        "tags": key.tags_dict,
                    },
                    "row_start": row_start,
                    "row_stop": len(dates),
                    "overflow": overflow,
                    "order": "".join(order),
                }
            )

        n = len(dates)
        tag_keys = sorted(tag_rows)
        header = {
            "rows": n,
            "results": header_results,
            "series_dict": series_dict,
            "tag_keys": tag_keys,
            "tag_dicts": {k: tag_dicts.get(k, []) for k in tag_keys},
        }
        return _Segment(
            header,
            np.fromiter(dates, dtype=np.int64, count=n),
            np.fromiter(series, dtype=np.int16, count=n),
            np.fromiter(values, dtype=np.float64, count=n),
            {
                k: np.fromiter(tag_rows[k], dtype=np.int16, count=n)
                for k in tag_keys
            },
            seq=seq,
        )

    # -- binary round trip ----------------------------------------------

    def to_bytes(self) -> bytes:
        head = json.dumps(self.header, separators=(",", ":")).encode("utf-8")
        out = [
            SEGMENT_MAGIC,
            _u16.pack(SEGMENT_VERSION),
            _i64.pack(len(head)),
            head,
            self.dates.tobytes(),
            self.series.tobytes(),
            self.values.tobytes(),
        ]
        for k in self.header["tag_keys"]:
            out.append(self.tag_codes[k].tobytes())
        return b"".join(out)

    @staticmethod
    def from_bytes(payload: bytes, what: str, seq: int = -1) -> "_Segment":
        if payload[:4] != SEGMENT_MAGIC:
            raise CorruptStateException(what, "bad segment magic")
        (version,) = _u16.unpack_from(payload, 4)
        if version > SEGMENT_VERSION:
            raise CorruptStateException(
                what,
                f"segment version {version} newer than supported "
                f"{SEGMENT_VERSION}",
            )
        (head_len,) = _i64.unpack_from(payload, 6)
        off = 14
        try:
            header = json.loads(payload[off:off + head_len].decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise CorruptStateException(
                what, f"undecodable segment header: {e}"
            ) from e
        off += head_len
        n = int(header["rows"])

        def plane(dtype, itemsize):
            nonlocal off
            end = off + n * itemsize
            if end > len(payload):
                raise CorruptStateException(
                    what, "torn segment: plane bytes truncated"
                )
            arr = np.frombuffer(payload[off:end], dtype=dtype)
            off = end
            return arr

        dates = plane(np.int64, 8)
        series = plane(np.int16, 2)
        values = plane(np.float64, 8)
        tag_codes = {k: plane(np.int16, 2) for k in header["tag_keys"]}
        return _Segment(header, dates, series, values, tag_codes, seq=seq)

    # -- decode ----------------------------------------------------------

    def decode_results(self) -> List[AnalysisResult]:
        if self._decoded is not None:
            return self._decoded
        out: List[AnalysisResult] = []
        labels = self.header["series_dict"]
        codes, values = self.series.tolist(), self.values.tolist()
        for entry in self.header["results"]:
            key = ResultKey(
                entry["key"]["dataSetDate"], entry["key"].get("tags", {})
            )
            metric_map: Dict[Any, Any] = {}
            row = entry["row_start"]
            ovf = 0
            for kind in entry.get("order", ""):
                if kind == "r":
                    analyzer, entity, name, instance = _identity_from_label(
                        labels[codes[row]]
                    )
                    metric_map[analyzer] = DoubleMetric(
                        entity, name, instance, Success(values[row]),
                    )
                    row += 1
                else:
                    o = entry["overflow"][ovf]
                    ovf += 1
                    metric_map[serde.analyzer_from_json(o["analyzer"])] = (
                        serde.metric_from_json(o["metric"])
                    )
            out.append(AnalysisResult(key, AnalyzerContext(metric_map)))
        self._decoded = out
        return out


class _HistoryView:
    """The live history materialized once: the engine-facing
    ``ColumnarTable`` plus the host-side filter planes ``query.py``
    masks on (raw dates, global series/tag codes and their label
    indexes). Immutable — rebuilt when the repository version moves."""

    def __init__(self, table, dates, series_codes, series_labels,
                 series_meta, tag_codes, tag_labels):
        self.table = table
        self.dates = dates                  # i64[N]
        self.series_codes = series_codes    # i32[N]
        self.series_labels = series_labels  # [label]
        #: per label: (analyzer_json_str, entity, name, instance)
        self.series_meta = series_meta
        self.tag_codes = tag_codes          # key -> i32[N] (-1 absent)
        self.tag_labels = tag_labels        # key -> [value]

    @property
    def num_rows(self) -> int:
        return len(self.dates)


def _object_array(items: Sequence[str]) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    for i, s in enumerate(items):
        out[i] = s
    return out


class ColumnarMetricsRepository(MetricsRepository):
    """Drop-in :class:`MetricsRepository` storing history as columnar
    append segments (see module doc). ``path=None`` keeps segments in
    memory only (the InMemory analogue — every load still exercises the
    columnar codec); a path makes it durable with crash-consistent
    appends.

    ``monitor`` (a :class:`~deequ_tpu_torch.repository.monitor.QualityMonitor`)
    observes every save online — the anomaly strategies run at
    result-ingest time instead of via batch history pulls."""

    def __init__(
        self,
        path: Optional[str] = None,
        segment_rows: Optional[int] = None,
        on_torn_segment: str = "raise",
        monitor=None,
        retry=None,
        ttl: Optional[float] = None,
    ):
        if on_torn_segment not in ("raise", "recover"):
            raise ValueError(
                "on_torn_segment must be 'raise' or 'recover', got "
                f"{on_torn_segment!r}"
            )
        if segment_rows is None:
            from deequ_tpu_torch.envcfg import env_value

            segment_rows = env_value("DEEQU_TORCH_REPO_SEGMENT_ROWS")
        if int(segment_rows) < 1:
            raise ValueError(f"segment_rows must be >= 1, got {segment_rows}")
        self.segment_rows = int(segment_rows)
        # retention: results older than (newest live dataset date - ttl)
        # drop at compaction, never on the load path, so a reader between
        # compactions sees what the last compaction kept. None (the
        # DEEQU_TORCH_REPO_TTL default) keeps everything.
        if ttl is None:
            from deequ_tpu_torch.envcfg import env_value

            ttl = env_value("DEEQU_TORCH_REPO_TTL")
        if ttl is not None and not float(ttl) > 0:
            raise ValueError(f"ttl must be > 0 dataset-date units, got {ttl}")
        self.ttl = None if ttl is None else float(ttl)
        self.on_torn_segment = on_torn_segment
        self.monitor = monitor
        self._lock = threading.RLock()
        self._segments: List[_Segment] = []
        #: key -> (position in _segments, result index) of the LIVE
        #: result; dict insertion order IS the loader order (same-key
        #: re-saves keep the original position, matching InMemory)
        self._live: Dict[ResultKey, Tuple[int, int]] = {}
        self._dead_results = 0
        self._next_seq = 0
        self._version = 0
        self._view: Optional[_HistoryView] = None
        self._view_version = -1
        self._fs = None
        self.path = None
        if path is not None:
            from deequ_tpu_torch.data.fs import filesystem_for, strip_scheme
            from deequ_tpu_torch.resilience.retry import RetryingFileSystem

            self.path = strip_scheme(path)
            self._fs = RetryingFileSystem(filesystem_for(path), retry)
            self._recover()

    # -- persistence -----------------------------------------------------

    def _segment_path(self, seq: int) -> str:
        return self._fs.join(self.path, f"seg_{seq:010d}{SEGMENT_SUFFIX}")

    def _list_segment_files(self) -> List[Tuple[int, str]]:
        if not self._fs.exists(self.path):
            return []
        out = []
        for name in self._fs.listdir(self.path):
            if name.startswith("seg_") and name.endswith(SEGMENT_SUFFIX):
                try:
                    seq = int(name[4:-len(SEGMENT_SUFFIX)])
                except ValueError:
                    continue
                out.append((seq, name))
        return sorted(out)

    def _recover(self) -> None:
        """Replay persisted segments in sequence order. A corrupt TAIL
        run (the torn-append shape) raises typed — or, with
        ``on_torn_segment="recover"``, drops it and keeps every prior
        segment; corruption strictly BEFORE valid segments always
        raises (that is damage, not a torn append)."""
        from deequ_tpu_torch.resilience.atomic import read_checksummed

        files = self._list_segment_files()
        loaded: List[_Segment] = []
        errors: List[Tuple[int, str, CorruptStateException]] = []
        for seq, name in files:
            what = f"metrics repository segment {name}"
            full = self._fs.join(self.path, name)
            try:
                payload = read_checksummed(self._fs, full, what)
                seg = _Segment.from_bytes(payload, what, seq=seq)
            except CorruptStateException as e:
                errors.append((seq, name, e))
                continue
            if errors:
                # a valid segment AFTER a corrupt one: the damage is not
                # a torn tail — surface the first corruption typed
                raise errors[0][2]
            seg.file = full
            loaded.append(seg)
        if errors:
            if self.on_torn_segment == "raise":
                raise errors[0][2]
            # quarantine the torn tail ON DISK (seg_*.dqmr -> *.corrupt,
            # preserved for forensics but no longer replayed): once a
            # later save() appends a valid segment past the torn seq, a
            # reopen would otherwise see corrupt-before-valid "damage"
            # and raise in BOTH modes, permanently bricking the repo
            # counter-suffixed sidecar names: after a quarantine the
            # reopened repo recomputes _next_seq WITHOUT the torn file,
            # so the same seq can tear again — the second quarantine
            # must not overwrite the first's evidence
            from deequ_tpu_torch.resilience.atomic import quarantine_path

            for _seq, name, _exc in errors:
                full = self._fs.join(self.path, name)
                self._fs.rename(
                    full, quarantine_path(self._fs, full, CORRUPT_SUFFIX)
                )
            REPO_STATS.torn_segments_dropped += len(errors)
        self._segments = loaded
        self._next_seq = (files[-1][0] + 1) if files else 0
        self._live = {}
        self._dead_results = 0
        for pos, seg in enumerate(self._segments):
            for ridx, entry in enumerate(seg.header["results"]):
                key = ResultKey(
                    entry["key"]["dataSetDate"], entry["key"].get("tags", {})
                )
                if key in self._live:
                    self._dead_results += 1
                self._live[key] = (pos, ridx)
        self._version += 1

    def _persist_segment(self, seg: _Segment) -> None:
        from deequ_tpu_torch.resilience.atomic import atomic_write_bytes, wrap_checksum

        self._fs.makedirs(self.path)
        data = wrap_checksum(seg.to_bytes())
        full = self._segment_path(seg.seq)
        atomic_write_bytes(
            self._fs, full, data,
            what=f"metrics repository segment {seg.seq}",
        )
        seg.file = full
        REPO_STATS.bytes_appended += len(data)

    # -- MetricsRepository contract --------------------------------------

    def save(self, result: AnalysisResult) -> None:
        # keep only successful metrics, like the reference (and both
        # sibling backends)
        successful = AnalyzerContext(
            {
                a: m
                for a, m in result.analyzer_context.metric_map.items()
                if m.value.is_success
            }
        )
        to_save = AnalysisResult(result.result_key, successful)
        with self._lock:
            seg = _Segment.encode([to_save], seq=self._next_seq)
            self._next_seq += 1
            if self._fs is not None:
                self._persist_segment(seg)
            pos = len(self._segments)
            self._segments.append(seg)
            if result.result_key in self._live:
                self._dead_results += 1
            self._live[result.result_key] = (pos, 0)
            self._version += 1
            REPO_STATS.saves += 1
            REPO_STATS.segments_written += 1
            REPO_STATS.segment_rows_written += seg.num_rows
            if self._dead_results >= AUTO_COMPACT_DEAD:
                self._compact_locked()
        if self.monitor is not None:
            try:
                self.monitor.observe_result(to_save)
            # monitoring observes, it never decides the outcome: the
            # segment is already persisted, so a watch-rule or checkpoint
            # error must not fail the save; counted on MONITOR_STATS
            except Exception:  # noqa: BLE001
                from deequ_tpu_torch.repository.monitor import MONITOR_STATS

                MONITOR_STATS.monitor_errors += 1

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalysisResult]:
        with self._lock:
            pos = self._live.get(result_key)
            if pos is None:
                return None
            seg_idx, ridx = pos
            return self._segments[seg_idx].decode_results()[ridx]

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        def provider() -> List[AnalysisResult]:
            with self._lock:
                return [
                    self._segments[seg_idx].decode_results()[ridx]
                    for seg_idx, ridx in self._live.values()
                ]

        return MetricsRepositoryMultipleResultsLoader(provider)

    # -- compaction ------------------------------------------------------

    def compact(self) -> int:
        """Rewrite the live history into batched segments of up to
        ``segment_rows`` rows each and drop superseded results — plus,
        with a ``ttl`` armed, results wholly older than (newest live
        dataset date - ttl). Returns the total results dropped (dead +
        TTL-expired). Crash-safe: new segments are written (atomic,
        fresh sequence numbers) before old files are deleted — a crash
        mid-compaction leaves a replayable superset whose
        last-write-wins replay yields the same live set."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        dead = self._dead_results
        dropped = dead
        live = [
            self._segments[seg_idx].decode_results()[ridx]
            for seg_idx, ridx in self._live.values()
        ]
        if self.ttl is not None and live:
            # retention: the horizon trails the NEWEST live result (not
            # the wall clock — dataset dates are the caller's axis), so
            # an idle repository never silently empties itself
            horizon = max(
                r.result_key.data_set_date for r in live
            ) - self.ttl
            kept = [
                r for r in live if r.result_key.data_set_date >= horizon
            ]
            expired = len(live) - len(kept)
            if expired:
                REPO_STATS.ttl_dropped += expired
                dropped += expired
                live = kept
        old_files = [s.file for s in self._segments if s.file is not None]
        # batch by rows: a result's scalar-row count decides the split
        batches: List[List[AnalysisResult]] = []
        current: List[AnalysisResult] = []
        current_rows = 0
        for result in live:
            rows = sum(
                1
                for a, m in result.analyzer_context.metric_map.items()
                if isinstance(m, DoubleMetric) and m.value.is_success
            )
            if current and (
                current_rows + rows > self.segment_rows
                or len(current) >= MAX_SEGMENT_DICT
            ):
                batches.append(current)
                current, current_rows = [], 0
            current.append(result)
            current_rows += rows
        if current:
            batches.append(current)
        new_segments: List[_Segment] = []
        for batch in batches:
            seg = _Segment.encode(batch, seq=self._next_seq)
            self._next_seq += 1
            if self._fs is not None:
                self._persist_segment(seg)
            new_segments.append(seg)
        self._segments = new_segments
        self._live = {}
        for pos, seg in enumerate(self._segments):
            for ridx, entry in enumerate(seg.header["results"]):
                key = ResultKey(
                    entry["key"]["dataSetDate"], entry["key"].get("tags", {})
                )
                self._live[key] = (pos, ridx)
        self._dead_results = 0
        self._version += 1
        if self._fs is not None:
            for stale in old_files:
                try:
                    self._fs.delete(stale)
                # a stale pre-compaction segment is harmless (replay is
                # last-write-wins): deletion is best effort
                except Exception:  # noqa: BLE001
                    pass
        REPO_STATS.compactions += 1
        REPO_STATS.dead_results_dropped += dead
        return dropped

    # -- the history table (query substrate) -----------------------------

    @property
    def num_segments(self) -> int:
        with self._lock:
            return len(self._segments)

    def history_table(self):
        """The live history as one ``ColumnarTable`` (cached until the
        next save or compaction): ``dataset_date`` (INTEGRAL), ``value``
        (FRACTIONAL), ``series``/``metric``/``instance`` (STRING), and
        one ``tag:<key>`` STRING column per tag key. The two numeric
        columns carry int16 ``ColumnChunk`` encodings where their
        cardinality allows (2-byte codes to the card instead of 8-byte
        values); ``run_scan(encoded_ingest=False)`` packs them decoded
        for the A/B run, so the cache never forks per switch."""
        return self._history_view().table

    def _history_view(self) -> _HistoryView:
        with self._lock:
            if self._view is not None and self._view_version == self._version:
                return self._view
            view = self._build_view()
            self._view = view
            self._view_version = self._version
            REPO_STATS.table_builds += 1
            return view

    def _build_view(self) -> _HistoryView:
        from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

        date_parts: List[np.ndarray] = []
        value_parts: List[np.ndarray] = []
        series_parts: List[np.ndarray] = []
        tag_parts: Dict[str, List[np.ndarray]] = {}
        series_labels: List[str] = []
        series_index: Dict[str, int] = {}
        tag_labels: Dict[str, List[str]] = {}
        tag_index: Dict[str, Dict[str, int]] = {}
        all_tag_keys = sorted({
            k
            for seg_idx, _ in self._live.values()
            for k in self._segments[seg_idx].header["tag_keys"]
        })
        part_rows: List[int] = []

        for seg_idx, ridx in self._live.values():
            seg = self._segments[seg_idx]
            entry = seg.header["results"][ridx]
            a, b = entry["row_start"], entry["row_stop"]
            if a == b:
                continue
            date_parts.append(seg.dates[a:b])
            value_parts.append(seg.values[a:b])
            # remap per-segment int16 codes into the global label space
            labels = seg.header["series_dict"]
            remap = np.full(max(len(labels), 1), -1, dtype=np.int32)
            for local, label in enumerate(labels):
                gcode = series_index.get(label)
                if gcode is None:
                    gcode = len(series_labels)
                    series_index[label] = gcode
                    series_labels.append(label)
                remap[local] = gcode
            series_parts.append(remap[seg.series[a:b]])
            n_part = b - a
            part_rows.append(n_part)
            for k in all_tag_keys:
                codes = seg.tag_codes.get(k)
                if codes is None:
                    tag_parts.setdefault(k, []).append(
                        np.full(n_part, -1, dtype=np.int32)
                    )
                    continue
                seg_vals = seg.header["tag_dicts"].get(k, [])
                tmap = np.full(max(len(seg_vals), 1) + 1, -1, dtype=np.int32)
                idx_map = tag_index.setdefault(k, {})
                vals = tag_labels.setdefault(k, [])
                for local, v in enumerate(seg_vals):
                    g = idx_map.get(v)
                    if g is None:
                        g = len(vals)
                        idx_map[v] = g
                        vals.append(v)
                    tmap[local] = g
                # -1 (absent) indexes the trailing -1 slot
                tag_parts.setdefault(k, []).append(
                    tmap[seg.tag_codes[k][a:b]]
                )

        n = int(sum(part_rows))
        if n:
            dates = np.concatenate(date_parts)
            values = np.concatenate(value_parts)
            series_codes = np.concatenate(series_parts)
        else:
            dates = np.zeros(0, dtype=np.int64)
            values = np.zeros(0, dtype=np.float64)
            series_codes = np.zeros(0, dtype=np.int32)
        tag_codes = {
            k: (
                np.concatenate(parts) if n else np.zeros(0, dtype=np.int32)
            )
            for k, parts in tag_parts.items()
        }

        series_meta = []
        for label in series_labels:
            meta = json.loads(label)
            series_meta.append((
                json.dumps(meta["a"], sort_keys=True, separators=(",", ":")),
                meta["e"], meta["m"], meta["i"],
            ))
        name_of = np.full(max(len(series_labels), 1), -1, dtype=np.int32)
        inst_of = np.full(max(len(series_labels), 1), -1, dtype=np.int32)
        names: List[str] = []
        name_idx: Dict[str, int] = {}
        insts: List[str] = []
        inst_idx: Dict[str, int] = {}
        for i, (_, _, m, inst) in enumerate(series_meta):
            if m not in name_idx:
                name_idx[m] = len(names)
                names.append(m)
            name_of[i] = name_idx[m]
            if inst not in inst_idx:
                inst_idx[inst] = len(insts)
                insts.append(inst)
            inst_of[i] = inst_idx[inst]

        mask = np.ones(n, dtype=np.bool_)
        columns = [
            Column("dataset_date", DType.INTEGRAL, values=dates, mask=mask),
            Column("value", DType.FRACTIONAL, values=values, mask=mask),
            Column(
                "series", DType.STRING, codes=series_codes,
                dictionary=_object_array(series_labels),
            ),
            Column(
                "metric", DType.STRING,
                codes=(name_of[series_codes] if n else series_codes),
                dictionary=_object_array(names),
            ),
            Column(
                "instance", DType.STRING,
                codes=(inst_of[series_codes] if n else series_codes),
                dictionary=_object_array(insts),
            ),
        ]
        for k in sorted(tag_codes):
            columns.append(Column(
                f"tag:{k}", DType.STRING, codes=tag_codes[k],
                dictionary=_object_array(tag_labels.get(k, [])),
            ))
        table = ColumnarTable(columns)
        if n:
            # low-cardinality numeric planes ride int16 codes to the card;
            # near-unique ones stay decoded (the ColumnChunk cardinality
            # rule)
            table.encode(["dataset_date", "value"])
        return _HistoryView(
            table, dates, series_codes, series_labels, series_meta,
            tag_codes, tag_labels,
        )

    # -- queries ---------------------------------------------------------

    def query(self, query=None, **kw):
        """Run one :class:`~deequ_tpu_torch.repository.query.RepositoryQuery`
        as a fused engine scan over :meth:`history_table` (see
        repository/query.py). Keyword form:
        ``repo.query(metric_name="Completeness", after=..., tag_values=...)``."""
        from deequ_tpu_torch.repository.query import RepositoryQuery, run_repository_query

        if query is None:
            query = RepositoryQuery(**kw)
        return run_repository_query(self, query)
