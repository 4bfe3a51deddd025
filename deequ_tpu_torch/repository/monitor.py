"""Online quality monitoring: anomaly strategies fed at result-ingest
time (the port's copy of ``deequ_tpu/repository/monitor.py``; its
checkpoint is the reference's format, so either package resumes the
other's).

The batch anomaly path (``checks.is_newest_point_non_anomalous``) pulls
the whole history through the repository loader per check. The
:class:`QualityMonitor` hooks the repository's save seam
(``ColumnarMetricsRepository(monitor=...)``) and folds every new metric
point into per-series incremental state:

- **Holt-Winters** (``anomaly/seasonal.py``): (alpha, beta, gamma) fit
  once, when the series reaches two full cycles (the batch strategy's
  fit: one launch of the Holt-Winters kernel on the card), then level,
  trend and season carried forward, O(1) a point;
- **OnlineNormal**: the Welford (mean, M2) recursion carried forward,
  anomalous points optionally kept out of the running statistics;
- any other :class:`AnomalyDetectionStrategy`: a bounded per-series
  history window replayed through the strategy's own
  ``is_new_point_anomalous`` (exact batch semantics, O(window) a point).

A point out of bounds emits a typed :class:`QualityAlert` onto the
monitor's bounded ledger (``alerts``) and ``MONITOR_STATS``.

Kill-and-resume is bit-identical: per-series state (floats as
``float.hex``) and the alert ledger checkpoint atomically
(``resilience/atomic.py``). On resume, :meth:`catch_up` replays the
repository's history; each state's ``last_time`` gate skips points
already folded, so the resumed state equals the uninterrupted run's bit
for bit and no alert is emitted twice.

``DEEQU_TORCH_MONITOR=0`` (envcfg) turns observation off process-wide:
saves are unaffected, alerts stop. Serving traffic feeds the same rules
at the resolve seam (:meth:`QualityMonitor.observe_verification`, called
by ``VerificationService(monitor=...)``), and each alert is an instant
event on an armed flight recorder (``obs/``).
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from deequ_tpu_torch.exceptions import CorruptStateException
from deequ_tpu_torch.metrics import DoubleMetric

STATE_FILE = "monitor_state.dqmn"
STATE_VERSION = 1


class _MonitorStats:
    """Process-wide monitor observables (observations, folded and stale
    points, alerts, checkpoints, resumes, errors), beside REPO_STATS."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.monitor_observations = 0
        self.monitor_points_folded = 0
        self.monitor_stale_points = 0
        self.alerts_emitted = 0
        self.monitor_checkpoints = 0
        self.monitor_resumes = 0
        self.monitor_errors = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


MONITOR_STATS = _MonitorStats()


def _hex(x: float) -> str:
    return float(x).hex()


def _unhex(s: str) -> float:
    return float.fromhex(s)


@dataclass
class QualityAlert:
    """One typed anomaly event: which watch rule fired, on which series
    (identity + tags), at which dataset time, with the offending value
    and the strategy's confidence/detail."""

    rule: str
    series: str
    time: int
    value: float
    confidence: float = 1.0
    detail: Optional[str] = None

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "series": self.series,
            "time": self.time,
            "value": self.value,
            "confidence": self.confidence,
            "detail": self.detail,
        }


# -- per-series incremental states ------------------------------------------


class _SeriesState:
    """One (rule, series) incremental state. ``update`` folds one point
    and returns the anomalies it triggered; points at or before
    ``last_time`` are STALE (already folded — the resume/replay dedup
    gate) and must be skipped by the caller."""

    kind = "generic"

    def __init__(self):
        self.last_time: Optional[int] = None
        self.count = 0

    def update(self, time: int, value: float) -> List[Tuple[float, str]]:
        raise NotImplementedError

    def to_blob(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_blob(cls, rule, blob: dict) -> "_SeriesState":
        raise NotImplementedError


class _GenericSeriesState(_SeriesState):
    """Fallback for arbitrary strategies: keep a bounded window of the
    series and ask the strategy's own ``is_new_point_anomalous`` —
    exact batch semantics per point (a strategy that raises on
    insufficient history is in warmup: no anomaly yet)."""

    kind = "generic"

    def __init__(self, strategy, max_history: int):
        super().__init__()
        self.strategy = strategy
        self.max_history = max_history
        self.history: List[Tuple[int, float]] = []

    def update(self, time: int, value: float) -> List[Tuple[float, str]]:
        from deequ_tpu_torch.anomaly import AnomalyDetector
        from deequ_tpu_torch.anomaly.history import DataPoint

        out: List[Tuple[float, str]] = []
        if self.history:
            detector = AnomalyDetector(self.strategy)
            points = [DataPoint(t, v) for t, v in self.history]
            try:
                result = detector.is_new_point_anomalous(
                    points, DataPoint(time, value)
                )
                out = [
                    (a.confidence, a.detail)
                    for _, a in result.anomalies
                ]
            except ValueError:
                # the strategy needs more history than the window holds
                # yet (HoltWinters two-cycle minimum, BatchNormal's
                # training requirement): warmup, not an anomaly
                out = []
        self.history.append((time, value))
        if len(self.history) > self.max_history:
            self.history = self.history[-self.max_history:]
        self.last_time = time
        self.count += 1
        return out

    def to_blob(self) -> dict:
        return {
            "last_time": self.last_time,
            "count": self.count,
            "history": [(t, _hex(v)) for t, v in self.history],
        }

    @classmethod
    def from_blob(cls, rule, blob: dict) -> "_GenericSeriesState":
        state = cls(rule.strategy, rule.max_history)
        state.last_time = blob["last_time"]
        state.count = blob["count"]
        state.history = [(t, _unhex(v)) for t, v in blob["history"]]
        return state


class _OnlineNormalSeriesState(_SeriesState):
    """Welford mean/variance carried forward; a point outside
    mean ± factor·stddev (after ``warmup`` points) alerts, and —
    matching the batch strategy's ``ignore_anomalies`` — is excluded
    from the running statistics so one outlier cannot widen the
    envelope that should keep catching its successors."""

    kind = "online_normal"

    def __init__(self, strategy, warmup: int):
        super().__init__()
        self.strategy = strategy
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def _bounds(self) -> Tuple[float, float]:
        std = math.sqrt(self.m2 / self.n) if self.n > 0 else 0.0
        lo_f = self.strategy.lower_deviation_factor
        hi_f = self.strategy.upper_deviation_factor
        lower = self.mean - (lo_f * std if lo_f is not None else math.inf)
        upper = self.mean + (hi_f * std if hi_f is not None else math.inf)
        return lower, upper

    def update(self, time: int, value: float) -> List[Tuple[float, str]]:
        out: List[Tuple[float, str]] = []
        anomalous = False
        if self.n >= self.warmup:
            lower, upper = self._bounds()
            if value < lower or value > upper:
                anomalous = True
                out.append((
                    1.0,
                    f"[OnlineNormal] value {value} outside "
                    f"[{lower}, {upper}] after {self.n} points",
                ))
        if not (anomalous and self.strategy.ignore_anomalies):
            self.n += 1
            delta = value - self.mean
            self.mean += delta / self.n
            self.m2 += delta * (value - self.mean)
        self.last_time = time
        self.count += 1
        return out

    def to_blob(self) -> dict:
        return {
            "last_time": self.last_time,
            "count": self.count,
            "n": self.n,
            "mean": _hex(self.mean),
            "m2": _hex(self.m2),
        }

    @classmethod
    def from_blob(cls, rule, blob: dict) -> "_OnlineNormalSeriesState":
        state = cls(rule.strategy, rule.warmup)
        state.last_time = blob["last_time"]
        state.count = blob["count"]
        state.n = blob["n"]
        state.mean = _unhex(blob["mean"])
        state.m2 = _unhex(blob["m2"])
        return state


class _HoltWintersSeriesState(_SeriesState):
    """Level/trend/season carried forward (ETS(A,A), the reference
    recursion from ``anomaly/seasonal.py``): the first ``2p`` points
    are warmup; at the boundary (alpha, beta, gamma) fit ONCE with the
    strategy's fit (``_fit_parameters``) and the recursion replays the
    warmup to seed state + one-step residual spread (Welford over
    |residual|). Every later point is O(1): forecast from carried
    state, alert past 1.96 residual sigmas, fold the observation in."""

    kind = "holt_winters"

    def __init__(self, strategy):
        super().__init__()
        self.strategy = strategy
        self.p = strategy.series_periodicity
        self.warmup_values: List[float] = []
        self.armed = False
        self.abg: Optional[Tuple[float, float, float]] = None
        self.level = 0.0
        self.trend = 0.0
        self.season: List[float] = []
        self.rn = 0
        self.rmean = 0.0
        self.rm2 = 0.0

    def _residual_sd(self) -> float:
        if self.rn <= 1:
            return 0.0
        return math.sqrt(self.rm2 / (self.rn - 1))

    def _fold_residual(self, r: float) -> None:
        self.rn += 1
        delta = r - self.rmean
        self.rmean += delta / self.rn
        self.rm2 += delta * (r - self.rmean)

    def _step(self, observed: float) -> float:
        """One recursion step: returns the one-step-ahead forecast the
        state held BEFORE folding ``observed`` in."""
        a, b, g = self.abg
        st = self.season[0]
        forecast = self.level + self.trend + st
        new_level = a * (observed - st) + (1 - a) * (self.level + self.trend)
        new_trend = b * (new_level - self.level) + (1 - b) * self.trend
        new_season = g * (observed - self.level - self.trend) + (1 - g) * st
        self.level = new_level
        self.trend = new_trend
        self.season = self.season[1:] + [new_season]
        return forecast

    def _arm(self) -> None:
        import numpy as np

        from deequ_tpu_torch.anomaly.seasonal import _fit_parameters

        p = self.p
        training = np.fromiter(
            self.warmup_values, dtype=np.float64,
            count=len(self.warmup_values),
        )
        # on the device of the ambient use_device scope, else cuda
        self.abg = _fit_parameters(training, p, None)
        level0 = float(training[:p].sum() / p)
        trend0 = float(
            (training[p:2 * p].sum() - training[:p].sum()) / (p * p)
        )
        self.level = level0
        self.trend = trend0
        self.season = [float(v - level0) for v in self.warmup_values[:p]]
        # replay the warmup through the recursion: state ends where a
        # batch fit over the same points would, and the one-step
        # residuals seed the alert envelope
        for observed in self.warmup_values:
            forecast = self._step(observed)
            self._fold_residual(abs(observed - forecast))
        self.armed = True
        self.warmup_values = []

    def update(self, time: int, value: float) -> List[Tuple[float, str]]:
        out: List[Tuple[float, str]] = []
        if not self.armed:
            self.warmup_values.append(value)
            if len(self.warmup_values) >= 2 * self.p:
                self._arm()
        else:
            sd = self._residual_sd()
            forecast = self._step(value)
            if abs(value - forecast) > 1.96 * sd:
                out.append((
                    1.0,
                    f"[HoltWinters] forecasted {forecast} for observed "
                    f"value {value}",
                ))
            self._fold_residual(abs(value - forecast))
        self.last_time = time
        self.count += 1
        return out

    def to_blob(self) -> dict:
        return {
            "last_time": self.last_time,
            "count": self.count,
            "p": self.p,
            "armed": self.armed,
            "warmup": [_hex(v) for v in self.warmup_values],
            "abg": [_hex(v) for v in self.abg] if self.abg else None,
            "level": _hex(self.level),
            "trend": _hex(self.trend),
            "season": [_hex(v) for v in self.season],
            "rn": self.rn,
            "rmean": _hex(self.rmean),
            "rm2": _hex(self.rm2),
        }

    @classmethod
    def from_blob(cls, rule, blob: dict) -> "_HoltWintersSeriesState":
        state = cls(rule.strategy)
        state.last_time = blob["last_time"]
        state.count = blob["count"]
        state.p = blob["p"]
        state.armed = blob["armed"]
        state.warmup_values = [_unhex(v) for v in blob["warmup"]]
        state.abg = (
            tuple(_unhex(v) for v in blob["abg"]) if blob["abg"] else None
        )
        state.level = _unhex(blob["level"])
        state.trend = _unhex(blob["trend"])
        state.season = [_unhex(v) for v in blob["season"]]
        state.rn = blob["rn"]
        state.rmean = _unhex(blob["rmean"])
        state.rm2 = _unhex(blob["rm2"])
        return state


_STATE_KINDS = {
    cls.kind: cls
    for cls in (
        _GenericSeriesState, _OnlineNormalSeriesState, _HoltWintersSeriesState
    )
}


@dataclass
class _WatchRule:
    """One registered watch: which metric points it matches and which
    strategy judges them."""

    name: str
    strategy: Any
    analyzer: Optional[Any] = None
    metric_name: Optional[str] = None
    instance: Optional[str] = None
    tag_values: Optional[Tuple[Tuple[str, str], ...]] = None
    warmup: int = 5
    max_history: int = 512

    def tags_match(self, tags: Dict[str, str]) -> bool:
        return all(tags.get(k) == v for k, v in self.tag_values or ())

    def matches(self, analyzer, metric, tags: Dict[str, str]) -> bool:
        if self.analyzer is not None and analyzer != self.analyzer:
            return False
        if self.metric_name is not None and metric.name != self.metric_name:
            return False
        if self.instance is not None and metric.instance != self.instance:
            return False
        if self.tag_values:
            for k, v in self.tag_values:
                if tags.get(k) != v:
                    return False
        return True

    def make_state(self) -> _SeriesState:
        from deequ_tpu_torch.anomaly.seasonal import HoltWinters
        from deequ_tpu_torch.anomaly.strategies import OnlineNormalStrategy

        if isinstance(self.strategy, HoltWinters):
            return _HoltWintersSeriesState(self.strategy)
        if isinstance(self.strategy, OnlineNormalStrategy):
            return _OnlineNormalSeriesState(self.strategy, self.warmup)
        return _GenericSeriesState(self.strategy, self.max_history)


class QualityMonitor:
    """The online monitor (see module doc). Thread-safe: concurrent saves
    observe under one lock. A Holt-Winters series fits when it arms on
    the device of the save's ``use_device`` scope (a ``run()`` saving its
    result sets it to the run's device), else on ``cuda``."""

    def __init__(
        self,
        state_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        max_alerts: int = 4096,
        retry=None,
    ):
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.checkpoint_every = int(checkpoint_every)
        self.max_alerts = int(max_alerts)
        self._rules: List[_WatchRule] = []
        self._states: Dict[Tuple[str, str], _SeriesState] = {}
        self.alerts: List[QualityAlert] = []
        self.alerts_dropped = 0
        self._lock = threading.RLock()
        self._obs_since_ckpt = 0
        self._fs = None
        self.state_dir = None
        if state_dir is not None:
            from deequ_tpu_torch.data.fs import filesystem_for, strip_scheme
            from deequ_tpu_torch.resilience.retry import RetryingFileSystem

            self.state_dir = strip_scheme(state_dir)
            self._fs = RetryingFileSystem(filesystem_for(state_dir), retry)
            self._load_state()

    # -- registration ----------------------------------------------------

    def watch(
        self,
        strategy,
        analyzer=None,
        metric_name: Optional[str] = None,
        instance: Optional[str] = None,
        tags: Optional[Dict[str, str]] = None,
        name: Optional[str] = None,
        warmup: int = 5,
        max_history: int = 512,
    ) -> str:
        """Register one watch rule; returns its name. At least one of
        ``analyzer`` / ``metric_name`` / ``instance`` should narrow the
        match (a bare rule watches EVERY scalar metric)."""
        with self._lock:
            rule_name = name or f"watch-{len(self._rules)}"
            if any(r.name == rule_name for r in self._rules):
                raise ValueError(f"duplicate watch rule name {rule_name!r}")
            self._rules.append(_WatchRule(
                name=rule_name,
                strategy=strategy,
                analyzer=analyzer,
                metric_name=metric_name,
                instance=instance,
                tag_values=(
                    tuple(sorted(tags.items())) if tags else None
                ),
                warmup=warmup,
                max_history=max_history,
            ))
            return rule_name

    @staticmethod
    def enabled() -> bool:
        from deequ_tpu_torch.envcfg import env_value

        return bool(env_value("DEEQU_TORCH_MONITOR"))

    # -- observation seams ----------------------------------------------

    def observe_result(self, result) -> List[QualityAlert]:
        """The repository save seam: fold one AnalysisResult's scalar
        metrics into every matching rule's series state. Returns the
        alerts this observation emitted."""
        key = result.result_key
        return self._observe_metrics(
            result.analyzer_context.metric_map,
            dict(key.tags),
            int(key.data_set_date),
        )

    def observe_verification(self, tenant, result) -> List[QualityAlert]:
        """The serving resolve seam (``VerificationService(monitor=...)``):
        fold a resolved VerificationResult's metrics as the tenant's
        series, timed by a per-series sequence (serving traffic has no
        dataset date: the stream position is the time axis)."""
        metric_map = getattr(result, "metrics", None)
        if not metric_map:
            return []
        tags = {"tenant": "?" if tenant is None else str(tenant)}
        return self._observe_metrics(metric_map, tags, None)

    def _observe_metrics(
        self,
        metric_map: Dict[Any, Any],
        tags: Dict[str, str],
        time: Optional[int],
    ) -> List[QualityAlert]:
        if not self.enabled():
            return []
        from deequ_tpu_torch.repository.columnar import series_identity

        emitted: List[QualityAlert] = []
        with self._lock:
            if not self._rules:
                return []
            self._rebind_states()
            MONITOR_STATS.monitor_observations += 1
            tag_label = json.dumps(
                tags, sort_keys=True, separators=(",", ":")
            )
            # the rules whose tags this observation carries: in a fleet's
            # repository most saves match none, and their metrics are
            # then not looked at
            rules = [r for r in self._rules if r.tags_match(tags)]
            for analyzer, metric in (metric_map.items() if rules else ()):
                if not isinstance(metric, DoubleMetric):
                    continue
                if not metric.value.is_success:
                    continue
                value = metric.value.get()
                if not isinstance(value, float):
                    continue
                identity = series_identity(analyzer, metric)
                if identity is None:
                    continue
                for rule in rules:
                    if not rule.matches(analyzer, metric, tags):
                        continue
                    series = f"{identity}|{tag_label}"
                    state = self._states.get((rule.name, series))
                    if state is None:
                        state = rule.make_state()
                        self._states[(rule.name, series)] = state
                    point_time = time
                    if point_time is None:
                        point_time = 0 if state.last_time is None else state.last_time + 1
                    if (
                        state.last_time is not None
                        and point_time <= state.last_time
                    ):
                        # already folded (a catch_up replay, or an
                        # out-of-order save): skipping is what makes
                        # resume alerts exactly-once
                        MONITOR_STATS.monitor_stale_points += 1
                        continue
                    for confidence, detail in state.update(
                        point_time, float(value)
                    ):
                        alert = QualityAlert(
                            rule=rule.name, series=series,
                            time=point_time, value=float(value),
                            confidence=confidence, detail=detail,
                        )
                        self._emit(alert)
                        emitted.append(alert)
                    MONITOR_STATS.monitor_points_folded += 1
            self._obs_since_ckpt += 1
            if (
                self._fs is not None
                and self._obs_since_ckpt >= self.checkpoint_every
            ):
                self._write_state()
        return emitted

    def _emit(self, alert: QualityAlert) -> None:
        self.alerts.append(alert)
        if len(self.alerts) > self.max_alerts:
            self.alerts = self.alerts[-self.max_alerts:]
            self.alerts_dropped += 1
        MONITOR_STATS.alerts_emitted += 1
        from deequ_tpu_torch.obs.recorder import current_recorder

        rec = current_recorder()
        if rec is not None:
            rec.event("quality_alert", rule=alert.rule, time=alert.time,
                      value=alert.value, detail=alert.detail)

    # -- checkpoint / resume ---------------------------------------------

    def catch_up(self, repository) -> int:
        """Replay a repository's live history through the observation
        seam (dataset-date order — the order a live monitor saw the
        saves in). Stale points are skipped by the per-series gate, so
        calling this after a resume folds exactly the points the killed
        monitor missed. Returns the number of results replayed."""
        results = repository.load().get()
        results = sorted(results, key=lambda r: r.result_key.data_set_date)
        for result in results:
            self.observe_result(result)
        return len(results)

    def _state_path(self) -> str:
        return self._fs.join(self.state_dir, STATE_FILE)

    def state_blob(self) -> dict:
        """The full serialized monitor state (also the bit-identity
        observable tests compare across kill-and-resume)."""
        with self._lock:
            states = {
                f"{rule_name}\x00{series}": {
                    "kind": state.kind,
                    "blob": state.to_blob(),
                }
                for (rule_name, series), state in sorted(
                    self._states.items()
                )
            }
            # recovered states whose rules were never re-registered ride
            # along unchanged — a checkpoint taken before registration
            # completes must not lose them
            for key, entry in (
                getattr(self, "_pending_states", None) or {}
            ).items():
                states.setdefault(key, entry)
            return {
                "version": STATE_VERSION,
                "rules": sorted(r.name for r in self._rules),
                "states": states,
                "alerts": [a.as_dict() for a in self.alerts],
                "alerts_dropped": self.alerts_dropped,
            }

    def _write_state(self) -> None:
        from deequ_tpu_torch.resilience.atomic import atomic_write_bytes, wrap_checksum

        payload = json.dumps(
            self.state_blob(), separators=(",", ":")
        ).encode("utf-8")
        self._fs.makedirs(self.state_dir)
        atomic_write_bytes(
            self._fs, self._state_path(), wrap_checksum(payload),
            what="quality-monitor state",
        )
        self._obs_since_ckpt = 0
        MONITOR_STATS.monitor_checkpoints += 1

    def checkpoint(self) -> None:
        """Force a state checkpoint now (the periodic one runs every
        ``checkpoint_every`` observations)."""
        with self._lock:
            if self._fs is not None:
                self._write_state()

    def _load_state(self) -> None:
        from deequ_tpu_torch.resilience.atomic import read_checksummed

        path = self._state_path()
        if not self._fs.exists(path):
            return
        payload = read_checksummed(
            self._fs, path, "quality-monitor state"
        )
        try:
            blob = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise CorruptStateException(
                "quality-monitor state", f"undecodable payload: {e}"
            ) from e
        if blob.get("version", 0) > STATE_VERSION:
            raise CorruptStateException(
                "quality-monitor state",
                f"version {blob.get('version')} newer than supported "
                f"{STATE_VERSION}",
            )
        self._pending_states = blob.get("states", {})
        self.alerts = [
            QualityAlert(**a) for a in blob.get("alerts", [])
        ]
        self.alerts_dropped = blob.get("alerts_dropped", 0)
        MONITOR_STATS.monitor_resumes += 1

    def _rebind_states(self) -> None:
        """Attach recovered state blobs to their (re-registered) rules.
        Called lazily after ``watch`` registrations so construction
        order (resume then register) works."""
        pending = getattr(self, "_pending_states", None)
        if not pending:
            return
        by_name = {r.name: r for r in self._rules}
        still_pending: Dict[str, dict] = {}
        for key, entry in pending.items():
            rule_name, _, series = key.partition("\x00")
            rule = by_name.get(rule_name)
            cls = _STATE_KINDS.get(entry.get("kind"))
            if rule is None or cls is None:
                # rule not (yet) re-registered: keep the blob pending so
                # a later registration — or the next checkpoint — still
                # carries it
                still_pending[key] = entry
                continue
            self._states[(rule_name, series)] = cls.from_blob(
                rule, entry["blob"]
            )
        self._pending_states = still_pending or None

    def resume(self) -> None:
        """Bind recovered per-series states to the registered rules.
        Call AFTER re-registering the same ``watch`` rules the killed
        monitor ran with."""
        with self._lock:
            self._rebind_states()
