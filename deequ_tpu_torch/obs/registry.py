"""The unified metrics registry — one call reads the whole engine (the
counterpart of ``deequ_tpu/obs/registry.py``).

- :class:`Counter`, :class:`Gauge`, :class:`Histogram` and
  :class:`HistogramFamily` are instruments the registry owns: the serving
  layer's per-tenant submit->resolve latency, its queue depth, its
  submitted/resolved/rejected counts, the admission tier's per-SLO-class
  counters and the brownout level;
- the read-through sections call the engine's own singletons at every
  scrape and copy none of their counters, so the registry's numbers and
  the singletons' are the same numbers: ``scan`` (``ScanStats``),
  ``retry`` (``RETRY_TELEMETRY``), ``hbm`` (the device residency of
  persisted tables), ``env`` (the ``DEEQU_TORCH_*`` switches),
  ``repository`` (the columnar repository and the quality monitor, once
  imported), ``kernels`` (the histogram census by variant and the forced
  variant), ``planner`` (fused grouping passes, sub-plan hits, the fusion
  switch) and ``serve``;
- :meth:`MetricsRegistry.snapshot` is everything as one nested dict and
  :meth:`MetricsRegistry.render_text` a Prometheus-style text exposition.

``deequ_tpu_torch.execution_report()`` returns ``REGISTRY.snapshot()``;
``deequ_tpu_torch.scan_execution_report()`` is its ``"scan"`` section.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def default_latency_buckets() -> Tuple[float, ...]:
    """Log-spaced latency bounds in seconds, 100 us to ~9 minutes, four a
    decade."""
    return tuple(frac * 10.0 ** exp for exp in range(-4, 3)
                 for frac in (1.0, 1.78, 3.16, 5.62))


class Counter:
    """A monotone counter; ``inc`` takes the instrument's lock (caller
    threads and the serving worker both increment)."""

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """A point-in-time value (``set``)."""

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self.value: Any = 0

    def set(self, value) -> None:
        self.value = value

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Histogram:
    """A fixed-bound histogram with count, sum, min, max and quantile
    estimates: ``quantile(q)`` is the upper bound of the bucket where the
    cumulative count reaches ``q * count`` (the observed max past the last
    bound)."""

    def __init__(self, name: str, doc: str = "", buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.doc = doc
        self.bounds: Tuple[float, ...] = tuple(
            buckets if buckets is not None else default_latency_buckets())
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram buckets must be sorted ascending")
        self.reset()

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def quantile(self, q: float) -> Optional[float]:
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)  # the last: past every bound
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def snapshot(self) -> dict:
        return {
            "count": self.count, "sum": round(self.sum, 6), "min": self.min, "max": self.max,
            "p50": self.quantile(0.50), "p95": self.quantile(0.95), "p99": self.quantile(0.99),
        }


class HistogramFamily:
    """Histograms by label (one a tenant) with bounded cardinality: past
    ``max_labels`` the least recently observed label's histogram is
    evicted; the ``_all`` aggregate observes every value whatever its
    label."""

    def __init__(self, name: str, doc: str = "", buckets: Optional[Sequence[float]] = None,
                 max_labels: int = 256):
        self.name = name
        self.doc = doc
        self._buckets = buckets
        self.max_labels = int(max_labels)
        self.aggregate = Histogram(name, doc, buckets)
        self._by_label: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self.evicted_labels = 0

    def observe(self, label, value: float) -> None:
        key = str(label)
        # the whole observation under the family's lock: two threads on a
        # fresh label would otherwise each build a histogram and lose one
        with self._lock:
            self.aggregate.observe(value)
            hist = self._by_label.pop(key, None)
            if hist is None:
                hist = Histogram(f"{self.name}{{{key}}}", self.doc, self._buckets)
                while len(self._by_label) >= self.max_labels:
                    self._by_label.pop(next(iter(self._by_label)))
                    self.evicted_labels += 1
            self._by_label[key] = hist  # most recent last
            hist.observe(value)

    def labels(self) -> List[str]:
        with self._lock:
            return list(self._by_label)

    def label(self, label) -> Optional[Histogram]:
        with self._lock:
            return self._by_label.get(str(label))

    def reset(self) -> None:
        with self._lock:
            self._by_label.clear()
            self.evicted_labels = 0
            self.aggregate.reset()

    def snapshot(self) -> dict:
        with self._lock:
            per_label = {key: hist.snapshot() for key, hist in self._by_label.items()}
            aggregate = self.aggregate.snapshot()
        return {"_all": aggregate, "labels": len(per_label),
                "evicted_labels": self.evicted_labels, "per_label": per_label}


class MetricsRegistry:
    """Instruments and read-through sections (module doc)."""

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()

    def _register(self, instrument):
        with self._lock:
            existing = self._instruments.get(instrument.name)
            if existing is not None:
                return existing
            self._instruments[instrument.name] = instrument
            return instrument

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._register(Counter(name, doc))

    def gauge(self, name: str, doc: str = "") -> Gauge:
        return self._register(Gauge(name, doc))

    def histogram_family(self, name: str, doc: str = "", buckets=None,
                         max_labels: int = 256) -> HistogramFamily:
        return self._register(HistogramFamily(name, doc, buckets, max_labels))

    def register_collector(self, section: str, fn: Callable[[], dict]) -> None:
        """A read-through section: ``fn()`` runs at every snapshot and its
        dict lands under ``section``."""
        with self._lock:
            self._collectors[section] = fn

    def snapshot(self) -> dict:
        """{section: dict} for every section, plus ``"instruments"`` for the
        owned instruments."""
        with self._lock:
            collectors = dict(self._collectors)
            instruments = dict(self._instruments)
        out: Dict[str, Any] = {section: fn() for section, fn in collectors.items()}
        out["instruments"] = {name: inst.snapshot() for name, inst in instruments.items()}
        return out

    def render_text(self) -> str:
        """Prometheus-style text: the scalar fields of every section (a list
        or dict by its length) and the owned instruments."""
        lines: List[str] = []

        def emit(name: str, value, doc: str = "") -> None:
            if doc:
                lines.append(f"# HELP {name} {doc}")
            lines.append(f"{name} {value}")

        def emit_hist(metric: str, doc: str, s: dict) -> None:
            if doc:
                lines.append(f"# HELP {metric} {doc}")
            emit(f"{metric}_count", s["count"])
            emit(f"{metric}_sum", s["sum"])
            for q in ("p50", "p95", "p99"):
                if s[q] is not None:
                    emit(f'{metric}{{quantile="{q}"}}', s[q])

        snap = self.snapshot()
        for section, fields in sorted(snap.items()):
            if section == "instruments":
                continue
            for key, value in sorted(fields.items(), key=lambda kv: str(kv[0])):
                metric = f"deequ_tpu_torch_{section}_{key}"
                if isinstance(value, bool):
                    emit(metric, int(value))
                elif isinstance(value, (int, float)):
                    emit(metric, value)
                elif isinstance(value, (list, dict)):
                    emit(f"{metric}_len", len(value))
                elif value is not None:
                    emit(f'{metric}{{value="{value}"}}', 1)
        with self._lock:
            instruments = dict(self._instruments)
        for name, inst in sorted(instruments.items()):
            metric = f"deequ_tpu_torch_{name}"
            if isinstance(inst, (Counter, Gauge)):
                emit(metric, inst.snapshot(), inst.doc)
            elif isinstance(inst, Histogram):
                emit_hist(metric, inst.doc, inst.snapshot())
            elif isinstance(inst, HistogramFamily):
                emit_hist(metric, inst.doc, inst.aggregate.snapshot())
                emit(f"{metric}_labels", len(inst.labels()))
        return "\n".join(lines) + "\n"

    def reset_instruments(self) -> None:
        """Reset the owned instruments. The read-through sections belong to
        their singletons (``deequ_tpu_torch.reset_execution_report()``
        resets both)."""
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst.reset()


#: the process-wide registry
REGISTRY = MetricsRegistry()


# -- the engine's read-through sections (imports inside: the registry
#    loads before the engine, and a section must not make an import cycle) --


def _scan_section() -> dict:
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return SCAN_STATS.snapshot()


def _retry_section() -> dict:
    from deequ_tpu_torch.resilience.retry import RETRY_TELEMETRY

    return RETRY_TELEMETRY.snapshot()


def _hbm_section() -> dict:
    """The device residency of persisted tables: bytes and tables on every
    device (``scan_engine.total_resident_bytes``)."""
    from deequ_tpu_torch.ops.scan_engine import _ACTIVE_CACHES, total_resident_bytes

    return {"resident_bytes": total_resident_bytes(),
            "resident_tables": len(_ACTIVE_CACHES)}


def _env_section() -> dict:
    from deequ_tpu_torch.envcfg import registry_snapshot

    return {name: row.get("value", row.get("error"))
            for name, row in registry_snapshot().items()}


def _repository_section() -> dict:
    """The columnar repository's and the quality monitor's counters, once
    their modules are imported (a process that never touched them reports
    ``active: False``, not zeros)."""
    import sys

    out: Dict[str, Any] = {"active": False}
    columnar = sys.modules.get("deequ_tpu_torch.repository.columnar")
    if columnar is not None:
        out["active"] = True
        out.update(columnar.REPO_STATS.snapshot())
    monitor = sys.modules.get("deequ_tpu_torch.repository.monitor")
    if monitor is not None:
        out["active"] = True
        out.update(monitor.MONITOR_STATS.snapshot())
    return out


def _switch(name: str):
    """A switch's value, or its error as a string: a scrape reports a bad
    switch and never dies on it (the engine still raises at its own
    read)."""
    from deequ_tpu_torch.envcfg import env_value
    from deequ_tpu_torch.exceptions import EnvConfigError

    try:
        return env_value(name)
    except EnvConfigError as e:
        return f"error: {e}"


def _kernels_section() -> dict:
    """The histogram census by variant (``ScanStats``) and the forced
    variant (``DEEQU_TORCH_HIST_VARIANT``)."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return {
        "hist_scatter_dispatches": SCAN_STATS.hist_scatter_dispatches,
        "hist_onehot_dispatches": SCAN_STATS.hist_onehot_dispatches,
        "hist_pallas_dispatches": SCAN_STATS.hist_pallas_dispatches,
        "hist_variant_forced": _switch("DEEQU_TORCH_HIST_VARIANT"),
    }


def _planner_section() -> dict:
    """The plan optimizer's census: fused grouping passes, sub-plan cache
    hits, and the fusion switch as resolved."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return {
        "fused_group_passes": SCAN_STATS.fused_group_passes,
        "subplan_cache_hits": SCAN_STATS.subplan_cache_hits,
        "plan_fusion": _switch("DEEQU_TORCH_PLAN_FUSION"),
    }


REGISTRY.register_collector("scan", _scan_section)
REGISTRY.register_collector("retry", _retry_section)
REGISTRY.register_collector("hbm", _hbm_section)
REGISTRY.register_collector("env", _env_section)
REGISTRY.register_collector("repository", _repository_section)
REGISTRY.register_collector("kernels", _kernels_section)
REGISTRY.register_collector("planner", _planner_section)


# -- the serving layer's instruments (always on: one observation a resolved
#    future) ---------------------------------------------------------------------

SERVE_LATENCY = REGISTRY.histogram_family(
    "serve_latency_seconds", "per-tenant submit->resolve latency (serve/service.py)",
)
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "serve_queue_depth", "pending requests at the last submit or batch take",
)
SERVE_SUBMITTED = REGISTRY.counter("serve_suites_submitted", "suites accepted by submit()")
SERVE_RESOLVED = REGISTRY.counter("serve_suites_resolved", "futures resolved with a result")
SERVE_REJECTED = REGISTRY.counter("serve_suites_rejected", "futures rejected with a typed error")

#: the admission tier's instruments by SLO class (serve/admission.py)
_SLO_CLASSES = ("critical", "standard", "best_effort")
SERVE_ADMITTED_BY_CLASS = {
    cls: REGISTRY.counter(f"serve_admitted_{cls}",
                          f"{cls}-class submissions the admission controller accepted")
    for cls in _SLO_CLASSES
}
SERVE_ADMISSION_REJECTED_BY_CLASS = {
    cls: REGISTRY.counter(f"serve_admission_rejected_{cls}",
                          f"{cls}-class submissions refused typed at admission (queue "
                          "full, class budget, brownout, inflight cap)")
    for cls in _SLO_CLASSES
}
SERVE_SHED_BY_CLASS = {
    cls: REGISTRY.counter(f"serve_shed_{cls}",
                          f"accepted {cls}-class requests shed typed before dispatch "
                          "(in-queue deadline expiry)")
    for cls in _SLO_CLASSES
}
SERVE_BROWNOUT_LEVEL = REGISTRY.gauge(
    "serve_brownout_level",
    "brownout level of the latest transition of any service (0 healthy, 1 sheds "
    "best_effort admissions, 2 also caps each tenant's queued requests, 3 admits "
    "critical only)",
)


def _serve_section() -> dict:
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    tenants = SCAN_STATS.coalesced_tenants
    padded = SCAN_STATS.coalesce_padded_slots
    return {
        "submitted": SERVE_SUBMITTED.value,
        "resolved": SERVE_RESOLVED.value,
        "rejected": SERVE_REJECTED.value,
        "queue_depth": SERVE_QUEUE_DEPTH.snapshot(),
        "coalesce_occupancy": round(tenants / max(tenants + padded, 1), 4),
        "latency": SERVE_LATENCY.aggregate.snapshot(),
        "latency_tenants": len(SERVE_LATENCY.labels()),
        "brownout_level": SERVE_BROWNOUT_LEVEL.snapshot(),
        "admitted_by_class": {cls: c.value for cls, c in SERVE_ADMITTED_BY_CLASS.items()},
        "admission_rejected_by_class": {
            cls: c.value for cls, c in SERVE_ADMISSION_REJECTED_BY_CLASS.items()},
        "shed_by_class": {cls: c.value for cls, c in SERVE_SHED_BY_CLASS.items()},
    }


REGISTRY.register_collector("serve", _serve_section)


# -- the fleet's instruments (serve/fleet.py, serve/ledger.py; the "fleet"
#    section, read through the active fleet, is registered by serve/fleet.py) --

FLEET_FAILOVERS = REGISTRY.counter(
    "fleet_failovers", "worker-loss failovers of a VerificationFleet (one a lost worker)")
FLEET_WORKERS_ALIVE = REGISTRY.gauge(
    "fleet_workers_alive", "alive workers of the active VerificationFleet")
LEDGER_APPENDS = REGISTRY.counter(
    "fleet_ledger_appends",
    "durable request-ledger frames appended (serve/ledger.py: one an accept, one "
    "tombstone a resolution, each fsynced before the submit or resolution goes on)")
