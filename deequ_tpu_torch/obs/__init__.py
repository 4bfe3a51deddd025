"""deequ_tpu_torch.obs — the run flight recorder and the unified metrics
registry (the counterpart of ``deequ_tpu/obs``).

- :mod:`~deequ_tpu_torch.obs.recorder` — typed span and event records at
  the engine's seams, ring-bounded, off by default; armed by
  ``do_verification_run(trace=...)`` / ``with_tracing()``,
  ``VerificationService(trace=...)`` or ``DEEQU_TORCH_TRACE=1``;
- :mod:`~deequ_tpu_torch.obs.export` — Chrome-trace / Perfetto JSON of a
  recording;
- :mod:`~deequ_tpu_torch.obs.registry` — counters, gauges and histograms
  with read-through sections over the engine's singletons, scraped whole
  by ``deequ_tpu_torch.execution_report()``.
"""

from deequ_tpu_torch.obs.export import to_chrome_trace, write_chrome_trace
from deequ_tpu_torch.obs.recorder import (
    DEFAULT_CAPACITY,
    FlightRecorder,
    SpanRecord,
    current_recorder,
    global_recorder,
    install_global_recorder,
    maybe_arm_from_env,
    recording_scope,
    resolve_recorder,
)
from deequ_tpu_torch.obs.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    HistogramFamily,
    MetricsRegistry,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "SpanRecord",
    "current_recorder",
    "global_recorder",
    "install_global_recorder",
    "maybe_arm_from_env",
    "recording_scope",
    "resolve_recorder",
    "to_chrome_trace",
    "write_chrome_trace",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramFamily",
    "MetricsRegistry",
]
