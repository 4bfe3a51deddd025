"""deequ_tpu_torch — data-quality verification on PyTorch and CUDA.

The port of ``deequ_tpu`` (JAX on a TPU) to an NVIDIA H100. It keeps the
reference's module paths and names, so the counterpart of
``deequ_tpu/ops/segment.py`` is ``deequ_tpu_torch/ops/segment.py``. It
imports ``torch`` and numpy, never ``jax`` and nothing of ``deequ_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU, with
``use_device("cpu")`` or a ``device=`` argument; without a CUDA device
and without that request they raise ``DeviceUnavailableException``. The
device computes in native float64. Over a mesh of members
(``parallel/``: the default mesh of a machine with several cards, or one
a caller asks for with ``use_mesh``) every scan and dense grouping count
is row-sharded, and several processes can split a table by row ranges
and merge their states (``parallel/distributed.py``).

The port carries ``VerificationSuite.run`` over an in-memory
``ColumnarTable``: the scan analyzers (Size, Completeness, Compliance,
Minimum, Maximum, Mean, Sum, StandardDeviation, Correlation), the string
analyzers (PatternMatch, MinLength, MaxLength, DataType, each a lookup
table over the dictionary built once per distinct value, the lengths and
type classes by the native C++ batch of ``native/``) and the sketch
analyzers (ApproxCountDistinct, whose registers come from the hand-written
CUDA kernel of ``csrc/hll.cu``; KLLSketch, ApproxQuantile,
ApproxQuantiles, sorted a chunk at a time on the device) fused into one
pass; the grouping analyzers (Uniqueness, UniqueValueRatio, Distinctness,
CountDistinct, Entropy, MutualInformation) and Histogram, whose dense
counts run the hand-written CUDA histogram of ``csrc/bincount.cu``. Every
in-memory ``Check`` method but the anomaly check is carried.

Analyzer states persist and merge (``states/``: the reference's state
format byte for byte, in-memory and filesystem providers;
``aggregate_with``/``save_states_with`` on every run,
``run_on_aggregated_states``), and ``IncrementalVerificationStream`` runs
deequ's incremental workflow over arriving batches.

Around the runs: the column profiler (``profiles/``), constraint
suggestion (``suggestions/``), row-level schemas (``schema/``),
applicability (``applicability.py``), distribution distances
(``analyzers/distance.py``), the table readers (``data/io.py``) and the
import of deequ's own repository JSON and states (``interop/``).

Out of core: a ``StreamingTable`` (``data/streaming.py``; ``stream_table``
over an in-memory table, ``data/io.py``'s ``stream_parquet`` and
``stream_csv`` over files, any ``data/source.py`` BatchSource) runs
through ``VerificationSuite``, ``AnalysisRunner``, the incremental stream
and ``ColumnProfiler`` a batch at a time, never holding the table: the
fused scan streams its chunks through the same kernels, and every other
analyzer folds its state a batch.

Faults and governance: a fused scan survives an OOM of the card by
evicting residency, demoting an encoded layout and bisecting its chunk
(``ops/scan_executors.py``); a watchdog (``device_deadline``) turns a hung
call into ``DeviceHangException``; a lost device or a kernel that will
not build fails the scan's analyzers typed, and ``on_device_error=
"fallback"`` — where the reference re-runs on its CPU — raises
``DeviceFallbackRefusedException``. One run budget
(``with_run_budget``, ``resilience/governance.py``) bounds every rung of a
run, and its exhaustion degrades to a partial result with exact
``unverified_row_ranges``. :func:`scan_execution_report` is the engine's
counters as one flat dict.

Serving and observability: ``serve.VerificationService`` takes many small
suites from many tenants (``submit`` returns a future) and runs the suites
of one plan as one coalesced dispatch on the card — one copy, one K1
batch, one fold merge and one fetch a batch — with admission control, SLO
classes, fault isolation by bisection and kill-and-resume. The flight
recorder (``obs/``: ``with_tracing()``, ``DEEQU_TORCH_TRACE=1``) records
the engine's seams as spans and events, exported as a Perfetto trace, and
:func:`execution_report` reads every counter of the engine through one
registry.
"""

from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.constraints import ConstrainableDataTypes
from deequ_tpu_torch.data.streaming import StreamingTable, stream_table
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.device import use_device
from deequ_tpu_torch.exceptions import (
    DeviceCompileException,
    DeviceException,
    DeviceFallbackRefusedException,
    DeviceHangException,
    DeviceLostException,
    DeviceOOMException,
    DeviceUnavailableException,
    MeshDegradedException,
    NotYetPortedException,
    PeerLostException,
    RunBudgetExhaustedException,
)
from deequ_tpu_torch.metrics import DoubleMetric, Entity, HistogramMetric, Metric
from deequ_tpu_torch.verification import (
    IncrementalVerificationStream,
    VerificationResult,
    VerificationSuite,
)

from deequ_tpu_torch.resilience.governance import (
    RunBudget,
    RunPolicy,
    fault_state_scope,
    run_budget_scope,
)

__version__ = "0.1.0"


def execution_report() -> dict:
    """The whole engine in one dict: the unified registry's snapshot
    (``obs/registry.py``). Sections: ``"scan"`` (:func:`scan_execution_report`),
    ``"retry"``, ``"hbm"`` (the residency of persisted tables), ``"env"``
    (the ``DEEQU_TORCH_*`` switches as resolved), ``"repository"``,
    ``"kernels"``, ``"planner"``, ``"serve"`` (queue depth, latency,
    admissions, sheds, brownout) and ``"instruments"`` (the registry's own
    counters, gauges and histograms)."""
    from deequ_tpu_torch.obs.registry import REGISTRY

    return REGISTRY.snapshot()


def scan_execution_report() -> dict:
    """The scan engine's counters (``ops/scan_engine.py:ScanStats``) as one
    flat dict, read under its lock: passes, fetches, the device fault
    counters (``device_faults``, ``oom_bisections``, ``bisection_depth``,
    ``watchdog_timeouts``, ``fallback_refused``), copies of
    ``degradation_events`` and ``unverified_row_ranges`` (a demoted fused
    grouping dispatch among them: ``fusion_demote``), the budget's
    charges, ``fused_group_passes``, the serving counters. It is
    ``execution_report()["scan"]``."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    return SCAN_STATS.snapshot()


def execution_report_text() -> str:
    """:func:`execution_report` as Prometheus-style text."""
    from deequ_tpu_torch.obs.registry import REGISTRY

    return REGISTRY.render_text()


def reset_execution_report() -> None:
    """Zero the scan engine's counters and the registry's instruments."""
    from deequ_tpu_torch.obs.registry import REGISTRY
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    SCAN_STATS.reset()
    REGISTRY.reset_instruments()


__all__ = [
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnarTable",
    "ConstrainableDataTypes",
    "DeviceCompileException",
    "DeviceException",
    "DeviceFallbackRefusedException",
    "DeviceHangException",
    "DeviceLostException",
    "DeviceOOMException",
    "DeviceUnavailableException",
    "DoubleMetric",
    "Entity",
    "HistogramMetric",
    "IncrementalVerificationStream",
    "MeshDegradedException",
    "Metric",
    "NotYetPortedException",
    "PeerLostException",
    "RunBudget",
    "RunBudgetExhaustedException",
    "RunPolicy",
    "StreamingTable",
    "VerificationResult",
    "VerificationSuite",
    "execution_report",
    "execution_report_text",
    "fault_state_scope",
    "reset_execution_report",
    "run_budget_scope",
    "scan_execution_report",
    "stream_table",
    "use_device",
]
