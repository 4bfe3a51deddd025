"""VerificationSuite — the flagship entry point (reference layer L7,
VerificationSuite.scala, VerificationRunBuilder.scala,
VerificationResult.scala; the counterpart of ``deequ_tpu/verification.py``).

    result = (VerificationSuite.on_data(table)
              .add_check(Check(CheckLevel.ERROR, "tests")
                         .is_complete("id")
                         .has_size(lambda n: n >= 100))
              .run())

The run executes on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` here, or the ``deequ_tpu_torch.use_device`` scope); with
no CUDA device and no such request, ``run()`` raises
``DeviceUnavailableException``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
from deequ_tpu_torch.checks import Check, CheckResult, CheckStatus
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.device import resolve_device
from deequ_tpu_torch.metrics import Metric


@dataclass
class VerificationResult:
    """(reference VerificationResult.scala:33-119)

    ``device`` names the device the run executed on; ``scan_stats`` holds
    the run's deltas of the engine counters (``scan_passes``,
    ``device_fetches``, ``bytes_fetched``, ``grouping_passes``,
    ``hist_kernel_dispatches``, ``hist_plain_dispatches``,
    ``hist_host_dispatches``): the observable for the one-fetch-per-scan
    contract and for the dense grouping counts going through the kernel."""

    status: CheckStatus
    check_results: Dict[Check, CheckResult]
    metrics: Dict[Analyzer, Metric]
    device: str = ""
    scan_stats: Dict[str, object] = field(default_factory=dict)

    @staticmethod
    def check_results_as_rows(result: "VerificationResult") -> List[dict]:
        rows = []
        for check, check_result in result.check_results.items():
            for cr in check_result.constraint_results:
                rows.append(
                    {
                        "check": check.description,
                        "check_level": check.level.value,
                        "check_status": check_result.status.value,
                        "constraint": str(cr.constraint),
                        "constraint_status": cr.status.value,
                        "constraint_message": cr.message or "",
                    }
                )
        return rows


_STAT_KEYS = (
    "scan_passes",
    "device_fetches",
    "bytes_fetched",
    "grouping_passes",
    "hist_kernel_dispatches",
    "hist_plain_dispatches",
    "hist_host_dispatches",
)


def _dedup_analyzers(analyzers: Sequence[Analyzer]) -> List[Analyzer]:
    """Order-preserving de-dup (reference unions into a Set)."""
    seen = set()
    unique = []
    for a in analyzers:
        if a not in seen:
            seen.add(a)
            unique.append(a)
    return unique


class VerificationSuite:
    """(reference VerificationSuite.scala:49-315)"""

    @staticmethod
    def on_data(data: ColumnarTable, device=None) -> "VerificationRunBuilder":
        return VerificationRunBuilder(data, device)

    @staticmethod
    def run(
        data: ColumnarTable,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device=None,
    ) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            data, checks, required_analyzers, device
        )

    @staticmethod
    def do_verification_run(
        data: ColumnarTable,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device=None,
    ) -> VerificationResult:
        from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

        dev = resolve_device(device)
        analyzers = list(required_analyzers)
        for check in checks:
            analyzers.extend(check.required_analyzers())
        before = {k: getattr(SCAN_STATS, k) for k in _STAT_KEYS}
        context = AnalysisRunner.do_analysis_run(
            data, _dedup_analyzers(analyzers), device=dev
        )
        result = VerificationSuite._evaluate(checks, context)
        result.device = str(dev)
        result.scan_stats = {
            k: getattr(SCAN_STATS, k) - v for k, v in before.items()
        }
        return result

    @staticmethod
    def _evaluate(
        checks: Sequence[Check], analysis_context: AnalyzerContext
    ) -> VerificationResult:
        """(reference VerificationSuite.scala:263-281)"""
        check_results = {c: c.evaluate(analysis_context) for c in checks}
        if not check_results:
            status = CheckStatus.SUCCESS
        else:
            status = max(
                (r.status for r in check_results.values()),
                key=lambda s: s.severity,
            )
        return VerificationResult(
            status, check_results, dict(analysis_context.metric_map)
        )


class VerificationRunBuilder:
    """Fluent configuration (reference VerificationRunBuilder.scala:28-182)."""

    def __init__(self, data: ColumnarTable, device=None):
        self._data = data
        self._device = device
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self._checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self._checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self._required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers) -> "VerificationRunBuilder":
        self._required_analyzers.extend(analyzers)
        return self

    def run(self) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            self._data, self._checks, self._required_analyzers, self._device
        )
