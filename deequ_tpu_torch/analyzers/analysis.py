"""Analysis — an ordered bag of analyzers (reference analyzers/Analysis.
scala:29-63, deprecated there in favour of AnalysisRunBuilder; the port's
copy of ``deequ_tpu/analyzers/analysis.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.data.table import ColumnarTable


@dataclass(frozen=True)
class Analysis:
    analyzers: tuple = ()

    def add_analyzer(self, analyzer: Analyzer) -> "Analysis":
        return Analysis(self.analyzers + (analyzer,))

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "Analysis":
        return Analysis(self.analyzers + tuple(analyzers))

    def run(self, data: ColumnarTable, aggregate_with=None, save_states_with=None,
            device=None):
        """Compute the metrics (AnalysisRunner.do_analysis_run)."""
        from deequ_tpu_torch.analyzers.runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(
            data, list(self.analyzers), device,
            aggregate_with=aggregate_with, save_states_with=save_states_with,
        )
