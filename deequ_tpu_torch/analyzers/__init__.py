from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    DoubleValuedState,
    ScanShareableAnalyzer,
    State,
)
from deequ_tpu_torch.analyzers.grouping import (
    CountDistinct,
    Distinctness,
    Entropy,
    FrequencyBasedAnalyzer,
    UniqueValueRatio,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.scan import (
    Completeness,
    Compliance,
    Correlation,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.sketches import (
    ApproxCountDistinct,
    ApproxCountDistinctState,
    ApproxQuantile,
    ApproxQuantiles,
    KLLParameters,
    KLLSketch,
    KLLState,
)
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    SumState,
)

__all__ = [
    "Analyzer", "ScanShareableAnalyzer", "State", "DoubleValuedState",
    "NumMatches", "NumMatchesAndCount", "MinState", "MaxState", "MeanState",
    "SumState", "StandardDeviationState", "CorrelationState",
    "Size", "Completeness", "Compliance", "Minimum", "Maximum", "Mean", "Sum",
    "StandardDeviation", "Correlation",
    "FrequencyBasedAnalyzer", "Uniqueness", "UniqueValueRatio", "Distinctness",
    "CountDistinct", "Entropy",
    "ApproxCountDistinct", "ApproxCountDistinctState", "ApproxQuantile",
    "ApproxQuantiles", "KLLParameters", "KLLSketch", "KLLState",
]
