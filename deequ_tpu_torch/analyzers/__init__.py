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
    FrequenciesAndNumRows,
    FrequencyBasedAnalyzer,
    Histogram,
    MutualInformation,
    UniqueValueRatio,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.scan import (
    Completeness,
    Compliance,
    Correlation,
    DataType,
    DataTypeInstances,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    Patterns,
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
    DataTypeHistogram,
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
    "SumState", "StandardDeviationState", "CorrelationState", "DataTypeHistogram",
    "Size", "Completeness", "Compliance", "Minimum", "Maximum", "Mean", "Sum",
    "StandardDeviation", "Correlation", "PatternMatch", "Patterns", "MinLength",
    "MaxLength", "DataType", "DataTypeInstances",
    "FrequencyBasedAnalyzer", "FrequenciesAndNumRows", "Uniqueness",
    "UniqueValueRatio", "Distinctness", "CountDistinct", "Entropy",
    "MutualInformation", "Histogram",
    "ApproxCountDistinct", "ApproxCountDistinctState", "ApproxQuantile",
    "ApproxQuantiles", "KLLParameters", "KLLSketch", "KLLState",
]
