"""Constraints (reference layer L6, constraints/Constraint.scala,
constraints/AnalysisBasedConstraint.scala).

A constraint binds an analyzer to an assertion over the resulting metric
value (optionally through a value picker). Evaluation distinguishes
missing-analysis, metric-failure, picker-failure, and assertion-failure —
all reported as data, never raised.

The factories below cover the analyzers the port carries, the anomaly
constraint over a metrics repository's history included.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.metrics import Distribution, Metric


class ConstraintStatus(enum.Enum):
    SUCCESS = "Success"
    FAILURE = "Failure"


@dataclass
class ConstraintResult:
    constraint: "Constraint"
    status: ConstraintStatus
    message: Optional[str] = None
    metric: Optional[Metric] = None


class Constraint:
    """Evaluatable on a map of analyzer -> metric."""

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        raise NotImplementedError


class ConstraintDecorator(Constraint):
    def __init__(self, inner: Constraint):
        self._inner = inner

    @property
    def inner(self) -> Constraint:
        c = self._inner
        while isinstance(c, ConstraintDecorator):
            c = c._inner
        return c

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        result = self._inner.evaluate(analysis_results)
        result.constraint = self
        return result


class NamedConstraint(ConstraintDecorator):
    """Wraps a constraint to change its display name
    (reference constraints/Constraint.scala:41-69)."""

    def __init__(self, constraint: Constraint, name: str):
        super().__init__(constraint)
        self._name = name

    def __repr__(self) -> str:
        return self._name

    def __str__(self) -> str:
        return self._name


MISSING_ANALYSIS_MESSAGE = "Missing Analysis, can't run the constraint!"
PROBLEMATIC_METRIC_PICKER = "Can't retrieve the value to assert on"
ASSERTION_EXCEPTION = "Can't execute the assertion"


class AnalysisBasedConstraint(Constraint):
    """Constraint over one analyzer's metric
    (reference constraints/AnalysisBasedConstraint.scala:42-122)."""

    def __init__(
        self,
        analyzer: Analyzer,
        assertion: Callable,
        value_picker: Optional[Callable] = None,
        hint: Optional[str] = None,
    ):
        self.analyzer = analyzer
        self.assertion = assertion
        self.value_picker = value_picker
        self.hint = hint

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        metric = analysis_results.get(self.analyzer)
        if metric is None:
            return ConstraintResult(
                self, ConstraintStatus.FAILURE, MISSING_ANALYSIS_MESSAGE, None
            )
        return self._pick_value_and_assert(metric)

    def _pick_value_and_assert(self, metric: Metric) -> ConstraintResult:
        if metric.value.is_failure:
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"Metric computation failed: {metric.value.exception}",
                metric,
            )
        raw = metric.value.get()
        try:
            value = self.value_picker(raw) if self.value_picker else raw
        except Exception as e:  # noqa: BLE001
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{PROBLEMATIC_METRIC_PICKER}: {e}!",
                metric,
            )
        try:
            holds = self.assertion(value)
        except Exception as e:  # noqa: BLE001
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{ASSERTION_EXCEPTION}: {e}!",
                metric,
            )
        if holds:
            return ConstraintResult(self, ConstraintStatus.SUCCESS, None, metric)
        hint = f" {self.hint}" if self.hint else ""
        return ConstraintResult(
            self,
            ConstraintStatus.FAILURE,
            f"Value: {value} does not meet the constraint requirement!{hint}",
            metric,
        )

    def __repr__(self) -> str:
        return f"AnalysisBasedConstraint({self.analyzer!r})"


class ConstrainableDataTypes(enum.Enum):
    """(reference constraints/ConstrainableDataTypes.scala:19)"""

    NULL = "Null"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"
    NUMERIC = "Numeric"


# -- factory helpers (reference constraints/Constraint.scala:75-682) --------


def _named(constraint: Constraint, name: str) -> NamedConstraint:
    return NamedConstraint(constraint, name)


def size_constraint(assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Size

    analyzer = Size(where=where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"SizeConstraint({analyzer!r})",
    )


def completeness_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Completeness

    analyzer = Completeness(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"CompletenessConstraint({analyzer!r})",
    )


def uniqueness_constraint(columns, assertion, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Uniqueness

    analyzer = Uniqueness(columns)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"UniquenessConstraint({analyzer!r})",
    )


def distinctness_constraint(columns, assertion, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Distinctness

    analyzer = Distinctness(columns)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"DistinctnessConstraint({analyzer!r})",
    )


def unique_value_ratio_constraint(columns, assertion, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import UniqueValueRatio

    analyzer = UniqueValueRatio(columns)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"UniqueValueRatioConstraint({analyzer!r})",
    )


def compliance_constraint(name, predicate, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Compliance

    analyzer = Compliance(name, predicate, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"ComplianceConstraint({analyzer!r})",
    )


def entropy_constraint(column, assertion, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Entropy

    analyzer = Entropy(column)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"EntropyConstraint({analyzer!r})",
    )


def min_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Minimum

    analyzer = Minimum(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MinimumConstraint({analyzer!r})",
    )


def max_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Maximum

    analyzer = Maximum(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MaximumConstraint({analyzer!r})",
    )


def mean_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Mean

    analyzer = Mean(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MeanConstraint({analyzer!r})",
    )


def sum_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import Sum

    analyzer = Sum(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"SumConstraint({analyzer!r})",
    )


def standard_deviation_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import StandardDeviation

    analyzer = StandardDeviation(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"StandardDeviationConstraint({analyzer!r})",
    )


def correlation_constraint(
    column_a, column_b, assertion, where=None, hint=None
) -> Constraint:
    from deequ_tpu_torch.analyzers import Correlation

    analyzer = Correlation(column_a, column_b, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"CorrelationConstraint({analyzer!r})",
    )


def approx_count_distinct_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import ApproxCountDistinct

    analyzer = ApproxCountDistinct(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"ApproxCountDistinctConstraint({analyzer!r})",
    )


def approx_quantile_constraint(
    column, quantile, assertion, relative_error=0.01, where=None, hint=None
) -> Constraint:
    from deequ_tpu_torch.analyzers import ApproxQuantile

    analyzer = ApproxQuantile(column, quantile, relative_error, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"ApproxQuantileConstraint({analyzer!r})",
    )


def kll_constraint(column, assertion, kll_parameters=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import KLLSketch

    analyzer = KLLSketch(column, kll_parameters)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"kllSketchConstraint({analyzer!r})",
    )


def pattern_match_constraint(
    column, pattern, assertion, where=None, name=None, hint=None
) -> Constraint:
    from deequ_tpu_torch.analyzers import PatternMatch

    analyzer = PatternMatch(column, pattern, where)
    display = name or f"PatternMatchConstraint({analyzer!r})"
    return _named(AnalysisBasedConstraint(analyzer, assertion, hint=hint), display)


def mutual_information_constraint(column_a, column_b, assertion, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import MutualInformation

    analyzer = MutualInformation(column_a, column_b)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MutualInformationConstraint({analyzer!r})",
    )


def histogram_constraint(
    column, assertion, binning_udf=None, max_bins=None, hint=None
) -> Constraint:
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.grouping import MAXIMUM_ALLOWED_DETAIL_BINS

    analyzer = Histogram(column, binning_udf, max_bins or MAXIMUM_ALLOWED_DETAIL_BINS)
    return _named(
        AnalysisBasedConstraint(
            analyzer, assertion, value_picker=lambda d: d, hint=hint
        ),
        f"HistogramConstraint({analyzer!r})",
    )


def histogram_bin_constraint(
    column, assertion, binning_udf=None, max_bins=None, hint=None
) -> Constraint:
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.grouping import MAXIMUM_ALLOWED_DETAIL_BINS

    analyzer = Histogram(column, binning_udf, max_bins or MAXIMUM_ALLOWED_DETAIL_BINS)
    return _named(
        AnalysisBasedConstraint(
            analyzer,
            assertion,
            value_picker=lambda d: float(d.number_of_bins),
            hint=hint,
        ),
        f"HistogramBinConstraint({analyzer!r})",
    )


def max_length_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import MaxLength

    analyzer = MaxLength(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MaxLengthConstraint({analyzer!r})",
    )


def min_length_constraint(column, assertion, where=None, hint=None) -> Constraint:
    from deequ_tpu_torch.analyzers import MinLength

    analyzer = MinLength(column, where)
    return _named(
        AnalysisBasedConstraint(analyzer, assertion, hint=hint),
        f"MinLengthConstraint({analyzer!r})",
    )


def data_type_constraint(
    column, data_type: ConstrainableDataTypes, assertion, where=None, hint=None
) -> Constraint:
    """Ratio of values matching the required type (reference
    Constraint.scala:592-681; picker logic at ratioTypes)."""
    from deequ_tpu_torch.analyzers import DataType
    from deequ_tpu_torch.analyzers.scan import DataTypeInstances

    def ratio_types(ignore_unknown: bool, key: DataTypeInstances, dist: Distribution) -> float:
        if ignore_unknown:
            dv = dist.values.get(key.value)
            absolute = dv.absolute if dv else 0
            if absolute == 0:
                return 0.0
            num_values = sum(v.absolute for v in dist.values.values())
            unknown = dist.values.get(DataTypeInstances.UNKNOWN.value)
            num_unknown = unknown.absolute if unknown else 0
            denominator = num_values - num_unknown
            return absolute / denominator if denominator else 0.0
        dv = dist.values.get(key.value)
        return dv.ratio if dv else 0.0

    pickers = {
        ConstrainableDataTypes.NULL: lambda d: ratio_types(
            False, DataTypeInstances.UNKNOWN, d
        ),
        ConstrainableDataTypes.FRACTIONAL: lambda d: ratio_types(
            True, DataTypeInstances.FRACTIONAL, d
        ),
        ConstrainableDataTypes.INTEGRAL: lambda d: ratio_types(
            True, DataTypeInstances.INTEGRAL, d
        ),
        ConstrainableDataTypes.BOOLEAN: lambda d: ratio_types(
            True, DataTypeInstances.BOOLEAN, d
        ),
        ConstrainableDataTypes.STRING: lambda d: ratio_types(
            True, DataTypeInstances.STRING, d
        ),
        ConstrainableDataTypes.NUMERIC: lambda d: (
            ratio_types(True, DataTypeInstances.FRACTIONAL, d)
            + ratio_types(True, DataTypeInstances.INTEGRAL, d)
        ),
    }

    analyzer = DataType(column, where)
    return _named(
        AnalysisBasedConstraint(
            analyzer, assertion, value_picker=pickers[data_type], hint=hint
        ),
        f"DataTypeConstraint({analyzer!r})",
    )


def anomaly_constraint(analyzer, anomaly_assertion, hint=None) -> Constraint:
    """Constraint whose assertion closes over a repository history
    (reference Constraint.scala anomalyConstraint)."""
    return _named(
        AnalysisBasedConstraint(analyzer, anomaly_assertion, hint=hint),
        f"AnomalyConstraint({analyzer!r})",
    )
