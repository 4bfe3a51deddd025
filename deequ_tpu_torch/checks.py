"""The fluent Check DSL (reference checks/Check.scala, 1056 LoC).

A Check is an immutable list of constraints with a severity level; every
fluent method returns a new Check. Methods that accept a ``where`` filter
return a CheckWithLastConstraintFilterable whose ``.where(...)`` rebuilds the
last-added constraint with the filter
(reference checks/CheckWithLastConstraintFilterable.scala:22-53).

The one method whose machinery the port does not carry yet, the anomaly
check (it needs a metrics repository), raises NotYetPortedException when
the check is built.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.scan import Patterns
from deequ_tpu_torch.constraints import (
    AnalysisBasedConstraint,
    ConstrainableDataTypes,
    Constraint,
    ConstraintDecorator,
    ConstraintResult,
    ConstraintStatus,
    approx_count_distinct_constraint,
    approx_quantile_constraint,
    completeness_constraint,
    compliance_constraint,
    correlation_constraint,
    data_type_constraint,
    distinctness_constraint,
    entropy_constraint,
    histogram_bin_constraint,
    histogram_constraint,
    kll_constraint,
    max_constraint,
    max_length_constraint,
    mean_constraint,
    min_constraint,
    min_length_constraint,
    mutual_information_constraint,
    pattern_match_constraint,
    size_constraint,
    standard_deviation_constraint,
    sum_constraint,
    unique_value_ratio_constraint,
    uniqueness_constraint,
)
from deequ_tpu_torch.exceptions import NotYetPortedException
from deequ_tpu_torch.metrics import Metric


class CheckLevel(enum.Enum):
    ERROR = "Error"
    WARNING = "Warning"


class CheckStatus(enum.Enum):
    SUCCESS = "Success"
    WARNING = "Warning"
    ERROR = "Error"

    @property
    def severity(self) -> int:
        return {"Success": 0, "Warning": 1, "Error": 2}[self.value]


@dataclass
class CheckResult:
    check: "Check"
    status: CheckStatus
    constraint_results: List[ConstraintResult] = field(default_factory=list)


IsOne: Callable[[float], bool] = lambda v: v == 1.0  # noqa: E731


def _columns_tuple(columns) -> Tuple[str, ...]:
    return (columns,) if isinstance(columns, str) else tuple(columns)


class Check:
    """A named group of constraints with an assertion level
    (reference checks/Check.scala:60-63)."""

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: Tuple[Constraint, ...] = (),
    ):
        self.level = level
        self.description = description
        self.constraints: Tuple[Constraint, ...] = tuple(constraints)

    # -- plumbing -----------------------------------------------------------

    def add_constraint(self, constraint: Constraint) -> "Check":
        return Check(self.level, self.description, self.constraints + (constraint,))

    def _add_filterable(
        self, creation_fn: Callable[[Optional[str]], Constraint]
    ) -> "CheckWithLastConstraintFilterable":
        return CheckWithLastConstraintFilterable(
            self.level,
            self.description,
            self.constraints + (creation_fn(None),),
            creation_fn,
        )

    # -- completeness / size ------------------------------------------------

    def has_size(self, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: size_constraint(assertion, where, hint)
        )

    def is_complete(self, column: str, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: completeness_constraint(column, IsOne, where, hint)
        )

    def has_completeness(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: completeness_constraint(column, assertion, where, hint)
        )

    # -- uniqueness ---------------------------------------------------------

    def is_unique(self, column: str, hint=None) -> "Check":
        return self.add_constraint(
            uniqueness_constraint(_columns_tuple(column), IsOne, hint)
        )

    def is_primary_key(self, column: str, *more_columns: str, hint=None) -> "Check":
        return self.add_constraint(
            uniqueness_constraint((column,) + tuple(more_columns), IsOne, hint)
        )

    def has_uniqueness(self, columns, assertion, hint=None) -> "Check":
        return self.add_constraint(
            uniqueness_constraint(_columns_tuple(columns), assertion, hint)
        )

    def has_distinctness(self, columns, assertion, hint=None) -> "Check":
        return self.add_constraint(
            distinctness_constraint(_columns_tuple(columns), assertion, hint)
        )

    def has_unique_value_ratio(self, columns, assertion, hint=None) -> "Check":
        return self.add_constraint(
            unique_value_ratio_constraint(_columns_tuple(columns), assertion, hint)
        )

    # -- histogram-based ----------------------------------------------------

    def has_number_of_distinct_values(
        self, column: str, assertion, binning_udf=None, max_bins: int = 1000, hint=None
    ) -> "Check":
        return self.add_constraint(
            histogram_bin_constraint(column, assertion, binning_udf, max_bins, hint)
        )

    def has_histogram_values(
        self, column: str, assertion, binning_udf=None, max_bins: int = 1000, hint=None
    ) -> "Check":
        return self.add_constraint(
            histogram_constraint(column, assertion, binning_udf, max_bins, hint)
        )

    def kll_sketch_satisfies(
        self, column: str, assertion, kll_parameters=None, hint=None
    ) -> "Check":
        return self.add_constraint(
            kll_constraint(column, assertion, kll_parameters, hint)
        )

    # -- information theory -------------------------------------------------

    def has_entropy(self, column: str, assertion, hint=None) -> "Check":
        return self.add_constraint(entropy_constraint(column, assertion, hint))

    def has_mutual_information(
        self, column_a: str, column_b: str, assertion, hint=None
    ) -> "Check":
        return self.add_constraint(
            mutual_information_constraint(column_a, column_b, assertion, hint)
        )

    # -- quantiles ----------------------------------------------------------

    def has_approx_quantile(
        self, column: str, quantile: float, assertion, relative_error: float = 0.01,
        hint=None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: approx_quantile_constraint(
                column, quantile, assertion, relative_error, where, hint
            )
        )

    # -- value ranges -------------------------------------------------------

    def has_min_length(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: min_length_constraint(column, assertion, where, hint)
        )

    def has_max_length(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: max_length_constraint(column, assertion, where, hint)
        )

    def has_min(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: min_constraint(column, assertion, where, hint)
        )

    def has_max(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: max_constraint(column, assertion, where, hint)
        )

    def has_mean(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: mean_constraint(column, assertion, where, hint)
        )

    def has_sum(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: sum_constraint(column, assertion, where, hint)
        )

    def has_standard_deviation(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: standard_deviation_constraint(column, assertion, where, hint)
        )

    def has_approx_count_distinct(
        self, column: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: approx_count_distinct_constraint(column, assertion, where, hint)
        )

    def has_correlation(
        self, column_a: str, column_b: str, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: correlation_constraint(column_a, column_b, assertion, where, hint)
        )

    # -- predicates / patterns ----------------------------------------------

    def satisfies(
        self, column_condition: str, constraint_name: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: compliance_constraint(
                constraint_name, column_condition, assertion, where, hint
            )
        )

    def has_pattern(
        self, column: str, pattern: str, assertion=IsOne, name=None, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: pattern_match_constraint(
                column, pattern, assertion, where, name, hint
            )
        )

    def contains_credit_card_number(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, Patterns.CREDITCARD, assertion,
            name=f"containsCreditCardNumber({column})", hint=hint,
        )

    def contains_email(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, Patterns.EMAIL, assertion,
            name=f"containsEmail({column})", hint=hint,
        )

    def contains_url(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, Patterns.URL, assertion,
            name=f"containsURL({column})", hint=hint,
        )

    def contains_social_security_number(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, Patterns.SOCIAL_SECURITY_NUMBER_US, assertion,
            name=f"containsSocialSecurityNumber({column})", hint=hint,
        )

    def has_data_type(
        self,
        column: str,
        data_type: ConstrainableDataTypes,
        assertion=IsOne,
        hint=None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: data_type_constraint(column, data_type, assertion, where, hint)
        )

    # -- numeric sign / comparisons -----------------------------------------

    def is_non_negative(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # coalesce so NULLs don't count as non-compliant (reference L727-735)
        return self.satisfies(
            f"COALESCE(`{column}`, 0.0) >= 0", f"{column} is non-negative",
            assertion, hint=hint,
        )

    def is_positive(
        self, column: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"COALESCE(`{column}`, 1.0) > 0", f"{column} is positive",
            assertion, hint=hint,
        )

    def is_less_than(
        self, column_a: str, column_b: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"`{column_a}` < `{column_b}`", f"{column_a} is smaller than {column_b}",
            assertion, hint=hint,
        )

    def is_less_than_or_equal_to(
        self, column_a: str, column_b: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"`{column_a}` <= `{column_b}`",
            f"{column_a} is smaller than or equal to {column_b}",
            assertion, hint=hint,
        )

    def is_greater_than(
        self, column_a: str, column_b: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"`{column_a}` > `{column_b}`", f"{column_a} is greater than {column_b}",
            assertion, hint=hint,
        )

    def is_greater_than_or_equal_to(
        self, column_a: str, column_b: str, assertion=IsOne, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"`{column_a}` >= `{column_b}`",
            f"{column_a} is greater than or equal to {column_b}",
            assertion, hint=hint,
        )

    def is_contained_in(
        self,
        column: str,
        allowed_values=None,
        assertion=IsOne,
        hint=None,
        lower_bound: Optional[float] = None,
        upper_bound: Optional[float] = None,
        include_lower_bound: bool = True,
        include_upper_bound: bool = True,
    ) -> "CheckWithLastConstraintFilterable":
        """Value-set or numeric-interval containment
        (reference checks/Check.scala:844-943)."""
        if allowed_values is not None:
            value_list = ",".join(
                "'" + str(v).replace("\\", "\\\\").replace("'", "\\'") + "'"
                for v in allowed_values
            )
            predicate = f"`{column}` IS NULL OR `{column}` IN ({value_list})"
            return self.satisfies(
                predicate,
                f"{column} contained in {','.join(str(v) for v in allowed_values)}",
                assertion, hint=hint,
            )
        if lower_bound is None or upper_bound is None:
            raise ValueError(
                "is_contained_in needs allowed_values or lower_bound+upper_bound"
            )
        left = ">=" if include_lower_bound else ">"
        right = "<=" if include_upper_bound else "<"
        predicate = (
            f"`{column}` IS NULL OR "
            f"(`{column}` {left} {lower_bound} AND `{column}` {right} {upper_bound})"
        )
        return self.satisfies(
            predicate, f"{column} between {lower_bound} and {upper_bound}",
            assertion, hint=hint,
        )

    # -- anomaly detection ---------------------------------------------------

    def is_newest_point_non_anomalous(
        self,
        metrics_repository,
        anomaly_detection_strategy,
        analyzer: Analyzer,
        with_tag_values: Optional[dict] = None,
        after_date: Optional[int] = None,
        before_date: Optional[int] = None,
    ) -> "Check":
        raise NotYetPortedException("Check.is_newest_point_non_anomalous")

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, context) -> CheckResult:
        """Evaluate all constraints against computed metrics
        (reference checks/Check.scala:950-962)."""
        metric_map: Dict[Analyzer, Metric] = context.metric_map
        results = [c.evaluate(metric_map) for c in self.constraints]
        any_failure = any(r.status == ConstraintStatus.FAILURE for r in results)
        if not any_failure:
            status = CheckStatus.SUCCESS
        elif self.level == CheckLevel.ERROR:
            status = CheckStatus.ERROR
        else:
            status = CheckStatus.WARNING
        return CheckResult(self, status, results)

    def required_analyzers(self) -> List[Analyzer]:
        """(reference checks/Check.scala:964-973)"""
        out = []
        for c in self.constraints:
            inner = c.inner if isinstance(c, ConstraintDecorator) else c
            if isinstance(inner, AnalysisBasedConstraint):
                out.append(inner.analyzer)
        return out

    def __repr__(self) -> str:
        return (
            f"Check({self.level.value}, {self.description!r}, "
            f"{len(self.constraints)} constraints)"
        )


class CheckWithLastConstraintFilterable(Check):
    """Allows replacing the last constraint with a filtered variant
    (reference checks/CheckWithLastConstraintFilterable.scala:22-53)."""

    def __init__(self, level, description, constraints, creation_fn):
        super().__init__(level, description, constraints)
        self._creation_fn = creation_fn

    def where(self, filter_expr: str) -> Check:
        return Check(
            self.level,
            self.description,
            self.constraints[:-1] + (self._creation_fn(filter_expr),),
        )

