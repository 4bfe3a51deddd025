"""Constraint suggestion rules (reference suggestions/rules/*.scala; the
port's copy of ``deequ_tpu/suggestions/rules.py``, host code).

Each rule inspects one column profile and, when applicable, emits a
``ConstraintSuggestion`` carrying an executable constraint plus the Python
code snippet that would add it to a Check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Tuple

from deequ_tpu_torch.analyzers.grouping import NULL_FIELD_REPLACEMENT
from deequ_tpu_torch.analyzers.scan import DataTypeInstances
from deequ_tpu_torch.checks import IsOne
from deequ_tpu_torch.constraints import (
    ConstrainableDataTypes,
    completeness_constraint,
    compliance_constraint,
    data_type_constraint,
    uniqueness_constraint,
)
from deequ_tpu_torch.profiles.profiler import ColumnProfile, NumericColumnProfile

if TYPE_CHECKING:
    from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion


def _sql_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("'", "\\'")


class ConstraintRule:
    """(reference suggestions/rules/ConstraintRule.scala:34-43)"""

    rule_description: str = ""

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        raise NotImplementedError

    def candidate(self, profile: ColumnProfile, num_records: int):
        raise NotImplementedError

    def __repr__(self) -> str:
        return type(self).__name__ + "()"


@dataclass(frozen=True)
class CompleteIfCompleteRule(ConstraintRule):
    """Complete in the sample -> NOT NULL constraint
    (reference rules/CompleteIfCompleteRule.scala:25-31)."""

    rule_description = (
        "If a column is complete in the sample, we suggest a NOT NULL constraint"
    )

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        return profile.completeness == 1.0

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        return ConstraintSuggestion(
            constraint=completeness_constraint(profile.column, IsOne),
            column_name=profile.column,
            current_value=f"Completeness: {profile.completeness}",
            description=f"'{profile.column}' is not null",
            suggesting_rule=self,
            code_for_constraint=f'.is_complete("{profile.column}")',
        )


@dataclass(frozen=True)
class RetainCompletenessRule(ConstraintRule):
    """Model completeness as a binomial proportion; suggest the lower bound
    of its 95% confidence interval
    (reference rules/RetainCompletenessRule.scala:28-34)."""

    rule_description = (
        "If a column is incomplete in the sample, we model its completeness "
        "as a binomial variable, estimate a confidence interval and use this "
        "to define a lower bound for the completeness"
    )

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        return 0.2 < profile.completeness < 1.0

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        p = profile.completeness
        n = max(num_records, 1)
        z = 1.96
        target = p - z * math.sqrt(p * (1 - p) / n)
        target = math.floor(target * 100) / 100  # round DOWN to 2 decimals
        bound_percent = int((1.0 - target) * 100)
        return ConstraintSuggestion(
            constraint=completeness_constraint(
                profile.column, lambda v, t=target: v >= t
            ),
            column_name=profile.column,
            current_value=f"Completeness: {profile.completeness}",
            description=(
                f"'{profile.column}' has less than {bound_percent}% missing values"
            ),
            suggesting_rule=self,
            code_for_constraint=(
                f'.has_completeness("{profile.column}", lambda v: v >= {target}, '
                f'hint="It should be above {target}!")'
            ),
        )


@dataclass(frozen=True)
class RetainTypeRule(ConstraintRule):
    """Inferred non-string type -> type constraint
    (reference rules/RetainTypeRule.scala:27-39)."""

    rule_description = "If we detect a non-string type, we suggest a type constraint"

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        testable = profile.data_type in (
            DataTypeInstances.INTEGRAL,
            DataTypeInstances.FRACTIONAL,
            DataTypeInstances.BOOLEAN,
        )
        return profile.is_data_type_inferred and testable

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        type_to_check = {
            DataTypeInstances.FRACTIONAL: ConstrainableDataTypes.FRACTIONAL,
            DataTypeInstances.INTEGRAL: ConstrainableDataTypes.INTEGRAL,
            DataTypeInstances.BOOLEAN: ConstrainableDataTypes.BOOLEAN,
        }[profile.data_type]
        return ConstraintSuggestion(
            constraint=data_type_constraint(profile.column, type_to_check, IsOne),
            column_name=profile.column,
            current_value=f"DataType: {profile.data_type.value}",
            description=f"'{profile.column}' has type {profile.data_type.value}",
            suggesting_rule=self,
            code_for_constraint=(
                f'.has_data_type("{profile.column}", '
                f"ConstrainableDataTypes.{profile.data_type.value.upper()})"
            ),
        )


def _unique_value_ratio(profile: ColumnProfile) -> float:
    entries = profile.histogram.values
    num_unique = sum(1 for v in entries.values() if v.absolute == 1)
    return num_unique / len(entries) if entries else 1.0


@dataclass(frozen=True)
class CategoricalRangeRule(ConstraintRule):
    """Low-cardinality string column -> IS IN constraint over its values
    (reference rules/CategoricalRangeRule.scala:27-46)."""

    rule_description = (
        "If we see a categorical range for a column, we suggest an IS IN (...) "
        "constraint"
    )

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        if profile.histogram is None or profile.data_type != DataTypeInstances.STRING:
            return False
        return _unique_value_ratio(profile) <= 0.1

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        by_popularity = sorted(
            (
                (k, v)
                for k, v in profile.histogram.values.items()
                if k != NULL_FIELD_REPLACEMENT
            ),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        categories_sql = ", ".join(f"'{_sql_escape(k)}'" for k, _ in by_popularity)
        categories_code = ", ".join(repr(k) for k, _ in by_popularity)
        description = f"'{profile.column}' has value range {categories_sql}"
        condition = f"`{profile.column}` IS NULL OR `{profile.column}` IN ({categories_sql})"
        return ConstraintSuggestion(
            constraint=compliance_constraint(description, condition, IsOne),
            column_name=profile.column,
            current_value="Compliance: 1",
            description=description,
            suggesting_rule=self,
            code_for_constraint=(
                f'.is_contained_in("{profile.column}", [{categories_code}])'
            ),
        )


@dataclass(frozen=True)
class FractionalCategoricalRangeRule(ConstraintRule):
    """Top categories covering >= target fraction -> IS IN constraint with a
    fractional assertion (reference rules/FractionalCategoricalRangeRule.
    scala:29-99)."""

    target_data_coverage_fraction: float = 0.9

    rule_description = (
        "If we see a categorical range for most values in a column, we "
        "suggest an IS IN (...) constraint that should hold for most values"
    )

    def _top_categories(self, profile: ColumnProfile) -> List[Tuple[str, object]]:
        entries = sorted(
            profile.histogram.values.items(),
            key=lambda kv: kv[1].ratio,
            reverse=True,
        )
        out = []
        covered = 0.0
        for k, v in entries:
            if covered >= self.target_data_coverage_fraction:
                break
            out.append((k, v))
            covered += v.ratio
        return out

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        if profile.histogram is None or profile.data_type != DataTypeInstances.STRING:
            return False
        top = self._top_categories(profile)
        ratio_sum = sum(v.ratio for _, v in top)
        return _unique_value_ratio(profile) <= 0.4 and ratio_sum < 1

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        top = self._top_categories(profile)
        ratio_sum = sum(v.ratio for _, v in top)
        by_popularity = sorted(
            ((k, v) for k, v in top if k != NULL_FIELD_REPLACEMENT),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        categories_sql = ", ".join(f"'{_sql_escape(k)}'" for k, _ in by_popularity)
        categories_code = ", ".join(repr(k) for k, _ in by_popularity)
        # binomial confidence-interval lower bound on the observed coverage
        # (reference FractionalCategoricalRangeRule.scala:77-80)
        p = ratio_sum
        n = max(num_records, 1)
        z = 1.96
        target = math.floor((p - z * math.sqrt(p * (1 - p) / n)) * 100) / 100
        description = (
            f"'{profile.column}' has value range {categories_sql} for at "
            f"least {target * 100:.0f}% of values"
        )
        condition = f"`{profile.column}` IN ({categories_sql})"
        return ConstraintSuggestion(
            constraint=compliance_constraint(
                description, condition, lambda v, t=target: v >= t
            ),
            column_name=profile.column,
            current_value=f"Compliance: {ratio_sum}",
            description=description,
            suggesting_rule=self,
            code_for_constraint=(
                f'.is_contained_in("{profile.column}", [{categories_code}], '
                f"lambda v: v >= {target}, "
                f'hint="It should be above {target}!")'
            ),
        )


@dataclass(frozen=True)
class NonNegativeNumbersRule(ConstraintRule):
    """Only non-negative values observed -> isNonNegative
    (reference rules/NonNegativeNumbersRule.scala:25-34)."""

    rule_description = (
        "If we see only non-negative numbers in a column, we suggest a "
        "corresponding constraint"
    )

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        return (
            isinstance(profile, NumericColumnProfile)
            and profile.minimum is not None
            and profile.minimum >= 0.0
        )

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        description = f"'{profile.column}' has no negative values"
        minimum = (
            str(profile.minimum)
            if isinstance(profile, NumericColumnProfile) and profile.minimum is not None
            else "Error while calculating minimum!"
        )
        return ConstraintSuggestion(
            constraint=compliance_constraint(
                description, f"COALESCE(`{profile.column}`, 0.0) >= 0", IsOne
            ),
            column_name=profile.column,
            current_value=f"Minimum: {minimum}",
            description=description,
            suggesting_rule=self,
            code_for_constraint=f'.is_non_negative("{profile.column}")',
        )


@dataclass(frozen=True)
class UniqueIfApproximatelyUniqueRule(ConstraintRule):
    """Approx distinct count close to the record count -> UNIQUE
    (reference rules/UniqueIfApproximatelyUniqueRule.scala:28-38)."""

    rule_description = (
        "If the ratio of approximate num distinct values in a column is "
        "close to the number of records (within the error of the HLL "
        "sketch), we suggest a UNIQUE constraint"
    )

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        if num_records == 0:
            return False
        distinctness = profile.approximate_num_distinct_values / num_records
        return profile.completeness == 1.0 and abs(1.0 - distinctness) <= 0.08

    def candidate(self, profile: ColumnProfile, num_records: int):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestion

        distinctness = profile.approximate_num_distinct_values / max(num_records, 1)
        return ConstraintSuggestion(
            constraint=uniqueness_constraint((profile.column,), IsOne),
            column_name=profile.column,
            current_value=f"ApproxDistinctness: {distinctness}",
            description=f"'{profile.column}' is unique",
            suggesting_rule=self,
            code_for_constraint=f'.is_unique("{profile.column}")',
        )
