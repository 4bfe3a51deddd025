"""Constraint suggestion runner (reference suggestions/
ConstraintSuggestionRunner.scala:59-136, ConstraintSuggestionResult.scala;
the port of ``deequ_tpu/suggestions/runner.py``).

Profiles the data, applies the rules to each column's profile, and,
with a train/test split, evaluates the suggested constraints on the
held-out rows with a ``VerificationSuite`` run. The profile and the run
execute on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from deequ_tpu_torch.checks import Check, CheckLevel
from deequ_tpu_torch.constraints import Constraint
from deequ_tpu_torch.data.table import ColumnarTable
from deequ_tpu_torch.profiles.profiler import (
    ColumnProfiler,
    ColumnProfiles,
    DEFAULT_CARDINALITY_THRESHOLD,
)
from deequ_tpu_torch.suggestions.rules import (
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    ConstraintRule,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
)


class Rules:
    """(reference ConstraintSuggestionRunner.scala:30-36)"""

    DEFAULT: List[ConstraintRule] = [
        CompleteIfCompleteRule(),
        RetainCompletenessRule(),
        RetainTypeRule(),
        CategoricalRangeRule(),
        FractionalCategoricalRangeRule(),
        NonNegativeNumbersRule(),
    ]


@dataclass
class ConstraintSuggestion:
    """(reference suggestions/ConstraintSuggestion.scala:25-33)"""

    constraint: Constraint
    column_name: str
    current_value: str
    description: str
    suggesting_rule: ConstraintRule
    code_for_constraint: str


@dataclass
class ConstraintSuggestionResult:
    """(reference suggestions/ConstraintSuggestionResult.scala:32-53)"""

    column_profiles: ColumnProfiles
    suggestions: Dict[str, List[ConstraintSuggestion]]
    verification_result: Optional[object] = None  # VerificationResult

    @property
    def all_suggestions(self) -> List[ConstraintSuggestion]:
        return [s for group in self.suggestions.values() for s in group]

    def profiles_as_json(self) -> str:
        return self.column_profiles.to_json()

    def suggestions_as_json(self) -> str:
        return json.dumps(
            {
                "constraint_suggestions": [
                    {
                        "constraint_name": str(s.constraint),
                        "column_name": s.column_name,
                        "current_value": s.current_value,
                        "description": s.description,
                        "suggesting_rule": repr(s.suggesting_rule),
                        "rule_description": s.suggesting_rule.rule_description,
                        "code_for_constraint": s.code_for_constraint,
                    }
                    for s in self.all_suggestions
                ]
            }
        )

    def evaluation_as_json(self) -> str:
        if self.verification_result is None:
            return json.dumps({"constraint_suggestions": []})
        status_by_constraint = {}
        for check_result in self.verification_result.check_results.values():
            for cr in check_result.constraint_results:
                status_by_constraint[str(cr.constraint)] = cr.status.value
        return json.dumps(
            {
                "constraint_suggestions": [
                    {
                        "constraint_name": str(s.constraint),
                        "column_name": s.column_name,
                        "description": s.description,
                        "evaluation_status": status_by_constraint.get(
                            str(s.constraint), "Unknown"
                        ),
                    }
                    for s in self.all_suggestions
                ]
            }
        )


class ConstraintSuggestionRunner:
    @staticmethod
    def on_data(data: ColumnarTable, device=None) -> "ConstraintSuggestionRunBuilder":
        """``device`` as ``VerificationSuite.on_data``'s."""
        return ConstraintSuggestionRunBuilder(data, device)


class ConstraintSuggestionRunBuilder:
    def __init__(self, data: ColumnarTable, device=None):
        self._data = data
        self._device = device
        self._rules: List[ConstraintRule] = []
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._threshold = DEFAULT_CARDINALITY_THRESHOLD
        self._print_status_updates = False
        self._testset_ratio: Optional[float] = None
        self._testset_split_random_seed: Optional[int] = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_missing = False
        self._save_key = None
        self._kll_profiling = False
        self._kll_parameters = None

    def add_constraint_rule(self, rule: ConstraintRule):
        self._rules.append(rule)
        return self

    def add_constraint_rules(self, rules: Sequence[ConstraintRule]):
        self._rules.extend(rules)
        return self

    def restrict_to_columns(self, columns: Sequence[str]):
        self._restrict_to_columns = columns
        return self

    def with_low_cardinality_histogram_threshold(self, threshold: int):
        self._threshold = threshold
        return self

    def print_status_updates(self, value: bool):
        self._print_status_updates = value
        return self

    def use_train_test_split_with_test_set_ratio(
        self, ratio: float, seed: Optional[int] = None
    ):
        if not (0.0 < ratio < 1.0):
            raise ValueError("Testset ratio must be in ]0, 1[")
        self._testset_ratio = ratio
        self._testset_split_random_seed = seed
        return self

    def with_kll_profiling(self):
        self._kll_profiling = True
        return self

    def set_kll_parameters(self, parameters):
        self._kll_parameters = parameters
        return self

    def use_repository(self, repository):
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(self, key, fail_if_missing: bool = False):
        self._reuse_key = key
        self._fail_if_missing = fail_if_missing
        return self

    def save_or_append_result(self, key):
        self._save_key = key
        return self

    def run(self) -> ConstraintSuggestionResult:
        # optional train/test split (reference L87)
        if self._testset_ratio is not None:
            train_ratio = 1.0 - self._testset_ratio
            seed = (
                self._testset_split_random_seed
                if self._testset_split_random_seed is not None
                else 0
            )
            train, test = self._data.random_split(
                (train_ratio, self._testset_ratio), seed=seed
            )
        else:
            train, test = self._data, None

        profiles = ColumnProfiler.profile(
            train,
            restrict_to_columns=self._restrict_to_columns,
            print_status_updates=self._print_status_updates,
            low_cardinality_histogram_threshold=self._threshold,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_using_key=self._reuse_key,
            fail_if_results_for_reusing_missing=self._fail_if_missing,
            save_in_metrics_repository_using_key=self._save_key,
            kll_profiling=self._kll_profiling,
            kll_parameters=self._kll_parameters,
            device=self._device,
        )

        suggestions: Dict[str, List[ConstraintSuggestion]] = {}
        for name, profile in profiles.profiles.items():
            for rule in self._rules:
                if rule.should_be_applied(profile, profiles.num_records):
                    suggestions.setdefault(name, []).append(
                        rule.candidate(profile, profiles.num_records)
                    )

        verification_result = None
        if test is not None and suggestions:
            from deequ_tpu_torch.verification import VerificationSuite

            check = Check(
                CheckLevel.WARNING, "generated constraints",
            )
            for group in suggestions.values():
                for s in group:
                    check = check.add_constraint(s.constraint)
            verification_result = (
                VerificationSuite.on_data(test, self._device).add_check(check).run()
            )

        return ConstraintSuggestionResult(profiles, suggestions, verification_result)
