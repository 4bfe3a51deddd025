from deequ_tpu_torch.suggestions.rules import (
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    ConstraintRule,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
    UniqueIfApproximatelyUniqueRule,
)
from deequ_tpu_torch.suggestions.runner import (
    ConstraintSuggestion,
    ConstraintSuggestionResult,
    ConstraintSuggestionRunner,
    Rules,
)

__all__ = [
    "CategoricalRangeRule",
    "CompleteIfCompleteRule",
    "ConstraintRule",
    "ConstraintSuggestion",
    "ConstraintSuggestionResult",
    "ConstraintSuggestionRunner",
    "FractionalCategoricalRangeRule",
    "NonNegativeNumbersRule",
    "RetainCompletenessRule",
    "RetainTypeRule",
    "Rules",
    "UniqueIfApproximatelyUniqueRule",
]
