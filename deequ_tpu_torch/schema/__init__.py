from deequ_tpu_torch.schema.validator import (
    RowLevelSchema,
    RowLevelSchemaValidationResult,
    RowLevelSchemaValidator,
)

__all__ = [
    "RowLevelSchema",
    "RowLevelSchemaValidationResult",
    "RowLevelSchemaValidator",
]
