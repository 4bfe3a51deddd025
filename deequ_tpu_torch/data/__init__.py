from deequ_tpu_torch.data.table import Column, ColumnarTable, DType, Field, Schema

__all__ = ["Column", "ColumnarTable", "DType", "Field", "Schema"]
