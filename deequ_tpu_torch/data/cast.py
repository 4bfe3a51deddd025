"""Column casts (the port's copy of ``deequ_tpu/data/cast.py``)."""

from __future__ import annotations

import numpy as np

from deequ_tpu_torch.data.table import Column, DType


def cast_string_column(col: Column, target: DType) -> Column:
    """Cast a dictionary-encoded string column to numeric; unparsable values
    become null (the analogue of ColumnProfiler.castColumn, reference
    profiles/ColumnProfiler.scala:346-355). The parse runs once a distinct
    value; the cast is a gather."""
    if col.dtype != DType.STRING:
        raise TypeError(f"column {col.name} is not a string column")
    if target not in (DType.INTEGRAL, DType.FRACTIONAL):
        raise ValueError(f"cannot cast strings to {target}")
    card = max(len(col.dictionary), 1)
    lut = np.zeros(card, dtype=np.float64)
    ok = np.zeros(card, dtype=np.bool_)
    for i, v in enumerate(col.dictionary):
        try:
            lut[i] = float(v)
            ok[i] = True
        except (TypeError, ValueError):
            pass
    safe = np.maximum(col.codes, 0)
    values = lut[safe]
    mask = (col.codes >= 0) & ok[safe]
    if target == DType.INTEGRAL:
        return Column(col.name, DType.INTEGRAL, values=values.astype(np.int64), mask=mask)
    return Column(col.name, DType.FRACTIONAL, values=values, mask=mask)
