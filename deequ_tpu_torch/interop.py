"""Carrying data and state across from the reference package.

This system's counterpart of carrying a model's weights across: its data
is the table and its parameters are the analyzer states. Both functions
take plain numpy arrays and numbers, never objects of ``deequ_tpu``, so
the port stays free of the reference (the parity tests read the arrays
off a ``deequ_tpu`` table or state and hand them over).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinctState, KLLState
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
from deequ_tpu_torch.data.table import Column, ColumnarTable, ColumnChunk, DType
from deequ_tpu_torch.ops.kll import KLLSketchState

_STATES = {
    cls.__name__: cls
    for cls in (
        NumMatches, NumMatchesAndCount, MeanState, SumState, MinState,
        MaxState, StandardDeviationState, CorrelationState,
    )
}


def _hll_state(registers, hash_version) -> ApproxCountDistinctState:
    return ApproxCountDistinctState(tuple(int(r) for r in registers), int(hash_version))


def _kll_state(compactors, count, rng_count, sketch_size, shrinking_factor,
               global_min, global_max) -> KLLState:
    sketch = KLLSketchState(
        sketch_size, shrinking_factor,
        [np.array(c, dtype=np.float64) for c in compactors], count, rng_count,
    )
    return KLLState(sketch, float(global_min), float(global_max))


_STATES.update({"ApproxCountDistinctState": _hll_state, "KLLState": _kll_state})


def table_from_arrays(columns: Iterable[Mapping]) -> ColumnarTable:
    """Build a ColumnarTable from per-column dicts: ``name``, ``dtype``
    (a ``DType`` or its value: "fractional" | "integral" | "boolean" |
    "string"), then numpy ``values`` and optional ``mask`` (True = valid),
    or, for strings, int32 ``codes`` (-1 = null) and ``dictionary``. An
    encoded numeric column gives the fields of its ``ColumnChunk``
    instead: int16 ``codes`` (-1 = null), ``dictionary``, ``validity``
    (the packed null bitmap, or None) and ``num_rows``."""
    built = []
    for spec in columns:
        dtype = DType(spec["dtype"])
        if dtype == DType.STRING:
            built.append(Column(
                spec["name"], dtype, codes=spec["codes"],
                dictionary=spec["dictionary"],
            ))
        elif "codes" in spec:
            validity = spec.get("validity")
            built.append(Column(spec["name"], dtype, encoded=ColumnChunk(
                np.asarray(spec["codes"], dtype=np.int16),
                np.asarray(spec["dictionary"]),
                None if validity is None else np.asarray(validity, dtype=np.uint8),
                int(spec["num_rows"]),
            )))
        else:
            built.append(Column(
                spec["name"], dtype, values=spec["values"], mask=spec.get("mask"),
            ))
    return ColumnarTable(built)


def state_from_fields(kind: str, fields: Mapping):
    """Build the port's state ``kind`` (its class name, e.g.
    ``"StandardDeviationState"``) from plain numbers keyed by field name
    (``{"n": ..., "avg": ..., "m2": ...}``) — the fields of the reference's
    dataclass of the same name. Two kinds hold more than numbers:

    - ``"ApproxCountDistinctState"``: ``registers`` (a sequence of ints)
      and ``hash_version``;
    - ``"KLLState"``: the sketch's ``compactors`` (one array of items a
      level), ``count``, ``rng_count``, ``sketch_size`` and
      ``shrinking_factor``, and ``global_min`` / ``global_max``."""
    try:
        cls = _STATES[kind]
    except KeyError:
        raise ValueError(
            f"unknown state kind {kind!r}; one of {sorted(_STATES)}"
        ) from None
    return cls(**{k: v for k, v in fields.items()})
