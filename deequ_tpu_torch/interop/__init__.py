"""Carrying data and state across from the reference package.

This system's counterpart of carrying a model's weights across: its data
is the table and its parameters are the analyzer states. These functions
take plain numpy arrays, numbers and bytes, never objects of
``deequ_tpu``, so the port stays free of the reference (the parity tests
read the arrays off a ``deequ_tpu`` table or state and hand them over).

A state crosses in either of two forms: its fields
(:func:`state_from_fields`), or the bytes of the shared state format
(:func:`state_from_bytes` / :func:`state_to_bytes`, ``states/serde.py``:
the reference's ``DQTS`` envelope, byte for byte) — the form a state file
of a ``FileSystemStateProvider`` holds inside its checksum envelope.

The artifacts of deequ itself (Scala/Spark) come in through
``interop/deequ_import.py``: its metrics-repository JSON
(:func:`import_repository_json`, :func:`import_analysis_results`) and
the portable binary states of its ``HdfsStateProvider``
(:func:`load_reference_state`: counts, min/max, moments, the DataType
histogram, frequency tables in Parquet). Its sketch states (HLL words,
the percentile digest) refuse: their algebra differs by design.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinctState, KLLState
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
from deequ_tpu_torch.data.table import Column, ColumnarTable, ColumnChunk, DType
from deequ_tpu_torch.interop.deequ_import import (
    import_analysis_results,
    import_repository_json,
    load_reference_state,
    murmur3_x86_32,
    reference_state_identifier,
    scala_murmur3_string_hash,
)
from deequ_tpu_torch.ops.kll import KLLSketchState
from deequ_tpu_torch.states.serde import deserialize_state, serialize_state

_STATES = {
    cls.__name__: cls
    for cls in (
        NumMatches, NumMatchesAndCount, MeanState, SumState, MinState,
        MaxState, StandardDeviationState, CorrelationState, DataTypeHistogram,
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


def _freq_state(columns, key_values, key_nulls, counts, num_rows) -> FrequenciesAndNumRows:
    return FrequenciesAndNumRows(
        tuple(columns), tuple(np.array(v) for v in key_values),
        tuple(np.array(m, dtype=bool) for m in key_nulls),
        np.array(counts, dtype=np.int64), int(num_rows),
    )


_STATES.update({"ApproxCountDistinctState": _hll_state, "KLLState": _kll_state,
                "FrequenciesAndNumRows": _freq_state})


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
      ``shrinking_factor``, and ``global_min`` / ``global_max``;
    - ``"FrequenciesAndNumRows"``: ``columns``, ``key_values`` and
      ``key_nulls`` (one array a grouping column), ``counts`` and
      ``num_rows``."""
    try:
        cls = _STATES[kind]
    except KeyError:
        raise ValueError(
            f"unknown state kind {kind!r}; one of {sorted(_STATES)}"
        ) from None
    return cls(**{k: v for k, v in fields.items()})


def state_from_bytes(data: bytes):
    """The port's state from the bytes of the shared state format — as
    the reference's ``serialize_state`` writes them, or a state file's
    payload."""
    return deserialize_state(bytes(data))


def state_to_bytes(state) -> bytes:
    """A port state as the bytes of the shared state format, equal to
    what the reference writes for the same fields."""
    return serialize_state(state)
