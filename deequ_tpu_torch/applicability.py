"""Applicability checker (reference
analyzers/applicability/Applicability.scala:55-273; the port of
``deequ_tpu/applicability.py``).

Before a check or analyzers meet real (large) data, it generates a small
table of random data matching a schema and dry-runs them over it,
catching missing columns, type mismatches and malformed expressions. The
table is the reference's row for row (``random.Random(42)``,
:data:`NUM_RECORDS` rows); the dry run executes on ``cuda`` unless the
caller asks for the CPU (``use_device``).
"""

from __future__ import annotations

import random
import string as string_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.data.table import ColumnarTable, DType, Schema

NUM_RECORDS = 1000


def _random_value(dtype: DType, rng: random.Random):
    if dtype == DType.STRING:
        return "".join(
            rng.choice(string_mod.ascii_letters) for _ in range(rng.randint(1, 20))
        )
    if dtype == DType.INTEGRAL:
        return rng.randint(-(2 ** 31), 2 ** 31)
    if dtype == DType.BOOLEAN:
        return rng.random() < 0.5
    return rng.uniform(-1e6, 1e6)


def generate_random_data(schema: Schema, num_records: int = NUM_RECORDS) -> ColumnarTable:
    """(reference Applicability.scala:240-272)"""
    rng = random.Random(42)
    data: Dict[str, list] = {}
    for f in schema:
        column = []
        for _ in range(num_records):
            if f.nullable and rng.random() < 0.01:
                column.append(None)
            else:
                column.append(_random_value(f.dtype, rng))
        data[f.name] = column
    return ColumnarTable.from_pydict(data)


@dataclass
class CheckApplicability:
    is_applicable: bool
    failures: List[Tuple[str, Optional[Exception]]]
    constraint_applicabilities: Dict[str, bool] = field(default_factory=dict)


@dataclass
class AnalyzersApplicability:
    is_applicable: bool
    failures: List[Tuple[str, Optional[Exception]]]


class Applicability:
    """(reference Applicability.scala:162-237)"""

    @staticmethod
    def is_check_applicable(check, schema: Schema) -> CheckApplicability:
        from deequ_tpu_torch.analyzers.runner import AnalysisRunner

        data = generate_random_data(schema)
        ctx = AnalysisRunner.do_analysis_run(data, check.required_analyzers())
        result = check.evaluate(ctx)

        failures: List[Tuple[str, Optional[Exception]]] = []
        constraint_applicabilities = {}
        for analyzer, metric in ctx.metric_map.items():
            if metric.value.is_failure:
                failures.append((str(analyzer), metric.value.exception))
        for cr in result.constraint_results:
            # a constraint is applicable if its metric computed successfully
            # (assertion outcomes on random data are irrelevant)
            applicable = not (
                cr.metric is None or cr.metric.value.is_failure
            )
            constraint_applicabilities[str(cr.constraint)] = applicable
        return CheckApplicability(
            len(failures) == 0, failures, constraint_applicabilities
        )

    @staticmethod
    def are_analyzers_applicable(
        analyzers: Sequence[Analyzer], schema: Schema
    ) -> AnalyzersApplicability:
        from deequ_tpu_torch.analyzers.runner import AnalysisRunner

        data = generate_random_data(schema)
        ctx = AnalysisRunner.do_analysis_run(data, analyzers)
        failures = [
            (str(a), m.value.exception)
            for a, m in ctx.metric_map.items()
            if m.value.is_failure
        ]
        return AnalyzersApplicability(len(failures) == 0, failures)
