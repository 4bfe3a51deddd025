"""Metric model (reference layer L8, metrics/Metric.scala,
HistogramMetric.scala).

A metric is ``{entity, name, instance, value: Try[T]}`` where failure is a
first-class value. ``flatten()`` turns any metric into a sequence of
DoubleMetrics for uniform repository storage.

``KLLMetric`` carries a KLL sketch's buckets and its raw compactors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from deequ_tpu_torch.tryresult import Success, Try


class Entity(enum.Enum):
    """What a metric describes (reference metrics/Metric.scala:21)."""

    DATASET = "Dataset"
    COLUMN = "Column"
    MULTICOLUMN = "Multicolumn"


class Metric:
    """Base metric: entity + name + instance + Try-valued payload."""

    entity: Entity
    name: str
    instance: str
    value: Try

    def flatten(self) -> Sequence["DoubleMetric"]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}({self.entity.value}, {self.name!r}, "
            f"{self.instance!r}, {self.value!r})"
        )


@dataclass(frozen=True)
class DoubleMetric(Metric):
    entity: Entity
    name: str
    instance: str
    value: Try[float]

    def flatten(self) -> Sequence["DoubleMetric"]:
        return [self]


@dataclass(frozen=True)
class KeyedDoubleMetric(Metric):
    """A map of named double values, e.g. many quantiles from one sketch
    (reference metrics/Metric.scala:51-68)."""

    entity: Entity
    name: str
    instance: str
    value: Try[Dict[str, float]]

    def flatten(self) -> Sequence[DoubleMetric]:
        if self.value.is_success:
            return [
                DoubleMetric(self.entity, f"{self.name}-{k}", self.instance, Success(v))
                for k, v in self.value.get().items()
            ]
        return [DoubleMetric(self.entity, self.name, self.instance, self.value)]


@dataclass(frozen=True)
class DistributionValue:
    absolute: int
    ratio: float


@dataclass(frozen=True)
class Distribution:
    """Categorical distribution: value -> (absolute count, ratio)
    (reference metrics/HistogramMetric.scala:21-41)."""

    values: Dict[str, DistributionValue]
    number_of_bins: int

    def __getitem__(self, key: str) -> DistributionValue:
        return self.values[key]

    def argmax(self) -> str:
        max_count = max(v.absolute for v in self.values.values())
        # deterministic tie-break on key order, like the reference's find-first
        for k, v in self.values.items():
            if v.absolute == max_count:
                return k
        raise ValueError("empty distribution")


@dataclass(frozen=True)
class HistogramMetric(Metric):
    instance: str
    value: Try[Distribution]
    entity: Entity = Entity.COLUMN
    name: str = "Histogram"

    def flatten(self) -> Sequence[DoubleMetric]:
        if not self.value.is_success:
            return [DoubleMetric(self.entity, self.name, self.instance, self.value)]
        dist = self.value.get()
        out = [
            DoubleMetric(
                self.entity,
                f"{self.name}.bins",
                self.instance,
                Success(float(dist.number_of_bins)),
            )
        ]
        for k, v in dist.values.items():
            out.append(
                DoubleMetric(
                    self.entity,
                    f"{self.name}.abs.{k}",
                    self.instance,
                    Success(float(v.absolute)),
                )
            )
            out.append(
                DoubleMetric(
                    self.entity, f"{self.name}.ratio.{k}", self.instance, Success(v.ratio)
                )
            )
        return out



@dataclass(frozen=True)
class BucketValue:
    low_value: float
    high_value: float
    count: int


@dataclass(frozen=True)
class BucketDistribution:
    """Bucketed numeric distribution + raw sketch data, from a KLL sketch
    (reference metrics/KLLMetric.scala:24-123)."""

    buckets: List[BucketValue]
    parameters: Tuple[float, ...]  # (shrinking factor, sketch size)
    data: tuple  # raw compactor item arrays (serializable)

    def compute_percentiles(self) -> List[float]:
        """Reconstruct the sketch and query the 1..100 percentiles."""
        from deequ_tpu_torch.ops.kll import KLLSketchState

        sketch = KLLSketchState.reconstruct(self.data, self.parameters)
        return [sketch.quantile(p / 100.0) for p in range(1, 101)]

    def argmax(self) -> int:
        """Index of the bucket with the highest count."""
        counts = [b.count for b in self.buckets]
        return counts.index(max(counts))


@dataclass(frozen=True)
class KLLMetric(Metric):
    instance: str
    value: Try[BucketDistribution]
    entity: Entity = Entity.COLUMN
    name: str = "KLL"

    def flatten(self) -> Sequence[DoubleMetric]:
        if not self.value.is_success:
            return [DoubleMetric(self.entity, self.name, self.instance, self.value)]
        out = []
        for i, b in enumerate(self.value.get().buckets):
            for part, v in (("low", b.low_value), ("high", b.high_value),
                            ("count", float(b.count))):
                out.append(DoubleMetric(
                    self.entity, f"{self.name}.bucket.{i}.{part}", self.instance,
                    Success(v),
                ))
        return out
