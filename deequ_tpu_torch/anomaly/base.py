"""Detector + result types (reference anomalydetection/AnomalyDetector.scala,
DetectionResult.scala)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from deequ_tpu_torch.anomaly.history import DataPoint


@dataclass
class Anomaly:
    value: Optional[float]
    confidence: float
    detail: Optional[str] = None

    def __eq__(self, other) -> bool:
        # reference equality ignores detail (DetectionResult.scala:30-38)
        return (
            isinstance(other, Anomaly)
            and self.value == other.value
            and self.confidence == other.confidence
        )

    def __hash__(self) -> int:
        return hash((self.value, self.confidence))


@dataclass
class DetectionResult:
    anomalies: List[Tuple[int, Anomaly]] = field(default_factory=list)


# "whole series" sentinel for detect()'s search interval — the analogue of
# the reference trait's (Int.MinValue, Int.MaxValue) default
# (AnomalyDetectionStrategy.scala:20-29)
FULL_INTERVAL = (0, 2 ** 63 - 1)


class AnomalyDetectionStrategy:
    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        raise NotImplementedError


@dataclass
class AnomalyDetector:
    """(reference anomalydetection/AnomalyDetector.scala:29-102)"""

    strategy: AnomalyDetectionStrategy

    def is_new_point_anomalous(
        self,
        historical_data_points: Sequence[DataPoint],
        new_point: DataPoint,
    ) -> DetectionResult:
        if not historical_data_points:
            raise ValueError("historicalDataPoints must not be empty!")
        sorted_points = sorted(historical_data_points, key=lambda p: p.time)
        last_time = sorted_points[-1].time
        if last_time >= new_point.time:
            raise ValueError(
                f"Can't decide which range to use for anomaly detection. New "
                f"data point with time {new_point.time} is in history range "
                f"({sorted_points[0].time} - {last_time})!"
            )
        all_points = list(sorted_points) + [new_point]
        return self.detect_anomalies_in_history(
            all_points, (new_point.time, 2 ** 63 - 1)
        )

    def detect_anomalies_in_history(
        self,
        data_series: Sequence[DataPoint],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> DetectionResult:
        search_start, search_end = search_interval
        if search_start > search_end:
            raise ValueError(
                "The first interval element has to be smaller or equal to the last."
            )
        present = [p for p in data_series if p.metric_value is not None]
        present.sort(key=lambda p: p.time)
        timestamps = [p.time for p in present]
        values = [p.metric_value for p in present]
        lower = bisect.bisect_left(timestamps, search_start)
        upper = bisect.bisect_left(timestamps, search_end)
        anomalies = self.strategy.detect(values, (lower, upper))
        return DetectionResult(
            [(timestamps[idx], anomaly) for idx, anomaly in anomalies]
        )
