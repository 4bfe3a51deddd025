"""Anomaly detection over metric time series (reference layer L10,
anomalydetection/; the port's copy of ``deequ_tpu/anomaly``).

All strategies implement ``detect(data_series, search_interval) ->
[(index, Anomaly)]`` over a plain series of doubles; the AnomalyDetector
handles preprocessing (sorting by time, dropping missing values, mapping the
time-based search interval to indices). Holt-Winters fits its parameters
on the run's device (``ops/holt_winters.py``: one kernel launch on a card)."""

from deequ_tpu_torch.anomaly.base import (
    Anomaly,
    AnomalyDetectionStrategy,
    AnomalyDetector,
    DetectionResult,
)
from deequ_tpu_torch.anomaly.history import DataPoint, extract_metric_values
from deequ_tpu_torch.anomaly.strategies import (
    AbsoluteChangeStrategy,
    BatchNormalStrategy,
    BaseChangeStrategy,
    OnlineNormalStrategy,
    RateOfChangeStrategy,
    RelativeRateOfChangeStrategy,
    SimpleThresholdStrategy,
)
from deequ_tpu_torch.anomaly.seasonal import HoltWinters, MetricInterval, SeriesSeasonality

__all__ = [
    "Anomaly",
    "AnomalyDetectionStrategy",
    "AnomalyDetector",
    "DetectionResult",
    "DataPoint",
    "extract_metric_values",
    "AbsoluteChangeStrategy",
    "BaseChangeStrategy",
    "BatchNormalStrategy",
    "OnlineNormalStrategy",
    "RateOfChangeStrategy",
    "RelativeRateOfChangeStrategy",
    "SimpleThresholdStrategy",
    "HoltWinters",
    "MetricInterval",
    "SeriesSeasonality",
]
