"""Non-seasonal anomaly strategies (reference anomalydetection/*.scala)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.anomaly.base import FULL_INTERVAL, Anomaly, AnomalyDetectionStrategy

_DOUBLE_MIN = -float("inf")
_DOUBLE_MAX = float("inf")


@dataclass
class BaseChangeStrategy(AnomalyDetectionStrategy):
    """nth-order discrete difference outside [max_rate_decrease,
    max_rate_increase] (reference BaseChangeStrategy.scala:29-103)."""

    max_rate_decrease: Optional[float] = None
    max_rate_increase: Optional[float] = None
    order: int = 1

    _name = "AbsoluteChangeStrategy"

    def __post_init__(self):
        if self.max_rate_decrease is None and self.max_rate_increase is None:
            raise ValueError(
                "At least one of the two limits (maxRateDecrease or "
                "maxRateIncrease) has to be specified."
            )
        lo = self.max_rate_decrease if self.max_rate_decrease is not None else _DOUBLE_MIN
        hi = self.max_rate_increase if self.max_rate_increase is not None else _DOUBLE_MAX
        if lo > hi:
            raise ValueError(
                "The maximal rate of increase has to be bigger than the "
                "maximal rate of decrease."
            )
        if self.order < 0:
            raise ValueError("Order of derivative cannot be negative.")

    def diff(self, series: np.ndarray, order: int) -> np.ndarray:
        if order == 0 or len(series) == 0:
            return series
        return self.diff(series[1:] - series[:-1], order - 1)

    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval cannot be larger than the end.")
        series = np.asarray(data_series, dtype=np.float64)
        end = min(end, len(series))
        start_point = max(start - self.order, 0)
        data = self.diff(series[start_point:end], self.order)
        lo = self.max_rate_decrease if self.max_rate_decrease is not None else _DOUBLE_MIN
        hi = self.max_rate_increase if self.max_rate_increase is not None else _DOUBLE_MAX
        out = []
        for i, change in enumerate(data):
            if change < lo or change > hi:
                index = i + start_point + self.order
                out.append(
                    (
                        index,
                        Anomaly(
                            float(series[index]),
                            1.0,
                            f"[{self._name}]: Change of {change} is not in "
                            f"bounds [{lo}, {hi}]. Order={self.order}",
                        ),
                    )
                )
        return out


@dataclass
class AbsoluteChangeStrategy(BaseChangeStrategy):
    """(reference AbsoluteChangeStrategy.scala:33)"""


class RateOfChangeStrategy(AbsoluteChangeStrategy):
    """Deprecated alias of AbsoluteChangeStrategy
    (reference RateOfChangeStrategy.scala:27-28)."""

    _name = "RateOfChangeStrategy"


@dataclass
class RelativeRateOfChangeStrategy(BaseChangeStrategy):
    """Ratio current/previous at distance `order` outside bounds
    (reference RelativeRateOfChangeStrategy.scala:30-66)."""

    _name = "RelativeRateOfChangeStrategy"

    def diff(self, series: np.ndarray, order: int) -> np.ndarray:
        if order <= 0:
            raise ValueError("Order of diff cannot be zero or negative")
        if len(series) == 0:
            return series
        return series[order:] / series[:-order]


@dataclass
class SimpleThresholdStrategy(AnomalyDetectionStrategy):
    """Value outside [lower_bound, upper_bound]
    (reference SimpleThresholdStrategy.scala:25-57)."""

    lower_bound: float = _DOUBLE_MIN
    upper_bound: float = _DOUBLE_MAX

    def __post_init__(self):
        if self.lower_bound > self.upper_bound:
            raise ValueError("The lower bound must be smaller or equal to the upper bound.")

    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval cannot be larger than the end.")
        out = []
        for index in range(start, min(end, len(data_series))):
            value = data_series[index]
            if value < self.lower_bound or value > self.upper_bound:
                out.append(
                    (
                        index,
                        Anomaly(
                            float(value),
                            1.0,
                            f"[SimpleThresholdStrategy]: Value {value} is not in "
                            f"bounds [{self.lower_bound}, {self.upper_bound}]",
                        ),
                    )
                )
        return out


@dataclass
class OnlineNormalStrategy(AnomalyDetectionStrategy):
    """Streaming mean/variance (Welford) with z-score bounds; detected
    anomalies optionally excluded from the running statistics
    (reference OnlineNormalStrategy.scala:39-155)."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    ignore_start_percentage: float = 0.1
    ignore_anomalies: bool = True

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (
            self.upper_deviation_factor or 1.0
        ) < 0:
            raise ValueError("Factors cannot be smaller than zero.")
        if not (0.0 <= self.ignore_start_percentage <= 1.0):
            raise ValueError(
                "Percentage of start values to ignore must be in interval [0, 1]."
            )

    def compute_stats_and_anomalies(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ):
        results = []
        current_mean = 0.0
        current_variance = 0.0
        sn = 0.0
        num_to_skip = len(data_series) * self.ignore_start_percentage
        search_start, search_end = search_interval
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DOUBLE_MAX
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DOUBLE_MAX
        )
        for i, value in enumerate(data_series):
            last_mean, last_variance, last_sn = current_mean, current_variance, sn
            if i == 0:
                current_mean = value
            else:
                current_mean = last_mean + (1.0 / (i + 1)) * (value - last_mean)
            sn += (value - last_mean) * (value - current_mean)
            current_variance = sn / (i + 1)
            std_dev = math.sqrt(current_variance)
            upper = current_mean + upper_factor * std_dev
            lower = current_mean - lower_factor * std_dev
            if (
                i < num_to_skip
                or i < search_start
                or i >= search_end
                or (lower <= value <= upper)
            ):
                results.append((current_mean, std_dev, False))
            else:
                if self.ignore_anomalies:
                    current_mean, current_variance, sn = (
                        last_mean, last_variance, last_sn,
                    )
                results.append((current_mean, std_dev, True))
        return results

    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        search_start, search_end = search_interval
        if search_start > search_end:
            raise ValueError("The start of the interval can't be larger than the end.")
        stats = self.compute_stats_and_anomalies(data_series, search_interval)
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DOUBLE_MAX
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DOUBLE_MAX
        )
        out = []
        for index in range(search_start, min(search_end, len(stats))):
            mean, std_dev, is_anomaly = stats[index]
            if is_anomaly:
                lower = mean - lower_factor * std_dev
                upper = mean + upper_factor * std_dev
                out.append(
                    (
                        index,
                        Anomaly(
                            float(data_series[index]),
                            1.0,
                            f"[OnlineNormalStrategy]: Value {data_series[index]} "
                            f"is not in bounds [{lower}, {upper}].",
                        ),
                    )
                )
        return out


@dataclass
class BatchNormalStrategy(AnomalyDetectionStrategy):
    # NOTE: like the reference (BatchNormalStrategy.scala:33-95), calling
    # detect() without an explicit search interval raises — the strategy
    # needs values OUTSIDE the interval to train on. The defaulted trait
    # signature is kept for API parity.
    """Mean/stddev estimated from values outside (or including) the search
    interval; z-score bounds on the interval
    (reference BatchNormalStrategy.scala:33-95). Uses sample stddev (ddof=1)
    like breeze's meanAndVariance."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    include_interval: bool = False

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (
            self.upper_deviation_factor or 1.0
        ) < 0:
            raise ValueError("Factors cannot be smaller than zero.")

    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        search_start, search_end = search_interval
        if search_start > search_end:
            raise ValueError("The start of the interval can't be larger than the end.")
        if len(data_series) == 0:
            raise ValueError("Data series is empty. Can't calculate mean/ stdDev.")
        series = np.asarray(data_series, dtype=np.float64)
        search_end_clamped = min(search_end, len(series))
        interval_length = search_end_clamped - search_start
        if not self.include_interval and interval_length >= len(series):
            raise ValueError(
                "Excluding values in searchInterval from calculation but not "
                "enough values remain to calculate mean and stdDev."
            )
        if self.include_interval:
            training = series
        else:
            training = np.concatenate(
                [series[:search_start], series[search_end_clamped:]]
            )
        mean = float(training.mean())
        std_dev = float(training.std(ddof=1)) if len(training) > 1 else 0.0
        upper = mean + (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DOUBLE_MAX
        ) * std_dev
        lower = mean - (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DOUBLE_MAX
        ) * std_dev
        out = []
        for index in range(search_start, search_end_clamped):
            value = float(series[index])
            if value > upper or value < lower:
                out.append(
                    (
                        index,
                        Anomaly(
                            value,
                            1.0,
                            f"[BatchNormalStrategy]: Value {value} is not in "
                            f"bounds [{lower}, {upper}].",
                        ),
                    )
                )
        return out
