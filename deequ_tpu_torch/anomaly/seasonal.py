"""Holt-Winters seasonal anomaly detection
(reference anomalydetection/seasonal/HoltWinters.scala:63-249; the port's
copy of ``deequ_tpu/anomaly/seasonal.py``).

Additive triple exponential smoothing ETS(A,A). The reference deequ fits
(alpha, beta, gamma) with breeze's L-BFGS-B over approximate gradients of
the residual sum of squares; this package fits them with Adam over exact
gradients (a sigmoid reparameterization keeps them inside (0, 1)), as
``deequ_tpu`` does. The fit runs on the run's device
(``ops/holt_winters.py``): on a card, one launch of the hand-written
kernel of ``csrc/holt_winters.cu``; on the CPU, its plain autograd
version. The forecast recursion itself (``additive_holt_winters``) stays
host numpy, as in the reference.
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.anomaly.base import FULL_INTERVAL, Anomaly, AnomalyDetectionStrategy


class MetricInterval(enum.Enum):
    DAILY = "Daily"
    MONTHLY = "Monthly"


class SeriesSeasonality(enum.Enum):
    WEEKLY = "Weekly"
    YEARLY = "Yearly"


def additive_holt_winters(
    series: np.ndarray,
    periodicity: int,
    number_of_points_to_forecast: int,
    alpha: float,
    beta: float,
    gamma: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the ETS(A,A) recursion (host reference implementation).

    Returns (forecasts beyond the series, one-step-ahead residuals).
    Initialization mirrors the reference: level = mean of first period,
    trend = (mean of 2nd period - mean of 1st) / periodicity, seasonality =
    first period minus initial level (HoltWinters.scala:88-116).
    """
    n = len(series)
    p = periodicity
    level = [series[:p].sum() / p]
    trend = [(series[p:2 * p].sum() - series[:p].sum()) / (p * p)]
    seasonality = list(series[:p] - level[0])
    y = [level[0] + trend[0] + seasonality[0]]
    extended = list(series)
    for t in range(n + number_of_points_to_forecast):
        if t >= n:
            extended.append(level[-1] + trend[-1] + seasonality[len(seasonality) - p])
        level.append(
            alpha * (extended[t] - seasonality[t])
            + (1 - alpha) * (level[t] + trend[t])
        )
        trend.append(beta * (level[t + 1] - level[t]) + (1 - beta) * trend[t])
        seasonality.append(
            gamma * (extended[t] - level[t] - trend[t]) + (1 - gamma) * seasonality[t]
        )
        y.append(level[t + 1] + trend[t + 1] + seasonality[t + 1])
    residuals = np.array([series[i] - y[i] for i in range(n)])
    forecasts = np.array(extended[n:])
    return forecasts, residuals


def _fit_parameters(
    series: np.ndarray, periodicity: int, device=None
) -> Tuple[float, float, float]:
    """Fit (alpha, beta, gamma) by minimising the residual sum of squares
    of the one-step-ahead forecasts, with exact gradients, on ``device``
    (default: ``cuda``, or the ambient ``use_device`` scope): one kernel
    launch on a card, the plain autograd fit on the CPU."""
    from deequ_tpu_torch.device import resolve_device
    from deequ_tpu_torch.ops import holt_winters
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(series, dtype=np.float64), device=dev)
    fitted = holt_winters.fit(s, periodicity).cpu().numpy()
    # the fit's one device->host copy, charged to bytes_fetched only:
    # device_fetches counts the one fetch of each scan pass
    SCAN_STATS.bump(bytes_fetched=fitted.nbytes)
    a, b, g = (float(x) for x in fitted)
    return a, b, g


class HoltWinters(AnomalyDetectionStrategy):
    def __init__(
        self,
        metrics_interval: MetricInterval,
        seasonality: SeriesSeasonality,
    ):
        pair = (seasonality, metrics_interval)
        if pair == (SeriesSeasonality.WEEKLY, MetricInterval.DAILY):
            self.series_periodicity = 7
        elif pair == (SeriesSeasonality.YEARLY, MetricInterval.MONTHLY):
            self.series_periodicity = 12
        else:
            raise ValueError(
                "Supported combinations: (Daily metrics, Weekly seasonality) "
                "or (Monthly metrics, Yearly seasonality)"
            )

    # NOTE: like the reference (HoltWinters.scala), detect() requires a
    # search interval leaving >= two full seasonal cycles of training data
    # BEFORE the interval; the defaulted trait signature (start=0) raises
    # by construction and is kept only for API parity.
    def detect(
        self,
        data_series: Sequence[float],
        search_interval: Tuple[int, int] = FULL_INTERVAL,
    ) -> List[Tuple[int, Anomaly]]:
        if len(data_series) == 0:
            raise ValueError("Provided data series is empty")
        start, end = search_interval
        if start >= end:
            raise ValueError("Start must be before end")
        if start < 0 or end < 0:
            raise ValueError("The search interval needs to be strictly positive")
        if start < self.series_periodicity * 2:
            raise ValueError("Need at least two full cycles of data to estimate model")

        series = np.asarray(data_series, dtype=np.float64)
        if start >= len(series):
            number_to_forecast = 1
        else:
            number_to_forecast = min(end, len(series)) - start

        training = series[:start]
        alpha, beta, gamma = _fit_parameters(training, self.series_periodicity)

        forecasts, residuals = additive_holt_winters(
            training, self.series_periodicity, number_to_forecast, alpha, beta, gamma
        )
        abs_residuals = np.abs(residuals)
        residual_sd = (
            float(abs_residuals.std(ddof=1)) if len(abs_residuals) > 1 else 0.0
        )

        test_series = series[start:]
        out = []
        for i, (observed, forecast) in enumerate(zip(test_series, forecasts)):
            if abs(observed - forecast) > 1.96 * residual_sd:
                out.append(
                    (
                        i + start,
                        Anomaly(
                            float(observed),
                            1.0,
                            f"Forecasted {forecast} for observed value {observed}",
                        ),
                    )
                )
        return out
