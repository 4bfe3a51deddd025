"""Canonical JSON serde for analysis results (the analogue of the
reference's Gson-based AnalysisResultSerde, repository/AnalysisResultSerde.
scala:38-635; the port's copy of ``deequ_tpu/repository/serde.py``). It
writes the same bytes as the reference's, so either package reads what the
other wrote, and a round trip (serialize then deserialize) is the identity
for every analyzer and metric type (tests/test_torch_repository.py)."""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLParameters,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalyzerContext
from deequ_tpu_torch.metrics import (
    BucketDistribution,
    BucketValue,
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    KeyedDoubleMetric,
    KLLMetric,
    Metric,
)
from deequ_tpu_torch.repository.base import AnalysisResult, ResultKey
from deequ_tpu_torch.tryresult import Failure, Success


def analyzer_to_json(analyzer: Analyzer) -> Dict[str, Any]:
    name = type(analyzer).__name__
    out: Dict[str, Any] = {"analyzerName": name}
    if isinstance(analyzer, Size):
        out["where"] = analyzer.where
    elif isinstance(
        analyzer,
        (Completeness, Minimum, Maximum, MinLength, MaxLength, Mean, Sum,
         StandardDeviation, ApproxCountDistinct, DataType),
    ):
        out["column"] = analyzer.column
        out["where"] = analyzer.where
    elif isinstance(analyzer, Compliance):
        out["instance"] = analyzer.instance_name
        out["expression"] = analyzer.predicate
        out["where"] = analyzer.where
    elif isinstance(analyzer, PatternMatch):
        out["column"] = analyzer.column
        out["pattern"] = analyzer.pattern
        out["where"] = analyzer.where
    elif isinstance(analyzer, Correlation):
        out["firstColumn"] = analyzer.first_column
        out["secondColumn"] = analyzer.second_column
        out["where"] = analyzer.where
    elif isinstance(
        analyzer, (Uniqueness, UniqueValueRatio, Distinctness, CountDistinct)
    ):
        out["columns"] = list(analyzer.columns)
    elif isinstance(analyzer, Entropy):
        out["column"] = analyzer.column
    elif isinstance(analyzer, MutualInformation):
        out["columns"] = list(analyzer.columns)
    elif isinstance(analyzer, Histogram):
        if analyzer.binning_udf is not None:
            raise ValueError(
                "Unable to serialize Histogram with binningUdf!"
            )  # mirrors the reference's restriction
        out["column"] = analyzer.column
        out["maxDetailBins"] = analyzer.max_detail_bins
    elif isinstance(analyzer, KLLSketch):
        out["column"] = analyzer.column
        if analyzer.kll_parameters is not None:
            p = analyzer.kll_parameters
            out["kllParameters"] = {
                "sketchSize": p.sketch_size,
                "shrinkingFactor": p.shrinking_factor,
                "numberOfBuckets": p.number_of_buckets,
            }
    elif isinstance(analyzer, ApproxQuantile):
        out["column"] = analyzer.column
        out["quantile"] = analyzer.quantile
        out["relativeError"] = analyzer.relative_error
        out["where"] = analyzer.where
    elif isinstance(analyzer, ApproxQuantiles):
        out["column"] = analyzer.column
        out["quantiles"] = list(analyzer.quantiles)
        out["relativeError"] = analyzer.relative_error
    else:
        raise ValueError(f"Unable to serialize analyzer {analyzer!r}")
    return out


def analyzer_from_json(data: Dict[str, Any]) -> Analyzer:
    name = data["analyzerName"]
    where = data.get("where")
    if name == "Size":
        return Size(where=where)
    if name == "Completeness":
        return Completeness(data["column"], where)
    if name == "Compliance":
        return Compliance(data["instance"], data["expression"], where)
    if name == "PatternMatch":
        return PatternMatch(data["column"], data["pattern"], where)
    if name in ("Minimum", "Maximum", "MinLength", "MaxLength", "Mean", "Sum",
                "StandardDeviation", "ApproxCountDistinct", "DataType"):
        cls = {
            "Minimum": Minimum, "Maximum": Maximum, "MinLength": MinLength,
            "MaxLength": MaxLength, "Mean": Mean, "Sum": Sum,
            "StandardDeviation": StandardDeviation,
            "ApproxCountDistinct": ApproxCountDistinct, "DataType": DataType,
        }[name]
        return cls(data["column"], where)
    if name == "Correlation":
        return Correlation(data["firstColumn"], data["secondColumn"], where)
    if name in ("Uniqueness", "UniqueValueRatio", "Distinctness", "CountDistinct"):
        cls = {
            "Uniqueness": Uniqueness, "UniqueValueRatio": UniqueValueRatio,
            "Distinctness": Distinctness, "CountDistinct": CountDistinct,
        }[name]
        return cls(tuple(data["columns"]))
    if name == "Entropy":
        return Entropy(data["column"])
    if name == "MutualInformation":
        return MutualInformation(tuple(data["columns"]))
    if name == "Histogram":
        return Histogram(data["column"], None, data.get("maxDetailBins", 1000))
    if name == "KLLSketch":
        params = None
        if "kllParameters" in data:
            p = data["kllParameters"]
            params = KLLParameters(
                p["sketchSize"], p["shrinkingFactor"], p["numberOfBuckets"]
            )
        return KLLSketch(data["column"], params)
    if name == "ApproxQuantile":
        return ApproxQuantile(
            data["column"], data["quantile"], data.get("relativeError", 0.01), where
        )
    if name == "ApproxQuantiles":
        return ApproxQuantiles(
            data["column"], data["quantiles"], data.get("relativeError", 0.01)
        )
    raise ValueError(f"Unable to deserialize analyzer {name}")


def _sanitize(value: float):
    if isinstance(value, float) and (math.isnan(value) or math.isinf(value)):
        return {"__special__": repr(value)}
    return value


def _unsanitize(value):
    if isinstance(value, dict) and "__special__" in value:
        return float(value["__special__"])
    return value


def metric_to_json(metric: Metric) -> Dict[str, Any]:
    base = {
        "entity": metric.entity.value,
        "instance": metric.instance,
        "name": metric.name,
    }
    if metric.value.is_failure:
        base["isSuccess"] = False
        base["error"] = str(metric.value.exception)
        base["metricType"] = type(metric).__name__
        return base
    base["isSuccess"] = True
    value = metric.value.get()
    if isinstance(metric, DoubleMetric):
        base["metricType"] = "DoubleMetric"
        base["value"] = _sanitize(value)
    elif isinstance(metric, KeyedDoubleMetric):
        base["metricType"] = "KeyedDoubleMetric"
        base["value"] = {k: _sanitize(v) for k, v in value.items()}
    elif isinstance(metric, HistogramMetric):
        base["metricType"] = "HistogramMetric"
        base["value"] = {
            "numberOfBins": value.number_of_bins,
            "values": {
                k: {"absolute": dv.absolute, "ratio": dv.ratio}
                for k, dv in value.values.items()
            },
        }
    elif isinstance(metric, KLLMetric):
        base["metricType"] = "KLLMetric"
        base["value"] = {
            "buckets": [
                {"lowValue": b.low_value, "highValue": b.high_value, "count": b.count}
                for b in value.buckets
            ],
            "parameters": list(value.parameters),
            "data": [list(buf) for buf in value.data],
        }
    else:
        raise ValueError(f"Unable to serialize metric {metric!r}")
    return base


def metric_from_json(data: Dict[str, Any]) -> Metric:
    entity = Entity(data["entity"])
    instance = data["instance"]
    name = data["name"]
    metric_type = data["metricType"]
    if not data.get("isSuccess", True):
        from deequ_tpu_torch.exceptions import MetricCalculationRuntimeException

        failure = Failure(MetricCalculationRuntimeException(data.get("error", "")))
        if metric_type == "HistogramMetric":
            return HistogramMetric(instance, failure, entity, name)
        if metric_type == "KLLMetric":
            return KLLMetric(instance, failure, entity, name)
        if metric_type == "KeyedDoubleMetric":
            return KeyedDoubleMetric(entity, name, instance, failure)
        return DoubleMetric(entity, name, instance, failure)
    value = data["value"]
    if metric_type == "DoubleMetric":
        return DoubleMetric(entity, name, instance, Success(_unsanitize(value)))
    if metric_type == "KeyedDoubleMetric":
        return KeyedDoubleMetric(
            entity, name, instance,
            Success({k: _unsanitize(v) for k, v in value.items()}),
        )
    if metric_type == "HistogramMetric":
        dist = Distribution(
            {
                k: DistributionValue(v["absolute"], v["ratio"])
                for k, v in value["values"].items()
            },
            value["numberOfBins"],
        )
        return HistogramMetric(instance, Success(dist), entity, name)
    if metric_type == "KLLMetric":
        dist = BucketDistribution(
            [
                BucketValue(b["lowValue"], b["highValue"], b["count"])
                for b in value["buckets"]
            ],
            tuple(value["parameters"]),
            tuple(tuple(buf) for buf in value["data"]),
        )
        return KLLMetric(instance, Success(dist), entity, name)
    raise ValueError(f"Unable to deserialize metric type {metric_type}")


def serialize(results: List[AnalysisResult]) -> str:
    payload = []
    for result in results:
        entries = []
        for analyzer, metric in result.analyzer_context.metric_map.items():
            try:
                a_json = analyzer_to_json(analyzer)
            except ValueError:
                continue  # non-serializable analyzers are skipped, like the reference
            entries.append({"analyzer": a_json, "metric": metric_to_json(metric)})
        payload.append(
            {
                "resultKey": {
                    "dataSetDate": result.result_key.data_set_date,
                    "tags": result.result_key.tags_dict,
                },
                "analyzerContext": entries,
            }
        )
    return json.dumps(payload)


def deserialize(text: str) -> List[AnalysisResult]:
    payload = json.loads(text)
    results = []
    for item in payload:
        key = ResultKey(
            item["resultKey"]["dataSetDate"], item["resultKey"].get("tags", {})
        )
        metric_map = {}
        for entry in item["analyzerContext"]:
            analyzer = analyzer_from_json(entry["analyzer"])
            metric_map[analyzer] = metric_from_json(entry["metric"])
        results.append(AnalysisResult(key, AnalyzerContext(metric_map)))
    return results
