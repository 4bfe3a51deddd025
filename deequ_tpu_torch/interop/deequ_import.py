"""Readers for the persisted artifacts of deequ, the Scala/Spark system
(the port's copy of ``deequ_tpu/interop/deequ_import.py``, host code).

Binary state layout (analyzers/StateProvider.scala:186-311; Java
DataOutputStream, so every number is BIG-endian):

- Size                      -> i64 numMatches
- Completeness/Compliance/
  PatternMatch              -> i64 numMatches, i64 count
- Sum/Minimum/Maximum/
  MinLength/MaxLength       -> f64
- Mean                      -> f64 sum, i64 count
- StandardDeviation         -> f64 n, f64 avg, f64 m2
- Correlation               -> f64 n, xAvg, yAvg, ck, xMk, yMk
- DataType                  -> i32 length (=40), then 5 x i64:
                               null, fractional, integral, boolean,
                               string (DataType.scala:63-96)
- FrequencyBased/Histogram  -> Parquet of (grouping cols..., "absolute")
                               + sibling -num_rows.bin (i64)
- ApproxCountDistinct /
  ApproxQuantile            -> sketch blobs; REFUSED (different algebra)

File naming: ``{prefix}-{identifier}.bin`` where identifier is Scala's
``MurmurHash3.stringHash(analyzer.toString, 42).toString`` — a SIGNED
32-bit decimal (StateProvider.scala:83-85). The case-class toString
forms are reproduced in :func:`reference_analyzer_to_string`.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional

import numpy as np


# -- Scala MurmurHash3.stringHash -------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix(h: int, k: int) -> int:
    k = (k * 0xCC9E2D51) & _M32
    k = _rotl32(k, 15)
    k = (k * 0x1B873593) & _M32
    h ^= k
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _mix_last(h: int, k: int) -> int:
    k = (k * 0xCC9E2D51) & _M32
    k = _rotl32(k, 15)
    k = (k * 0x1B873593) & _M32
    return h ^ k


def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    """Canonical MurmurHash3 x86_32 over bytes (Austin Appleby's
    MurmurHash3.cpp), built from the SAME ``_mix``/``_mix_last``/``_fmix``
    primitives ``scala_murmur3_string_hash`` uses — Scala's MurmurHash3
    class implements exactly these constants/rotations, so pinning this
    function against the published Appleby/SMHasher test vectors
    (tests/test_interop.py) pins the primitives the state-file identifier
    hash is wired from. Returns the UNSIGNED 32-bit value."""
    h = seed & _M32
    n_blocks = len(data) & ~3
    for i in range(0, n_blocks, 4):
        h = _mix(h, int.from_bytes(data[i:i + 4], "little"))
    tail = data[n_blocks:]
    if tail:
        h = _mix_last(h, int.from_bytes(tail, "little"))
    return _fmix((h ^ len(data)) & _M32)


def scala_murmur3_string_hash(s: str, seed: int = 42) -> int:
    """scala.util.hashing.MurmurHash3.stringHash: UTF-16 CODE UNITS
    combined pairwise into one 32-bit word per mix step, trailing unit
    via mixLast, finalized with the length in UTF-16 units (non-BMP
    characters count as two surrogates, like a JVM String). Returns the
    SIGNED 32-bit value Scala's Int.toString would print.

    Implemented from the published Scala source; this environment has no
    JVM to capture golden values against, so if an identifier does not
    resolve against a real deployment's files, pass the identifier
    observed in the file name explicitly (load_reference_state's
    ``identifier=``)."""
    # UTF-16-BE bytes -> code units (surrogate pairs stay split;
    # surrogatepass also admits lone surrogates, which a JVM String can
    # legally hold)
    raw = s.encode("utf-16-be", "surrogatepass")
    chars = [
        (raw[i] << 8) | raw[i + 1] for i in range(0, len(raw), 2)
    ]
    h = seed & _M32
    i = 0
    n = len(chars)
    while i + 1 < n:
        h = _mix(h, ((chars[i] << 16) + chars[i + 1]) & _M32)
        i += 2
    if i < n:
        h = _mix_last(h, chars[i])
    h = _fmix((h ^ n) & _M32)
    return h - (1 << 32) if h >= (1 << 31) else h


# -- analyzer identity -------------------------------------------------------


def _opt(where: Optional[str]) -> str:
    return "None" if where is None else f"Some({where})"


def reference_analyzer_to_string(analyzer) -> str:
    """The Scala case-class ``toString`` of the matching reference
    analyzer (what HdfsStateProvider hashes into the file identifier)."""
    from deequ_tpu_torch import analyzers as A

    a = analyzer
    w = _opt(getattr(a, "where", None))
    name = type(a).__name__
    simple = {
        "Size": lambda: f"Size({w})",
        "Completeness": lambda: f"Completeness({a.column},{w})",
        "Sum": lambda: f"Sum({a.column},{w})",
        "Mean": lambda: f"Mean({a.column},{w})",
        "Minimum": lambda: f"Minimum({a.column},{w})",
        "Maximum": lambda: f"Maximum({a.column},{w})",
        "MinLength": lambda: f"MinLength({a.column},{w})",
        "MaxLength": lambda: f"MaxLength({a.column},{w})",
        "StandardDeviation": lambda: f"StandardDeviation({a.column},{w})",
        "DataType": lambda: f"DataType({a.column},{w})",
        "ApproxCountDistinct": lambda: f"ApproxCountDistinct({a.column},{w})",
    }
    if name in simple:
        return simple[name]()
    if isinstance(a, A.Compliance):
        return f"Compliance({a.instance_name},{a.predicate},{w})"
    if isinstance(a, A.PatternMatch):
        return f"PatternMatch({a.column},{a.pattern},{w})"
    if isinstance(a, A.Correlation):
        return f"Correlation({a.first_column},{a.second_column},{w})"
    if isinstance(
        a, (A.Uniqueness, A.UniqueValueRatio, A.Distinctness, A.CountDistinct,
            A.MutualInformation)
    ):
        # these reference case classes have NO where parameter
        # (Uniqueness.scala:26, CountDistinct.scala:24, ...)
        cols = ", ".join(a.columns)
        return f"{name}(List({cols}))"
    if isinstance(a, A.Entropy):
        return f"Entropy({a.column})"
    if isinstance(a, A.Histogram):
        # Histogram(column, binningUdf = None, maxDetailBins)
        # (Histogram.scala:41-44)
        return f"Histogram({a.column},None,{a.max_detail_bins})"
    raise ValueError(
        f"no reference toString mapping for analyzer {analyzer!r}; pass the "
        f"Scala toString (or the identifier) explicitly"
    )


def reference_state_identifier(analyzer_or_tostring) -> str:
    """The ``{identifier}`` of the reference's state file name: Scala
    murmur3 of the analyzer's toString, seed 42 (StateProvider.scala:83).
    Accepts an analyzer instance or the raw Scala toString."""
    s = (
        analyzer_or_tostring
        if isinstance(analyzer_or_tostring, str)
        else reference_analyzer_to_string(analyzer_or_tostring)
    )
    return str(scala_murmur3_string_hash(s, 42))


# -- binary state readers ----------------------------------------------------

_SKETCH_REFUSAL = (
    "the reference's {what} state is a sketch whose algebra differs from "
    "this framework's by design ({why}); it cannot be imported — recompute "
    "the state here (portable states: counts, min/max, moments, DataType "
    "histogram, frequency tables)"
)


def load_reference_state(prefix: str, analyzer, identifier: Optional[str] = None):
    """Read one analyzer's persisted reference state into the matching
    port State. ``prefix`` is the HdfsStateProvider locationPrefix
    (local paths here). Sketch states refuse with the algebra rationale."""
    from deequ_tpu_torch import analyzers as A
    from deequ_tpu_torch.analyzers import states as S

    name = type(analyzer).__name__
    if isinstance(analyzer, A.ApproxCountDistinct):
        raise ValueError(
            _SKETCH_REFUSAL.format(
                what="HLL++",
                why="Spark xxHash64 words + bias tables vs the u32 fmix32 "
                "suite with an Ertl estimator, ops/hll.py",
            )
        )
    if isinstance(analyzer, (A.ApproxQuantile, A.ApproxQuantiles, A.KLLSketch)):
        raise ValueError(
            _SKETCH_REFUSAL.format(
                what="quantile-digest",
                why="Spark's QuantileSummaries digest vs device-strata KLL, "
                "ops/kll_device.py",
            )
        )

    ident = identifier or reference_state_identifier(analyzer)
    path = f"{prefix}-{ident}.bin"

    if isinstance(
        analyzer,
        (A.Uniqueness, A.UniqueValueRatio, A.Distinctness, A.CountDistinct,
         A.Entropy, A.MutualInformation, A.Histogram),
    ):
        return _load_frequencies(prefix, ident, analyzer)

    with open(path, "rb") as f:
        buf = f.read()

    def i64(off):
        return struct.unpack_from(">q", buf, off)[0]

    def f64(off):
        return struct.unpack_from(">d", buf, off)[0]

    if isinstance(analyzer, A.Size):
        return S.NumMatches(i64(0))
    if isinstance(analyzer, (A.Completeness, A.Compliance, A.PatternMatch)):
        return S.NumMatchesAndCount(i64(0), i64(8))
    if isinstance(analyzer, A.Sum):
        return S.SumState(f64(0))
    if isinstance(analyzer, A.Mean):
        return S.MeanState(f64(0), i64(8))
    if isinstance(analyzer, (A.Minimum, A.MinLength)):
        return S.MinState(f64(0))
    if isinstance(analyzer, (A.Maximum, A.MaxLength)):
        return S.MaxState(f64(0))
    if isinstance(analyzer, A.StandardDeviation):
        return S.StandardDeviationState(f64(0), f64(8), f64(16))
    if isinstance(analyzer, A.Correlation):
        return S.CorrelationState(
            f64(0), f64(8), f64(16), f64(24), f64(32), f64(40)
        )
    if isinstance(analyzer, A.DataType):
        (length,) = struct.unpack_from(">i", buf, 0)
        if length != 40:
            raise ValueError(
                f"DataType histogram blob should be 40 bytes, got {length}"
            )
        vals = struct.unpack_from(">5q", buf, 4)
        # reference order: null, fractional, integral, boolean, string
        return S.DataTypeHistogram(
            num_null=vals[0], num_fractional=vals[1], num_integral=vals[2],
            num_boolean=vals[3], num_string=vals[4],
        )
    raise ValueError(f"no reference state reader for analyzer {analyzer!r}")


def _load_frequencies(prefix: str, ident: str, analyzer):
    """FrequenciesAndNumRows from the reference's Parquet + num_rows.bin
    (StateProvider.scala:persistDataframeLongState). The Parquet carries
    the grouping columns plus the i64 count column ``absolute``."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.data.io import read_parquet

    with open(f"{prefix}-{ident}-num_rows.bin", "rb") as f:
        (num_rows,) = struct.unpack(">q", f.read(8))
    table = read_parquet(f"{prefix}-{ident}-frequencies.pqt")
    group_cols = [c for c in table.column_names if c != "absolute"]
    counts = table["absolute"]
    # a null count row carries no information — drop the whole ROW so
    # keys and counts stay aligned (normal files are all-valid)
    keep = np.asarray(counts.mask, dtype=bool)
    count_arr = counts.values[keep].astype(np.int64)
    key_values = []
    key_nulls = []
    for c in group_cols:
        col = table[c]
        if col.dtype.name == "STRING":
            dic = np.asarray(col.dictionary)
            vals = np.where(
                col.codes >= 0, dic[np.maximum(col.codes, 0)], ""
            ).astype(np.str_)
            nulls = col.codes < 0
        else:
            vals = col.values
            nulls = ~col.mask
        key_values.append(np.asarray(vals)[keep])
        key_nulls.append(np.asarray(nulls, dtype=bool)[keep])
    return FrequenciesAndNumRows(
        tuple(group_cols), tuple(key_values), tuple(key_nulls),
        count_arr, int(num_rows),
    )


# -- Gson repository JSON ----------------------------------------------------


def _analyzer_from_gson(obj: Dict[str, Any]):
    """AnalyzerDeserializer (AnalysisResultSerde.scala:360-482), exact
    field names — note Compliance uses "predicate" in the reference JSON
    where this package's own serde says "expression"."""
    from deequ_tpu_torch import analyzers as A

    name = obj["analyzerName"]
    where = obj.get("where")

    def cols():
        return list(obj["columns"])

    if name == "Size":
        return A.Size(where=where)
    if name == "Completeness":
        return A.Completeness(obj["column"], where)
    if name == "Compliance":
        return A.Compliance(obj["instance"], obj["predicate"], where)
    if name == "PatternMatch":
        return A.PatternMatch(obj["column"], obj["pattern"], where)
    if name in ("Sum", "Mean", "Minimum", "Maximum", "MinLength", "MaxLength",
                "StandardDeviation", "DataType", "ApproxCountDistinct"):
        cls = getattr(A, name)
        return cls(obj["column"], where)
    if name == "CountDistinct":
        return A.CountDistinct(cols())
    if name == "Distinctness":
        return A.Distinctness(cols())
    if name == "Entropy":
        return A.Entropy(obj["column"])
    if name == "MutualInformation":
        return A.MutualInformation(cols())
    if name == "UniqueValueRatio":
        return A.UniqueValueRatio(cols())
    if name == "Uniqueness":
        return A.Uniqueness(cols())
    if name == "Histogram":
        return A.Histogram(obj["column"], max_detail_bins=obj["maxDetailBins"])
    if name == "Correlation":
        return A.Correlation(obj["firstColumn"], obj["secondColumn"], where)
    if name == "ApproxQuantile":
        return A.ApproxQuantile(
            obj["column"], obj["quantile"],
            relative_error=obj.get("relativeError", 0.01),
        )
    if name == "ApproxQuantiles":
        qs = [float(q) for q in str(obj["quantiles"]).split(",")]
        return A.ApproxQuantiles(
            obj["column"], tuple(qs),
            relative_error=obj.get("relativeError", 0.01),
        )
    raise ValueError(f"Unable to deserialize analyzer {name}")


def _metric_from_gson(obj: Dict[str, Any]):
    """MetricDeserializer (AnalysisResultSerde.scala:546-592)."""
    from deequ_tpu_torch.metrics import (
        Distribution,
        DistributionValue,
        DoubleMetric,
        Entity,
        HistogramMetric,
        KeyedDoubleMetric,
    )
    from deequ_tpu_torch.tryresult import Try

    # the reference's Entity enum spells it "Mutlicolumn"
    # (metrics/Metric.scala:22) — accept both spellings
    entity_map = {
        "Dataset": Entity.DATASET,
        "Column": Entity.COLUMN,
        "Mutlicolumn": Entity.MULTICOLUMN,
        "Multicolumn": Entity.MULTICOLUMN,
    }

    kind = obj["metricName"]
    if kind == "DoubleMetric":
        return DoubleMetric(
            entity_map[obj["entity"]], obj["name"], obj["instance"],
            Try.of(lambda: float(obj["value"])),
        )
    if kind == "HistogramMetric":
        dist = obj["value"]
        values = {
            key: DistributionValue(int(v["absolute"]), float(v["ratio"]))
            for key, v in dist["values"].items()
        }
        return HistogramMetric(
            obj["column"],
            Try.of(lambda: Distribution(values, int(dist["numberOfBins"]))),
        )
    if kind == "KeyedDoubleMetric":
        values = {k: float(v) for k, v in obj.get("value", {}).items()}
        return KeyedDoubleMetric(
            entity_map[obj["entity"]], obj["name"], obj["instance"],
            Try.of(lambda: values),
        )
    raise ValueError(f"Unable to deserialize metric {kind}")


def import_analysis_results(json_str: str) -> List:
    """Parse the reference's Gson AnalysisResult JSON (the output of
    AnalysisResultSerde.serialize) into the port's AnalysisResults."""
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext
    from deequ_tpu_torch.repository.base import AnalysisResult, ResultKey

    out = []
    for entry in json.loads(json_str):
        rk = entry["resultKey"]
        key = ResultKey(int(rk["dataSetDate"]), dict(rk.get("tags") or {}))
        ctx = AnalyzerContext.empty()
        for pair in entry["analyzerContext"]["metricMap"]:
            analyzer = _analyzer_from_gson(pair["analyzer"])
            ctx.metric_map[analyzer] = _metric_from_gson(pair["metric"])
        out.append(AnalysisResult(key, ctx))
    return out


def import_repository_json(json_str: str, repository) -> int:
    """Load a Scala deequ metrics-repository JSON into a MetricsRepository
    of this package (memory, filesystem or columnar): the migrated history
    immediately feeds ``is_newest_point_non_anomalous`` / anomaly checks.
    Returns the number of results imported."""
    results = import_analysis_results(json_str)
    for result in results:
        repository.save(result)
    return len(results)
