"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made from a seed with numpy, go through ``deequ_tpu``
(the reference, JAX on the CPU) and ``deequ_tpu_torch`` (the port, torch on
the CPU), and the results are compared under the bounds below:

- exact: counts, completeness, compliance, min/max, group statistics;
- relative 1e-12: sums, means, entropy;
- relative 1e-10: standard deviation and correlation — the reference sums
  in df32 pairs (~1e-13 off f64, docs/numerics.md) and the port sums f64
  in another order.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from deequ_tpu.data.table import Column as RefColumn
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.data.table import DType as RefDType
from deequ_tpu_torch.interop import table_from_arrays

REL_BOUNDS = {
    "Sum": 1e-12,
    "Mean": 1e-12,
    "Entropy": 1e-12,
    "StandardDeviation": 1e-10,
    "Correlation": 1e-10,
}


@pytest.fixture
def parity_env(monkeypatch):
    """One torch thread (tier-1 runs several pytest workers) and both
    packages' host-path thresholds at 0, so grouping takes the device
    path on both sides."""
    import deequ_tpu.ops.segment as ref_segment
    import deequ_tpu_torch.ops.segment as port_segment

    monkeypatch.setattr(ref_segment, "HOST_GROUP_LIMIT", 0)
    monkeypatch.setattr(port_segment, "HOST_GROUP_LIMIT", 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_table(ref: RefTable):
    """The port's table holding exactly the arrays of a reference table."""
    specs = []
    for col in ref.columns.values():
        if col.dtype == RefDType.STRING:
            specs.append({"name": col.name, "dtype": "string",
                          "codes": col.codes, "dictionary": col.dictionary})
        else:
            specs.append({"name": col.name, "dtype": col.dtype.value,
                          "values": col.values, "mask": col.mask})
    return table_from_arrays(specs)


def ref_column(name, dtype: str, values=None, mask=None, codes=None, dictionary=None):
    if dtype == "string":
        return RefColumn(name, RefDType.STRING, codes=codes,
                         dictionary=np.asarray(dictionary, dtype=object))
    return RefColumn(name, RefDType(dtype), values=values, mask=mask)


def smoke_schema_table(rows: int, seed: int, width: int = 4) -> RefTable:
    """The chip-smoke schema (chip_smoke.py:make_table) at a small width:
    ``width`` float columns with 1% nulls (the last with mean 1e6 and unit
    spread), an all-distinct int64 id, a Zipf-skewed int64 customer id,
    and string columns of 8 and 200 values."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(width):
        if j == width - 1:
            values = 1e6 + rng.standard_normal(rows)
        else:
            values = rng.normal(loc=10.0 * j + 5.0, scale=1.0 + j, size=rows)
        cols.append(ref_column(f"f{j}", "fractional", values, rng.random(rows) >= 0.01))
    cols.append(ref_column("id", "integral", rng.permutation(rows).astype(np.int64),
                           np.ones(rows, dtype=bool)))
    n_cust = rows // 8
    p = np.arange(1, n_cust + 1, dtype=np.float64) ** -0.7
    ranks = rng.choice(n_cust, size=rows, p=p / p.sum())
    cols.append(ref_column("customer_id", "integral",
                           1000 + 3 * rng.permutation(n_cust)[ranks].astype(np.int64),
                           rng.random(rows) >= 0.01))
    status = rng.choice(8, size=rows).astype(np.int32)
    cols.append(ref_column("status", "string", codes=status,
                           dictionary=[f"S{i}" for i in range(8)]))
    region = rng.integers(0, 200, size=rows).astype(np.int32)
    region[rng.random(rows) < 0.005] = -1
    cols.append(ref_column("region", "string", codes=region,
                           dictionary=[f"R{i:04d}" for i in range(200)]))
    return RefTable(cols)


def _same_value(a: float, b: float, rel: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b) or rel == 0.0:
        return a == b
    return abs(a - b) <= rel * max(abs(a), abs(b))


def assert_metric_parity(ref_metric, port_metric) -> None:
    """One metric of the reference against the port's, under the bounds
    of the module doc; failures must be the same failure."""
    assert port_metric.name == ref_metric.name
    assert port_metric.instance == ref_metric.instance
    assert port_metric.entity.value == ref_metric.entity.value
    if not ref_metric.value.is_success:
        assert not port_metric.value.is_success, (ref_metric, port_metric)
        ref_exc, port_exc = ref_metric.value.exception, port_metric.value.exception
        assert type(port_exc).__name__ == type(ref_exc).__name__
        assert str(port_exc) == str(ref_exc)
        return
    assert port_metric.value.is_success, (ref_metric, port_metric)
    a, b = ref_metric.value.get(), port_metric.value.get()
    rel = REL_BOUNDS.get(ref_metric.name, 0.0)
    assert _same_value(a, b, rel), (
        f"{ref_metric.name}({ref_metric.instance}): reference {a!r} vs port {b!r}"
        f" (bound {'exact' if rel == 0.0 else rel})"
    )
