"""The whole slice: VerificationSuite.on_data(table).add_check(check).run()
through the reference and the port, on the CPU.

- examples/basic_example.py's table and check set, and a seeded 50k-row
  table with the chip-smoke schema at a small width, through both
  packages: the same check_results_as_rows and every metric under the
  bounds of tests/torch_parity.py;
- states computed by the reference, carried across with
  ``state_from_fields``, finalize to the reference's metrics;
- importing the port pulls in neither jax nor deequ_tpu (a subprocess);
- without CUDA and without a CPU request, run() raises
  DeviceUnavailableException; checks the slice cannot run are refused
  when they are built.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deequ_tpu
import deequ_tpu.analyzers as ref_analyzers
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as port_analyzers
from deequ_tpu.verification import VerificationResult as RefResult
from deequ_tpu_torch.interop import state_from_fields
from deequ_tpu_torch.ops import histogram_device
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
from deequ_tpu_torch.verification import VerificationResult as PortResult
from torch_parity import (  # noqa: F401
    assert_metric_parity,
    parity_env,
    port_table,
    smoke_schema_table,
)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _basic_check(pkg):
    """The check set of examples/basic_example.py, built in ``pkg``."""
    return (
        pkg.Check(pkg.CheckLevel.ERROR, "integrity checks")
        .has_size(lambda n: n == 5)
        .is_complete("id")
        .is_unique("id")
        .is_complete("productName")
        .is_contained_in("priority", ["high", "low"])
        .is_non_negative("numViews")
    )


BASIC_DATA = {
    "id": [1, 2, 3, 4, 5],
    "productName": ["thingA", "thingB", None, "thingD", "thingE"],
    "priority": ["high", "low", "high", "low", "high"],
    "numViews": [0, 5, 10, 3, 12],
}


def _smoke_check(pkg):
    """The chip-smoke check set at the small width of smoke_schema_table."""
    check = (
        pkg.Check(pkg.CheckLevel.ERROR, "smoke")
        .has_size(lambda n: n > 0)
        .is_complete("id")
        .has_completeness("f0", lambda v: v > 0.9)
    )
    for j in range(4):
        c = f"f{j}"
        check = (check.has_min(c, lambda v: True).has_max(c, lambda v: True)
                 .has_mean(c, lambda v: True).has_sum(c, lambda v: True)
                 .has_standard_deviation(c, lambda v: v > 0))
    return (
        check.has_correlation("f0", "f1", lambda v: -1.0 <= v <= 1.0)
        .is_non_negative("f2", lambda v: v > 0)
        .is_contained_in("status", [f"S{i}" for i in range(7)], lambda v: v > 0.5)
        .satisfies("f1 > 14", "f1 above 14", lambda v: v > 0.99)
        .where("status = 'S1'")
        .is_unique("id")
        .has_uniqueness(["customer_id"], lambda v: 0 < v < 1)
        .has_distinctness(["status"], lambda v: v > 0)
        .has_entropy("region", lambda v: v > 0)
        .has_unique_value_ratio(["customer_id"], lambda v: 0 < v < 1)
    )


def _run_both(ref_table, check_fn, required=()):
    ref_result = (
        deequ_tpu.VerificationSuite.on_data(ref_table)
        .add_check(check_fn(deequ_tpu))
        .add_required_analyzers([getattr(ref_analyzers, n)(*a) for n, a in required])
        .run()
    )
    port_result = (
        deequ_tpu_torch.VerificationSuite.on_data(port_table(ref_table), device="cpu")
        .add_check(check_fn(deequ_tpu_torch))
        .add_required_analyzers([getattr(port_analyzers, n)(*a) for n, a in required])
        .run()
    )
    return ref_result, port_result


# The reference's default compute path ships a fractional column that no
# predicate compares as a (hi, lo) f32 pair: hi + lo carries ~48 bits, so
# its Minimum/Maximum of such a column can sit up to 2^-48 (relative) off
# the f64 data value (docs/numerics.md calls them exact; they are exact on
# its wide-f64 plane and under DEEQU_TPU_COMPUTE=f64). The port computes in
# f64: its extrema are the data values themselves, which the pair-mode
# comparison checks against numpy exactly.
PAIR_EXTREMUM_REL = 2.0 ** -48


def _assert_results_agree(ref_result, port_result, ref_table=None):
    assert port_result.status.value == ref_result.status.value
    assert PortResult.check_results_as_rows(port_result) == RefResult.check_results_as_rows(
        ref_result
    )
    ref_metrics = {repr(a): m for a, m in ref_result.metrics.items()}
    port_metrics = {repr(a): m for a, m in port_result.metrics.items()}
    assert set(port_metrics) == set(ref_metrics)
    for key, ref_metric in ref_metrics.items():
        port_metric = port_metrics[key]
        if ref_table is not None and ref_metric.name in ("Minimum", "Maximum"):
            col = ref_table[ref_metric.instance]
            valid = col.values[col.mask]
            exact = valid.min() if ref_metric.name == "Minimum" else valid.max()
            assert port_metric.value.get() == exact
            ref_value = ref_metric.value.get()
            assert abs(ref_value - exact) <= PAIR_EXTREMUM_REL * abs(exact)
            continue
        assert_metric_parity(ref_metric, port_metric)


def test_basic_example_parity(parity_env):
    ref_result, port_result = _run_both(
        deequ_tpu.ColumnarTable.from_pydict(BASIC_DATA), _basic_check
    )
    _assert_results_agree(ref_result, port_result)
    assert port_result.status == deequ_tpu_torch.CheckStatus.ERROR  # productName has a null
    assert port_result.device == "cpu"


def test_result_rows_and_json_parity(parity_env):
    """success_metrics_as_rows / _as_json and check_results_as_json agree
    between the packages on the basic example (the port's run saving its
    states on the way)."""
    import json

    from deequ_tpu_torch.states import InMemoryStateProvider

    ref_table = deequ_tpu.ColumnarTable.from_pydict(BASIC_DATA)
    ref_result = deequ_tpu.VerificationSuite.on_data(ref_table).add_check(
        _basic_check(deequ_tpu)).run()
    port_result = (
        deequ_tpu_torch.VerificationSuite.on_data(port_table(ref_table), device="cpu")
        .add_check(_basic_check(deequ_tpu_torch))
        .save_states_with(InMemoryStateProvider())
        .run()
    )
    assert PortResult.success_metrics_as_rows(port_result) == RefResult.success_metrics_as_rows(
        ref_result)
    assert json.loads(PortResult.success_metrics_as_json(port_result)) == json.loads(
        RefResult.success_metrics_as_json(ref_result))
    assert PortResult.check_results_as_json(port_result) == RefResult.check_results_as_json(
        ref_result)


def test_basic_example_from_pydict_builds_the_same_table():
    ref = deequ_tpu.ColumnarTable.from_pydict(BASIC_DATA)
    port = deequ_tpu_torch.ColumnarTable.from_pydict(BASIC_DATA)
    for name in BASIC_DATA:
        assert port[name].dtype.value == ref[name].dtype.value
        assert port[name].to_pylist() == ref[name].to_pylist()


@pytest.mark.parametrize("mode", ["f64", "pairs"])
def test_smoke_schema_suite_parity(parity_env, monkeypatch, mode):
    if mode == "f64":
        monkeypatch.setenv("DEEQU_TPU_COMPUTE", "f64")
    table = smoke_schema_table(50_000, seed=5)
    SCAN_STATS.reset()
    ref_result, port_result = _run_both(
        table, _smoke_check, required=[("CountDistinct", (["customer_id"],))],
    )
    _assert_results_agree(ref_result, port_result, table if mode == "pairs" else None)
    assert all(m.value.is_success for m in port_result.metrics.values())
    assert port_result.scan_stats["scan_passes"] == 1
    assert port_result.scan_stats["grouping_passes"] == 4
    assert SCAN_STATS.last_scan_fetches == 1
    # at 50k rows every grouping set's key space is dense (id's too), and
    # cross-set fusion counts the four sets in one dispatch
    assert SCAN_STATS.hist_plain_dispatches == 1
    assert SCAN_STATS.fused_group_passes == 4


# (state class, analyzer spec): states the reference computes from data
CARRIED = [
    ("NumMatches", ("Size", ())),
    ("NumMatchesAndCount", ("Completeness", ("f0",))),
    ("NumMatchesAndCount", ("Compliance", ("pos", "f1 > 15"))),
    ("MinState", ("Minimum", ("f0",))),
    ("MaxState", ("Maximum", ("f2",))),
    ("MeanState", ("Mean", ("f3",))),
    ("SumState", ("Sum", ("f1",))),
    ("StandardDeviationState", ("StandardDeviation", ("f3",))),
    ("CorrelationState", ("Correlation", ("f0", "f1"))),
]


@pytest.mark.parametrize("kind,spec", CARRIED, ids=[s[0] for _, s in CARRIED])
def test_state_from_fields_finalizes_to_reference_metric(kind, spec):
    table = smoke_schema_table(2000, seed=9)
    name, args = spec
    ref_analyzer = getattr(ref_analyzers, name)(*args)
    port_analyzer = getattr(port_analyzers, name)(*args)
    ref_state = ref_analyzer.compute_state_from(table)
    assert type(ref_state).__name__ == kind
    port_state = state_from_fields(kind, dataclasses.asdict(ref_state))
    ref_metric = ref_analyzer.compute_metric_from(ref_state)
    port_metric = port_analyzer.compute_metric_from(port_state)
    assert port_metric.value.get() == ref_metric.value.get()
    assert_metric_parity(ref_metric, port_metric)


def test_state_from_fields_rejects_unknown_kind():
    with pytest.raises(ValueError):
        state_from_fields("SpilledFrequencies", {})


def test_import_isolation():
    """The port imports torch and numpy, never jax and nothing of deequ_tpu."""
    code = (
        "import sys, deequ_tpu_torch, deequ_tpu_torch.verification, "
        "deequ_tpu_torch.interop, deequ_tpu_torch.ops.segment, "
        "deequ_tpu_torch.native, deequ_tpu_torch.ops.lut_cache, "
        "deequ_tpu_torch.states, deequ_tpu_torch.states.serde, "
        "deequ_tpu_torch.data.fs, deequ_tpu_torch.data.cast, "
        "deequ_tpu_torch.resilience, deequ_tpu_torch.analyzers.incremental, "
        "deequ_tpu_torch.analyzers.analysis, deequ_tpu_torch.analyzers.builder, "
        "deequ_tpu_torch.envcfg, deequ_tpu_torch.repository, "
        "deequ_tpu_torch.repository.query, deequ_tpu_torch.repository.monitor, "
        "deequ_tpu_torch.anomaly, deequ_tpu_torch.anomaly.seasonal, "
        "deequ_tpu_torch.ops.holt_winters, deequ_tpu_torch.profiles, "
        "deequ_tpu_torch.suggestions, deequ_tpu_torch.schema, "
        "deequ_tpu_torch.applicability, deequ_tpu_torch.analyzers.distance, "
        "deequ_tpu_torch.data.io, deequ_tpu_torch.interop.deequ_import\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deequ_tpu' or m.startswith('deequ_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_run_without_cuda_raises_device_unavailable(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = deequ_tpu_torch.ColumnarTable.from_pydict(BASIC_DATA)
    suite = deequ_tpu_torch.VerificationSuite.on_data(table).add_check(
        _basic_check(deequ_tpu_torch)
    )
    with pytest.raises(deequ_tpu_torch.DeviceUnavailableException):
        suite.run()
    with deequ_tpu_torch.use_device("cpu"):
        assert suite.run().device == "cpu"
    with pytest.raises(deequ_tpu_torch.DeviceUnavailableException):
        suite.run()


def test_unported_checks_are_refused_when_built():
    """No in-memory check method is refused any more: the anomaly check
    builds and evaluates against an in-memory metrics repository (its
    history of Size 6 passes a new Size 6 and flags a Size 1), and the
    frequency-table and string-analyzer methods build."""
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.analyzers.runner import AnalyzerContext
    from deequ_tpu_torch.anomaly import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.metrics import DoubleMetric, Entity
    from deequ_tpu_torch.repository import (
        AnalysisResult,
        InMemoryMetricsRepository,
        ResultKey,
    )
    from deequ_tpu_torch.tryresult import Success

    repo = InMemoryMetricsRepository()
    for day in range(1, 5):
        metric = DoubleMetric(Entity.DATASET, "Size", "*", Success(6.0))
        repo.save(AnalysisResult(ResultKey(day), AnalyzerContext({Size(): metric})))
    check = deequ_tpu_torch.Check(deequ_tpu_torch.CheckLevel.ERROR, "x")
    anomaly = check.is_newest_point_non_anomalous(
        repo, RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
        Size(), None, None, None,
    )
    assert len(anomaly.constraints) == 1
    assert anomaly.required_analyzers() == [Size()]
    for size, status in ((6, "Success"), (1, "Error")):
        table = deequ_tpu_torch.ColumnarTable.from_pydict({"x": list(range(size))})
        result = deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu") \
            .add_check(anomaly).run()
        assert result.status.value == status
    for build in (
        lambda: check.has_pattern("s", r"\d+"),
        lambda: check.has_number_of_distinct_values("s", lambda n: n > 1),
        lambda: check.has_histogram_values("s", lambda d: True),
        lambda: check.has_min_length("s", lambda v: True),
        lambda: check.has_max_length("s", lambda v: True),
        lambda: check.has_mutual_information("a", "b", lambda v: True),
        lambda: check.has_data_type(
            "s", deequ_tpu_torch.ConstrainableDataTypes.STRING
        ),
        lambda: check.contains_email("s"),
        lambda: check.contains_url("s"),
        lambda: check.contains_credit_card_number("s"),
        lambda: check.contains_social_security_number("s"),
    ):
        assert len(build().constraints) == 1


def test_cpu_route_launches_no_kernel(parity_env):
    before = histogram_device.LAUNCHES
    table = deequ_tpu_torch.ColumnarTable.from_pydict(BASIC_DATA)
    deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu").add_check(
        _basic_check(deequ_tpu_torch)
    ).run()
    assert histogram_device.LAUNCHES == before


@pytest.mark.cuda
def test_smoke_schema_suite_on_cuda(parity_env):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel has no CPU mode")
    table = smoke_schema_table(50_000, seed=5)
    before = histogram_device.LAUNCHES
    cpu = deequ_tpu_torch.VerificationSuite.on_data(port_table(table), device="cpu") \
        .add_check(_smoke_check(deequ_tpu_torch)).run()
    gpu = deequ_tpu_torch.VerificationSuite.on_data(port_table(table), device="cuda") \
        .add_check(_smoke_check(deequ_tpu_torch)).run()
    assert histogram_device.LAUNCHES - before == 4  # four dense grouping sets
    for a, m in cpu.metrics.items():
        assert_metric_parity(m, gpu.metrics[a])
    assert np.isfinite([m.value.get() for m in gpu.metrics.values()]).all()


@pytest.mark.parametrize(
    "raised,typed",
    [
        (torch.cuda.OutOfMemoryError("CUDA out of memory"), "DeviceOOMException"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"),
         "DeviceLostException"),
        (RuntimeError("shape mismatch"), "RuntimeError"),
    ],
    ids=["oom", "cuda-error", "logic-error"],
)
def test_device_boundary_types_cuda_errors(raised, typed):
    """CUDA errors at a device boundary come out typed; logic errors pass
    through as themselves."""
    from deequ_tpu_torch.exceptions import device_boundary

    with pytest.raises(Exception) as info:
        with device_boundary("execute"):
            raise raised
    assert type(info.value).__name__ == typed
    if typed != "RuntimeError":
        assert info.value.boundary == "execute"
        assert info.value.__cause__ is raised
