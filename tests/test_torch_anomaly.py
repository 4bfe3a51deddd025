"""The port's anomaly detection (``deequ_tpu_torch/anomaly``) against the
reference's (``deequ_tpu/anomaly``): the port twin of tests/test_anomaly.py.

Each test puts the same series (or the same repository history) through
both packages on the CPU and holds the port to the reference:

- the strategies' flagged indices and ``Anomaly`` values (value,
  confidence and detail) identical;
- Holt-Winters: every fit's (alpha, beta, gamma) within 1e-12 of
  ``_fit_parameters_jax`` (the port fits with the plain autograd version
  of ``ops/holt_winters.py`` on a CPU tensor), and the flagged indices and
  values identical, the milk and car-sales series' pinned indices
  included;
- argument validation raises the same errors.

The kernel itself runs only on a card (a cuda-marked test here;
``chip_smoke.py`` holds it against the plain version there).
"""

import math

import numpy as np
import pytest
import torch

import deequ_tpu.anomaly as ref
import deequ_tpu.anomaly.seasonal as ref_seasonal
import deequ_tpu_torch.anomaly as port
import deequ_tpu_torch.anomaly.seasonal as port_seasonal
from deequ_tpu_torch import use_device
from deequ_tpu_torch.ops import holt_winters
from tests.torch_parity import port_table

pytestmark = pytest.mark.torch_port

#: the fitted parameters' bound against the reference: both take exact
#: gradients (reverse mode in JAX, autograd in the port), whose roundings
#: differ in the last bits, over the same 300 Adam steps
FIT_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _found(found):
    return [(i, a.value, a.confidence, a.detail) for i, a in found]


def _both(make, data, interval=None):
    """(reference anomalies, port anomalies) of the strategy ``make(pkg)``
    over ``data``; asserts them identical and returns the reference's."""
    args = (data,) if interval is None else (data, interval)
    want = _found(make(ref).detect(*args))
    with use_device("cpu"):
        got = _found(make(port).detect(*args))
    assert got == want
    return want


def _indices(found):
    return [i for i, *_ in found]


def test_simple_threshold():
    data = [-1.0, 2.0, 3.0, 0.5]
    found = _both(lambda m: m.SimpleThresholdStrategy(upper_bound=1.0), data, (0, 4))
    assert _indices(found) == [1, 2]
    assert found[0][1] == 2.0


def test_simple_threshold_interval():
    data = [-1.0, 2.0, 3.0, 0.5]
    found = _both(lambda m: m.SimpleThresholdStrategy(upper_bound=1.0), data, (2, 4))
    assert _indices(found) == [2]


def test_absolute_change():
    data = [1.0, 2.0, 3.0, 4.0, 5.0, 15.0, 16.0]
    found = _both(lambda m: m.AbsoluteChangeStrategy(
        max_rate_decrease=-2.0, max_rate_increase=2.0), data, (0, len(data)))
    assert _indices(found) == [5]


def test_absolute_change_second_order():
    data = [1.0, 2.0, 4.0, 8.0, 16.0]
    found = _both(lambda m: m.AbsoluteChangeStrategy(
        max_rate_decrease=-3.0, max_rate_increase=3.0, order=2), data, (0, len(data)))
    assert _indices(found) == [4]


def test_relative_rate_of_change():
    data = [1.0, 1.1, 1.2, 6.0, 6.1]
    found = _both(lambda m: m.RelativeRateOfChangeStrategy(
        max_rate_decrease=0.5, max_rate_increase=2.0), data, (0, len(data)))
    assert _indices(found) == [3]


def test_online_normal():
    rng = np.random.default_rng(42)
    data = rng.normal(1.0, 0.1, 100).tolist()
    data[77] = 10.0
    found = _both(lambda m: m.OnlineNormalStrategy(), data, (0, len(data)))
    assert 77 in _indices(found)


def test_batch_normal():
    rng = np.random.default_rng(0)
    data = rng.normal(0.0, 1.0, 50).tolist() + [25.0, 0.1]
    found = _both(lambda m: m.BatchNormalStrategy(), data, (50, 52))
    assert _indices(found) == [50]


def test_batch_normal_requires_training_data():
    for m in (ref, port):
        with pytest.raises(ValueError):
            m.BatchNormalStrategy().detect([1.0, 2.0], (0, 2))


def test_detector_sorts_and_drops_missing():
    out = []
    for m in (ref, port):
        detector = m.AnomalyDetector(m.SimpleThresholdStrategy(upper_bound=1.0))
        series = [m.DataPoint(3, 5.0), m.DataPoint(1, 0.5), m.DataPoint(2, None)]
        result = detector.detect_anomalies_in_history(series)
        out.append([(t, a.value, a.detail) for t, a in result.anomalies])
    assert out[0] == out[1] == [(3, 5.0, out[0][0][2])]


def test_is_new_point_anomalous():
    for m in (ref, port):
        detector = m.AnomalyDetector(m.SimpleThresholdStrategy(upper_bound=1.0))
        history = [m.DataPoint(i, 0.5) for i in range(10)]
        assert len(detector.is_new_point_anomalous(history, m.DataPoint(11, 5.0)).anomalies) == 1
        assert len(detector.is_new_point_anomalous(history, m.DataPoint(11, 0.6)).anomalies) == 0
        with pytest.raises(ValueError):
            detector.is_new_point_anomalous(history, m.DataPoint(5, 1.0))


# -- Holt-Winters ------------------------------------------------------------

BIG = 10 ** 9


@pytest.fixture
def fits(monkeypatch):
    """Record every fit both packages make: {"ref": [...], "port": [...]}
    of (periodicity, n, (alpha, beta, gamma))."""
    seen = {"ref": [], "port": []}
    ref_fit, port_fit = ref_seasonal._fit_parameters_jax, port_seasonal._fit_parameters

    def rec_ref(series, p):
        out = ref_fit(series, p)
        seen["ref"].append((p, len(series), out))
        return out

    def rec_port(series, p, device=None):
        out = port_fit(series, p, device)
        seen["port"].append((p, len(series), out))
        return out

    monkeypatch.setattr(ref_seasonal, "_fit_parameters_jax", rec_ref)
    monkeypatch.setattr(port_seasonal, "_fit_parameters", rec_port)
    return seen


def _hw_both(fits, interval, series, monthly=False):
    """The flagged (index, value) pairs of both packages' Holt-Winters,
    asserted identical, every fit within FIT_TOL of the reference's."""
    def make(m):
        if monthly:
            return m.HoltWinters(m.MetricInterval.MONTHLY, m.SeriesSeasonality.YEARLY)
        return m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)

    want = [(i, a.value) for i, a in make(ref).detect(series, interval)]
    with use_device("cpu"):
        got = [(i, a.value) for i, a in make(port).detect(series, interval)]
    assert got == want
    assert len(fits["port"]) == len(fits["ref"]) >= 1
    for (pr, nr, abg_r), (pp, np_, abg_p) in zip(fits["ref"], fits["port"]):
        assert (pp, np_) == (pr, nr)
        assert max(abs(x - y) for x, y in zip(abg_p, abg_r)) <= FIT_TOL, (abg_p, abg_r)
    return [i for i, _ in want]


def test_holt_winters_detects_seasonal_break(fits):
    period = 7
    base = [10.0 + 5.0 * math.sin(2 * math.pi * i / period) for i in range(35)]
    series = base[:28] + [base[28], base[29] + 40.0, base[30], base[31], base[32]]
    found = _hw_both(fits, (28, len(series)), series)
    assert 29 in found and 28 not in found


def test_holt_winters_requires_two_cycles():
    for m in (ref, port):
        hw = m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)
        with pytest.raises(ValueError):
            hw.detect([1.0] * 20, (10, 20))


def test_anomaly_check_integration(df_with_numeric_values):
    """The add_anomaly_check flow against a repository history in both
    packages (reference VerificationRunBuilder.scala:227-243)."""
    import deequ_tpu
    import deequ_tpu_torch
    from deequ_tpu.analyzers import Size as RefSize
    from deequ_tpu.repository import InMemoryMetricsRepository as RefRepo
    from deequ_tpu.repository import ResultKey as RefKey
    from deequ_tpu.verification import AnomalyCheckConfig as RefConfig
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey
    from deequ_tpu_torch.verification import AnomalyCheckConfig

    def flow(pkg, table, repo, Size, Key, Config, **kw):
        for day in range(1, 5):
            (pkg.VerificationSuite.on_data(table, **kw).use_repository(repo)
             .save_or_append_result(Key(day)).add_required_analyzer(Size()).run())
        statuses = []
        for key, data in ((10, table), (11, table.head(1))):
            result = (
                pkg.VerificationSuite.on_data(data, **kw).use_repository(repo)
                .save_or_append_result(Key(key))
                .add_anomaly_check(
                    pkg.anomaly.RelativeRateOfChangeStrategy(
                        max_rate_decrease=0.5, max_rate_increase=2.0),
                    Size(), Config(pkg.CheckLevel.WARNING, "size anomaly"))
                .run()
            )
            statuses.append(result.status.value)
        return statuses

    import deequ_tpu.anomaly  # noqa: F401
    import deequ_tpu_torch.anomaly  # noqa: F401

    want = flow(deequ_tpu, df_with_numeric_values, RefRepo(), RefSize, RefKey, RefConfig)
    got = flow(deequ_tpu_torch, port_table(df_with_numeric_values),
               InMemoryMetricsRepository(), Size, ResultKey, AnomalyCheckConfig,
               device="cpu")
    assert got == want == ["Success", "Warning"]


def test_online_normal_exact_indices_reference_pattern():
    rng = np.random.default_rng(1)
    data = list(rng.normal(0, 1, 51))
    for i in range(20, 31):
        data[i] += i + (i % 2) * -2 * i
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=3.5, upper_deviation_factor=3.5,
        ignore_start_percentage=0.2), data)
    assert _indices(found) == list(range(20, 31))
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=1.5, upper_deviation_factor=1.5,
        ignore_start_percentage=0.2), data, (25, 31))
    assert _indices(found) == list(range(25, 31))
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=None, upper_deviation_factor=1.5,
        ignore_start_percentage=0.2), data)
    assert _indices(found) == list(range(20, 31, 2))
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=1.5, upper_deviation_factor=None,
        ignore_start_percentage=0.2), data)
    assert _indices(found) == list(range(21, 30, 2))


def test_absolute_change_exact_indices():
    data = [1.0] * 10 + [10.0] + [1.0] * 10
    assert _indices(_both(lambda m: m.AbsoluteChangeStrategy(max_rate_increase=5.0), data)) == [10]
    assert _indices(_both(lambda m: m.AbsoluteChangeStrategy(max_rate_decrease=-5.0), data)) == [11]
    assert _indices(_both(lambda m: m.AbsoluteChangeStrategy(
        max_rate_decrease=-5.0, max_rate_increase=5.0), data)) == [10, 11]


def test_relative_rate_exact_indices():
    data = [1.0, 1.0, 4.0, 4.0, 1.0, 1.0]
    found = _both(lambda m: m.RelativeRateOfChangeStrategy(
        max_rate_increase=2.0, max_rate_decrease=0.5), data)
    assert _indices(found) == [2, 4]


def test_batch_normal_exact_indices():
    rng = np.random.default_rng(3)
    data = list(rng.normal(10, 1, 30)) + [25.0, 10.2]
    found = _both(lambda m: m.BatchNormalStrategy(
        lower_deviation_factor=5.0, upper_deviation_factor=5.0), data, (30, 32))
    assert _indices(found) == [30]


def test_holt_winters_argument_validation_matches_reference():
    cases = [
        ("Start must be before end", [1.0] * 21, (1, 1)),
        ("series is empty", [], (0, BIG)),
        ("strictly positive", [1.0] * 21, (-2, -1)),
        ("two full cycles", [1.0, 2.0, 3.0], (0, BIG)),
    ]
    for m in (ref, port):
        hw = m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)
        for match, series, interval in cases:
            with pytest.raises(ValueError, match=match):
                hw.detect(series, interval)
    with pytest.raises(ValueError, match="Supported combinations"):
        port.HoltWinters(port.MetricInterval.MONTHLY, port.SeriesSeasonality.WEEKLY)


def test_holt_winters_no_anomalies_beyond_series_size(fits):
    rng = np.random.default_rng(42)
    two_weeks = [x + rng.normal() for x in [1, 1, 1.2, 1.3, 1.5, 2.1, 1.9] * 2]
    assert _hw_both(fits, (100, 110), two_weeks) == []


def test_holt_winters_constant_series(fits):
    assert _hw_both(fits, (14, BIG), [1.0] * 21) == []


def test_holt_winters_single_error_in_constant_series(fits):
    assert _hw_both(fits, (14, BIG), [1.0] * 20 + [0.0]) == [20]


def test_holt_winters_exact_linear_trend(fits):
    assert _hw_both(fits, (36, BIG), [float(t) for t in range(48)]) == []


def test_holt_winters_linear_plus_seasonal(fits):
    series = [math.sin(2 * math.pi / 7 * t) + t for t in range(48)]
    assert _hw_both(fits, (36, BIG), series) == []


def test_holt_winters_wrong_training_data(fits):
    train = [0.0, 1, 1, 1, 1, 1, 1] * 2
    series = [float(x) for x in train] + [1.0] * 7
    assert _hw_both(fits, (14, 21), series) == [14]


MILK = [
    589, 561, 640, 656, 727, 697, 640, 599, 568, 577, 553, 582,
    600, 566, 653, 673, 742, 716, 660, 617, 583, 587, 565, 598,
    628, 618, 688, 705, 770, 736, 678, 639, 604, 611, 594, 634,
    658, 622, 709, 722, 782, 756, 702, 653, 615, 621, 602, 635,
]

CARS = [
    6550, 8728, 12026, 14395, 14587, 13791, 9498, 8251, 7049, 9545,
    9364, 8456, 7237, 9374, 11837, 13784, 15926, 13821, 11143, 7975,
    7610, 10015, 12759, 8816, 10677, 10947, 15200, 17010, 20900,
    16205, 12143, 8997, 5568, 11474, 12256, 10583, 10862, 10965,
    14405, 20379, 20128, 17816, 12268, 8642, 7962, 13932, 15936,
    12628,
]


def test_holt_winters_monthly_milk_production(fits):
    found = _hw_both(fits, (36, 48), [float(x) for x in MILK], monthly=True)
    assert found == [36, 38, 39, 44, 45, 46, 47]


def test_holt_winters_monthly_car_sales_quebec(fits):
    found = _hw_both(fits, (36, 48), [float(x) for x in CARS], monthly=True)
    assert found == [39, 41, 46]


def test_online_normal_ignores_anomalies_in_running_stats():
    rng = np.random.default_rng(9)
    data = list(rng.normal(0.0, 1.0, 60))
    data[30] = 500.0
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=3.5, upper_deviation_factor=3.5,
        ignore_start_percentage=0.2), data)
    assert _indices(found) == [30]


def test_online_normal_constant_then_step():
    data = [1.0] * 30 + [2.0] * 5
    found = _both(lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=3.5, upper_deviation_factor=3.5,
        ignore_start_percentage=0.1), data)
    assert _indices(found) == list(range(30, 35))


def test_simple_threshold_bounds_default_and_lower():
    data = [-5.0, -1.0, 0.0, 1.0, 5.0]
    assert _indices(_both(lambda m: m.SimpleThresholdStrategy(lower_bound=-2.0),
                          data, (0, 5))) == [0]
    assert _indices(_both(lambda m: m.SimpleThresholdStrategy(
        lower_bound=-2.0, upper_bound=2.0), data, (0, 5))) == [0, 4]


def test_rate_of_change_alias_matches_absolute_change():
    data = [1.0] * 5 + [9.0] + [1.0] * 5
    a = _both(lambda m: m.AbsoluteChangeStrategy(max_rate_decrease=-5.0, max_rate_increase=5.0), data)
    r = _both(lambda m: m.RateOfChangeStrategy(max_rate_decrease=-5.0, max_rate_increase=5.0), data)
    assert _indices(a) == _indices(r) == [5, 6]


def test_batch_normal_excludes_anomalies_from_refit():
    rng = np.random.default_rng(11)
    data = list(rng.normal(0.0, 1.0, 40)) + [30.0, 0.1]
    found = _both(lambda m: m.BatchNormalStrategy(
        lower_deviation_factor=4.0, upper_deviation_factor=4.0), data, (40, 42))
    assert _indices(found) == [40]


# -- the fit wrapper (ops/holt_winters.py) -----------------------------------


def test_fit_wrapper_takes_the_plain_version_on_a_cpu_tensor():
    """A CPU tensor runs the plain autograd fit (no launch counted); the
    wrapper checks its arguments; the fit charges its three fetched values
    to bytes_fetched and nothing to device_fetches (seasonal.py:140)."""
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    series = torch.tensor([float(x) for x in MILK[:36]], dtype=torch.float64)
    before = holt_winters.LAUNCHES
    got = holt_winters.fit(series, 12, steps=20)
    assert holt_winters.LAUNCHES == before
    assert torch.equal(got, holt_winters.fit_plain(series, 12, steps=20))
    assert got.dtype == torch.float64 and got.shape == (3,)
    for bad, p in ((series.float(), 12), (series[:20], 12), (series.reshape(6, 6), 3)):
        with pytest.raises(ValueError):
            holt_winters.fit(bad, p)
    fetched, fetches = SCAN_STATS.bytes_fetched, SCAN_STATS.device_fetches
    port_seasonal._fit_parameters(np.asarray(MILK[:24], dtype=np.float64), 12, "cpu")
    assert SCAN_STATS.bytes_fetched - fetched == 24
    assert SCAN_STATS.device_fetches == fetches


def test_fit_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The fit resolves its device as every entry point does: without a
    card and without a request for the CPU it raises, never fitting on
    the host quietly."""
    from deequ_tpu_torch import DeviceUnavailableException

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hw = port.HoltWinters(port.MetricInterval.DAILY, port.SeriesSeasonality.WEEKLY)
    with pytest.raises(DeviceUnavailableException):
        hw.detect([1.0] * 21, (14, BIG))
    with use_device("cpu"):
        assert hw.detect([1.0] * 21, (14, BIG)) == []


def test_holt_winters_anomaly_check_in_a_run_fits_on_the_run_device(monkeypatch):
    """add_anomaly_check(HoltWinters) inside run(device="cpu"): the check
    is evaluated in the run's device scope, so the fit takes the CPU."""
    import deequ_tpu_torch
    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    repo = InMemoryMetricsRepository()
    devices = []
    fit = port_seasonal._fit_parameters

    def spy(series, p, device=None):
        from deequ_tpu_torch.device import resolve_device

        devices.append(str(resolve_device(device)))
        return fit(series, p, device)

    monkeypatch.setattr(port_seasonal, "_fit_parameters", spy)
    noise = np.random.default_rng(5).normal(0.0, 0.2, 14)
    for day in range(14):
        value = 10.0 + (day % 7) + float(noise[day])
        table = deequ_tpu_torch.ColumnarTable.from_pydict({"x": [value, value]})
        (deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu")
         .use_repository(repo).save_or_append_result(ResultKey(day))
         .add_required_analyzer(Mean("x")).run())
    hw = port.HoltWinters(port.MetricInterval.DAILY, port.SeriesSeasonality.WEEKLY)
    for value, status in ((10.0, "Success"), (60.0, "Warning")):
        table = deequ_tpu_torch.ColumnarTable.from_pydict({"x": [value, value]})
        result = (deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu")
                  .use_repository(repo).add_anomaly_check(hw, Mean("x")).run())
        assert result.status.value == status
    assert devices == ["cpu", "cpu"]


@pytest.mark.cuda
def test_fit_kernel_against_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Holt-Winters kernel has no CPU mode")
    for series, p in ((MILK[:36], 12), ([10.0 + (t % 7) + 0.1 * t for t in range(60)], 7)):
        s = torch.tensor([float(x) for x in series], dtype=torch.float64)
        before = holt_winters.LAUNCHES
        got = holt_winters.fit(s.cuda(), p).cpu()
        assert holt_winters.LAUNCHES == before + 1
        assert (got - holt_winters.fit_plain(s, p)).abs().max().item() <= FIT_TOL
