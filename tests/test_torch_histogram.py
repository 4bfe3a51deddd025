"""The port's histogram (deequ_tpu_torch/ops/histogram_device.py) against
the reference's Pallas kernel (``bincount_pallas`` in interpret mode, as
the reference's own tests run it on the CPU) and against ``np.bincount``.
Exact equality everywhere: counts are integers.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held against that plain version by the ``cuda``-marked test
here and by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deequ_tpu.ops.histogram_device import bincount_pallas
from deequ_tpu_torch.ops import histogram_device
from deequ_tpu_torch.ops.histogram_device import bincount, bincount_plain

pytestmark = pytest.mark.torch_port

SEGMENTS = (1, 7, 511, 512, 513, 4097)
ROWS = (0, 1, 1023, 1024, 1025, 5000)


def _ids(n, m, seed, dist="uniform"):
    """n ids for a key space of m. uniform: ids in [-3, m + 3), so negative
    sentinels and ids >= m must be dropped; zipf: Zipf-skewed keys at the
    main path's exponent (0.7) scattered over [0, m), 1% -1; hot: every id
    the same bin."""
    rng = np.random.default_rng(seed)
    if dist == "hot":
        return np.full(n, m // 2, dtype=np.int64)
    if dist == "zipf":
        p = np.arange(1, m + 1, dtype=np.float64) ** -0.7
        keys = rng.permutation(m)[rng.choice(m, size=n, p=p / p.sum())]
        keys[rng.random(n) < 0.01] = -1
        return keys.astype(np.int64)
    return rng.integers(-3, m + 3, size=n)


def _numpy_bincount(seg, m, weights=None):
    keep = (seg >= 0) & (seg < m)
    w = None if weights is None else weights[keep]
    return np.bincount(seg[keep], weights=w, minlength=m)[:m].astype(np.int64)


_DTYPES = {"i32": torch.int32, "i64": torch.int64}
NUMPY_CASES = [
    pytest.param(n, m, _DTYPES[dt], "uniform", id=f"{n}-{m}-{dt}")
    for n in ROWS for m in SEGMENTS for dt in _DTYPES
] + [
    pytest.param(n, m, _DTYPES[dt], dist, id=f"{dist}-{n}-{m}-{dt}")
    for dist in ("zipf", "hot") for n in (1025, 5000) for m in SEGMENTS for dt in _DTYPES
]


@pytest.mark.parametrize("n,m,dtype,dist", NUMPY_CASES)
def test_bincount_matches_numpy(n, m, dtype, dist):
    seg = _ids(n, m, seed=n * 7919 + m, dist=dist)
    weights = np.random.default_rng(m).integers(-50, 1000, size=n).astype(np.int32)
    t = torch.from_numpy(seg).to(dtype)
    got = bincount(t, m)
    assert got.dtype == torch.int64 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), _numpy_bincount(seg, m))
    got_w = bincount(t, m, weights=torch.from_numpy(weights))
    np.testing.assert_array_equal(got_w.numpy(), _numpy_bincount(seg, m, weights))


# the Pallas side runs in interpret mode (~0.25 s a call here), so it takes a
# spread of the edge cases: empty, single row, block edges on both axes,
# the widest segment count, weights, both id types, Zipf skew, one hot bin
PALLAS_CASES = [
    pytest.param(0, 7, "i64", False, "uniform", id="0-7-i64-False"),
    pytest.param(1, 1, "i32", False, "uniform", id="1-1-i32-False"),
    pytest.param(1023, 511, "i64", True, "uniform", id="1023-511-i64-True"),
    pytest.param(1024, 512, "i32", False, "uniform", id="1024-512-i32-False"),
    pytest.param(1025, 513, "i64", False, "uniform", id="1025-513-i64-False"),
    pytest.param(5000, 4097, "i32", True, "uniform", id="5000-4097-i32-True"),
    pytest.param(5000, 7, "i64", True, "uniform", id="5000-7-i64-True"),
    pytest.param(5000, 4097, "i64", False, "zipf", id="zipf-5000-4097-i64-False"),
    pytest.param(5000, 513, "i32", True, "zipf", id="zipf-5000-513-i32-True"),
    pytest.param(5000, 4097, "i32", False, "hot", id="hot-5000-4097-i32-False"),
    pytest.param(1025, 7, "i64", True, "hot", id="hot-1025-7-i64-True"),
]


def _pallas(seg, m, weights=None):
    return np.asarray(bincount_pallas(
        jnp.asarray(seg), m, jnp,
        weights=None if weights is None else jnp.asarray(weights),
        interpret=True,
    )).astype(np.int64)


@pytest.mark.parametrize("n,m,ids,weighted,dist", PALLAS_CASES)
def test_bincount_matches_pallas_kernel(n, m, ids, weighted, dist):
    np_dtype = np.int32 if ids == "i32" else np.int64
    seg = _ids(n, m, seed=n + m, dist=dist).astype(np_dtype)
    weights = (
        np.random.default_rng(n).integers(0, 100, size=n).astype(np.int32)
        if weighted else None
    )
    want = _pallas(seg, m, weights)
    got = bincount(
        torch.from_numpy(seg), m,
        weights=None if weights is None else torch.from_numpy(weights),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def _weighted_edge(n_half=1500, m=7, seed=3):
    """ids and int32 weights whose running per-bin sums leave int32 while
    each bin's total does not: the second half repeats the first half's ids
    with the weights negated, then a few small weights."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, m, size=n_half)
    seg = np.concatenate([half, half, rng.integers(-1, m + 1, size=50)])
    big = 2**30 + 12345
    weights = np.concatenate([
        np.full(n_half, big), np.full(n_half, -big), rng.integers(-100, 100, size=50),
    ]).astype(np.int32)
    return seg, weights


def test_weighted_edge_inside_int32_matches_numpy_and_pallas():
    seg, weights = _weighted_edge()
    want = _numpy_bincount(seg, 7, weights)
    first_half = _numpy_bincount(seg[:1500], 7, weights[:1500])
    assert np.abs(want).max() < 2**31 <= first_half.max()  # at the edge
    got = bincount(torch.from_numpy(seg), 7, weights=torch.from_numpy(weights))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _pallas(seg, 7, weights))


def test_weighted_totals_past_int32_wrap_as_the_reference():
    # past the domain both take each total mod 2^32 as an int32
    seg, weights = _weighted_edge()
    weights = np.abs(weights)
    exact = _numpy_bincount(seg, 7, weights)
    assert exact.max() >= 2**31
    got = bincount(torch.from_numpy(seg), 7, weights=torch.from_numpy(weights))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32).astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), _pallas(seg, 7, weights))


def test_bincount_output_dtype_and_cpu_route_never_launches():
    before = histogram_device.LAUNCHES
    seg = torch.tensor([0, 1, 1, 5, -1, 9], dtype=torch.int64)
    out = bincount(seg, 6, dtype=torch.int32)
    assert out.dtype == torch.int32
    assert out.tolist() == [1, 2, 0, 0, 0, 1]
    assert histogram_device.LAUNCHES == before


@pytest.mark.parametrize(
    "seg,weights,error",
    [
        (torch.zeros(4, dtype=torch.float32), None, TypeError),
        (torch.zeros((2, 2), dtype=torch.int64), None, ValueError),
        (torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64), TypeError),
        (torch.zeros(4, dtype=torch.int64), torch.ones(3, dtype=torch.int32), ValueError),
    ],
    ids=["float-ids", "2d-ids", "int64-weights", "short-weights"],
)
def test_bincount_rejects_bad_input(seg, weights, error):
    with pytest.raises(error):
        bincount(seg, 4, weights=weights)


def test_bincount_rejects_negative_segments():
    with pytest.raises(ValueError):
        bincount(torch.zeros(3, dtype=torch.int64), -1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


# fixed widths (the main path's, K4's first-pass width) and both sides of
# each regime boundary, which the card reports (bincount.cu: shared while
# one histogram fits a block's shared memory, partition to 2^25 bins)
CUDA_WIDTHS = [8, 5000, 65_536, 1_000_001,
               ("shared", 0), ("shared", 1), ("partition", 0), ("partition", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "width", CUDA_WIDTHS,
    ids=[str(w) if isinstance(w, int) else f"{w[0]}-edge+{w[1]}" for w in CUDA_WIDTHS],
)
def test_cuda_kernel_matches_plain(cuda_device, width):
    if isinstance(width, int):
        m = width
    else:
        name, side = width
        m = histogram_device.regime_widths()[name] + side
        regimes = histogram_device.REGIMES
        want = name if side == 0 else regimes[regimes.index(name) + 1]
        assert histogram_device.regime(m) == want
    rng = np.random.default_rng(m)
    seg = torch.from_numpy(rng.integers(-1, m + 1, size=1_000_000)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-5, 100, size=1_000_000).astype(np.int32)).to(cuda_device)
    before = histogram_device.LAUNCHES
    assert torch.equal(bincount(seg, m), bincount_plain(seg, m))
    assert torch.equal(bincount(seg.to(torch.int32), m), bincount_plain(seg, m))
    assert torch.equal(bincount(seg, m, weights=w), bincount_plain(seg, m, weights=w))
    assert histogram_device.LAUNCHES == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("m", (7, 65_536, 33_554_433))
def test_cuda_weighted_edge_matches_plain(cuda_device, m):
    seg, weights = _weighted_edge(n_half=1_000_000, m=7)
    seg = torch.from_numpy(seg).to(cuda_device)
    w = torch.from_numpy(weights).to(cuda_device)
    assert torch.equal(bincount(seg, m, weights=w), bincount_plain(seg, m, weights=w))
