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


def _ids(n, m, seed):
    # ids in [-3, m + 3): negative sentinels and ids >= m must be dropped
    return np.random.default_rng(seed).integers(-3, m + 3, size=n)


def _numpy_bincount(seg, m, weights=None):
    keep = (seg >= 0) & (seg < m)
    w = None if weights is None else weights[keep]
    return np.bincount(seg[keep], weights=w, minlength=m)[:m].astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("m", SEGMENTS)
@pytest.mark.parametrize("n", ROWS)
def test_bincount_matches_numpy(n, m, dtype):
    seg = _ids(n, m, seed=n * 7919 + m)
    weights = np.random.default_rng(m).integers(-50, 1000, size=n).astype(np.int32)
    t = torch.from_numpy(seg).to(dtype)
    got = bincount(t, m)
    assert got.dtype == torch.int64 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), _numpy_bincount(seg, m))
    got_w = bincount(t, m, weights=torch.from_numpy(weights))
    np.testing.assert_array_equal(got_w.numpy(), _numpy_bincount(seg, m, weights))


# the Pallas side runs in interpret mode (~0.25 s a call here), so it takes a
# spread of the edge cases: empty, single row, block edges on both axes,
# the widest segment count, weights, both id types
PALLAS_CASES = [
    (0, 7, "i64", False),
    (1, 1, "i32", False),
    (1023, 511, "i64", True),
    (1024, 512, "i32", False),
    (1025, 513, "i64", False),
    (5000, 4097, "i32", True),
    (5000, 7, "i64", True),
]


@pytest.mark.parametrize("n,m,ids,weighted", PALLAS_CASES)
def test_bincount_matches_pallas_kernel(n, m, ids, weighted):
    np_dtype = np.int32 if ids == "i32" else np.int64
    seg = _ids(n, m, seed=n + m).astype(np_dtype)
    weights = (
        np.random.default_rng(n).integers(0, 100, size=n).astype(np.int32)
        if weighted else None
    )
    want = np.asarray(bincount_pallas(
        jnp.asarray(seg), m, jnp,
        weights=None if weights is None else jnp.asarray(weights),
        interpret=True,
    )).astype(np.int64)
    got = bincount(
        torch.from_numpy(seg), m,
        weights=None if weights is None else torch.from_numpy(weights),
    )
    np.testing.assert_array_equal(got.numpy(), want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("m", (8, 5000, 58_000, 58_200, 1_000_001))
def test_cuda_kernel_matches_plain(cuda_device, m):
    rng = np.random.default_rng(m)
    seg = torch.from_numpy(rng.integers(-1, m + 1, size=1_000_000)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-5, 100, size=1_000_000).astype(np.int32)).to(cuda_device)
    before = histogram_device.LAUNCHES
    assert torch.equal(bincount(seg, m), bincount_plain(seg, m))
    assert torch.equal(bincount(seg.to(torch.int32), m), bincount_plain(seg, m))
    assert torch.equal(bincount(seg, m, weights=w), bincount_plain(seg, m, weights=w))
    assert histogram_device.LAUNCHES == before + 3
