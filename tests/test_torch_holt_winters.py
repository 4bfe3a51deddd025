"""The blocked evaluation of the Holt-Winters fit's recursion that the
card's kernel (``deequ_tpu_torch/csrc/holt_winters.cu``) runs, emulated in
numpy and held against the plain fit and the reference.

Within one Adam step the ETS(A,A) recursion and its forward-mode
sensitivity along one logit are a linear time-invariant system in
Z = (lt, T, w, dlt, dT, dw), lt the level plus the trend and w the p-long
season window (w[0] the current point's): ``Z' = M Z + c y``, with the
residual ``r = y - h.z`` and ``dr = -h.dz``. Stacked over the three
logits the system is block lower-triangular and falls apart into one
2 (p + 2)-square system a logit, the one each of the kernel's warps runs.
The emulation here builds each logit's ``M`` and ``c``, cuts the series
into blocks, takes Phi (the value basis's homogeneous response over a
block, as the kernel does, or ``matrix_power``), joins the block starts
serially (``Z_{b+1} = Phi Z_b + psi_b``), replays every block from its
start and sums ``2 r dr``. It is held:

- against ``fit_plain``'s autograd gradient (``ops/holt_winters.py:
  gradient_plain``) at fixed logits, each component within 1e-12 of the
  gradient's largest, for one block, two, about sqrt(n), one a point, and
  the kernel's own blocking, on series of 14, 36 and 365 points (one
  near 10^9);
- over a whole 300-step Adam fit against the reference's
  ``_fit_parameters_jax`` within 1e-12, on the milk series' 36 points
  (p = 12) and a 28-point weekly series.

The wrapper's argument checks (periodicity 7 or 12 on the card, the
blocking) run here too; the kernel itself runs only on a card (the
cuda-marked test, and ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from deequ_tpu_torch.ops import holt_winters

pytestmark = pytest.mark.torch_port

#: the emulated gradient against autograd's, each component relative to
#: the largest: forward and reverse mode, blocked and point by point,
#: differ only in their roundings, which scale with the sums' terms; a
#: component that cancels (gamma's 0.18 from terms of ~300 on the milk
#: series at LOGITS["inner"]) keeps the absolute error of the others
#: (~6e-13), 3.4e-12 of itself
GRAD_RTOL = 1e-12
#: the emulated fit against the reference's fitted (alpha, beta, gamma)
FIT_TOL = 1e-12

MILK = [
    589, 561, 640, 656, 727, 697, 640, 599, 568, 577, 553, 582,
    600, 566, 653, 673, 742, 716, 660, 617, 583, 587, 565, 598,
    628, 618, 688, 705, 770, 736, 678, 639, 604, 611, 594, 634,
]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sigmoid(x):
    return 1.0 / (1.0 + math.exp(-x))


def system(logits, p: int, k: int):
    """(M, c, h) of the recursion and its sensitivity along logit k at
    ``logits``: Z' = M Z + c y over Z = (lt, T, w, dlt, dT, dw), and the
    residual r = y - h.z. The recursion in error-correction form (the
    kernel's): r = y - lt - w[0]; lt' = lt + T + a (1 + b) r;
    T' = T + a b r; the window shifts and takes w[0] + g r last."""
    a, b, g = (_sigmoid(x) for x in logits)
    e = [s * (1.0 - s) for s in (a, b, g)]
    R = p + 2
    h = np.zeros(R)
    h[0] = h[2] = 1.0

    def parts(clt, cT, cg, constant: bool):
        # rows of M and entries of c, linear in (clt, cT, cg), plus the
        # constant part where asked
        M = np.zeros((R, R))
        c = np.zeros(R)
        if constant:
            M[0, 0] = M[0, 1] = M[1, 1] = 1.0
            for i in range(p - 1):
                M[2 + i, 3 + i] = 1.0
            M[R - 1, 2] = 1.0
        for row, coef in ((0, clt), (1, cT), (R - 1, cg)):
            M[row] -= coef * h
            c[row] += coef
        return M, c

    M, c = parts(a * (1 + b), a * b, g, True)
    d = {0: (e[0] * (1 + b), e[0] * b, 0.0),
         1: (a * e[1], a * e[1], 0.0),
         2: (0.0, 0.0, e[2])}[k]
    dM, dc = parts(*d, False)
    Maug = np.block([[M, np.zeros((R, R))], [dM, M]])
    return Maug, np.concatenate([c, dc]), h


def initial_state(y: np.ndarray, p: int) -> np.ndarray:
    """Z at the first point: seasonal.py:88-91's state on the centred
    series, as (lt, T, w), no sensitivity."""
    level0 = y[:p].sum() / p
    trend0 = (y[p:2 * p].sum() - y[:p].sum()) / (p * p)
    z = np.concatenate([[level0 + trend0, trend0], y[:p] - level0])
    return np.concatenate([z, np.zeros_like(z)])


def run(Maug, caug, h, Z, ys):
    """Z after the points ys, and the sum of r dr over them."""
    R = len(h)
    acc = 0.0
    for y in ys:
        r = y - h @ Z[:R]
        acc += r * -(h @ Z[R:])
        Z = Maug @ Z + caug * y
    return Z, acc


def phi(Maug, caug, h, block_len: int) -> np.ndarray:
    """M^block_len from the homogeneous response of the value basis, as
    the kernel builds it: column j of the value columns is e_j run over
    block_len points with y = 0; the sensitivity columns repeat the value
    block (the system is block lower-triangular)."""
    R = len(h)
    cols = np.stack([run(Maug, caug, h, np.eye(2 * R)[j], np.zeros(block_len))[0]
                     for j in range(R)], axis=1)
    out = np.zeros((2 * R, 2 * R))
    out[:, :R] = cols
    out[R:, R:] = cols[:R]
    return out


def blocked_gradient(series, p: int, logits, block_len: int) -> np.ndarray:
    """d RSS / d logits by the kernel's blocked evaluation: block 0 from
    the true start (Z_1), Phi from the value basis, psi_b of blocks
    1 .. B-2 from zero, the serial join, the replay of every block."""
    y = np.asarray(series, dtype=np.float64)
    y = y - y[0]
    n = len(y)
    bounds = [(t, min(t + block_len, n)) for t in range(0, n, block_len)]
    grad = np.zeros(3)
    for k in range(3):
        Maug, caug, h = system(logits, p, k)
        starts = [initial_state(y, p)]
        starts.append(run(Maug, caug, h, starts[0], y[slice(*bounds[0])])[0])
        if len(bounds) > 2:
            Phi = phi(Maug, caug, h, block_len)
        for t0, t1 in bounds[1:-1]:
            psi, _ = run(Maug, caug, h, np.zeros_like(starts[0]), y[t0:t1])
            starts.append(Phi @ starts[-1] + psi)
        acc = sum(run(Maug, caug, h, start, y[t0:t1])[1]
                  for start, (t0, t1) in zip(starts, bounds))
        grad[k] = 2.0 * acc
    return grad


def blocked_fit(series, p: int, steps: int = holt_winters.STEPS) -> np.ndarray:
    """(alpha, beta, gamma): the kernel's Adam loop over the blocked
    gradient, in the kernel's blocking, with its bias-correction table."""
    block_len, _ = holt_winters.blocking(len(series), p)
    bias = holt_winters.bias_table(steps)
    theta = np.array(holt_winters.INITIAL_LOGITS)
    m = np.zeros(3)
    v = np.zeros(3)
    for i in range(1, steps + 1):
        grad = blocked_gradient(series, p, theta, block_len)
        m = holt_winters.BETA1 * m + (1 - holt_winters.BETA1) * grad
        v = holt_winters.BETA2 * v + (1 - holt_winters.BETA2) * grad * grad
        mhat = m / bias[i - 1]
        vhat = v / bias[steps + i - 1]
        theta = theta - holt_winters.LR * mhat / (np.sqrt(vhat) + holt_winters.EPS)
    return np.array([_sigmoid(x) for x in theta])


def _series(kind: str, n: int) -> list:
    rng = np.random.default_rng([n, len(kind)])
    t = np.arange(n)
    if kind == "milk":
        return [float(x) for x in MILK[:n]]
    if kind == "weekly":
        y = 10.0 + 3.0 * np.sin(2 * np.pi * t / 7) + 0.05 * t + 0.3 * rng.standard_normal(n)
    else:  # "big": near 10^9, test_anomaly.py's BIG
        y = 1e9 + 1e6 * np.sin(2 * np.pi * t / 7) + 1e5 * rng.standard_normal(n)
    return y.tolist()


#: (series kind, n, p): the gradient cases
GRADIENT_CASES = [("weekly", 14, 7), ("milk", 36, 12), ("weekly", 365, 7), ("big", 365, 7)]
#: logits the gradient is taken at: the fit's start, and a point inside
LOGITS = {"start": holt_winters.INITIAL_LOGITS, "inner": (0.4, -1.3, -0.2)}


def _block_len(choice: str, n: int, p: int) -> int:
    return {"one": n,
            "two": -(-n // 2),
            "sqrt": -(-n // math.isqrt(n)),
            "points": 1,
            "kernel": holt_winters.blocking(n, p)[0]}[choice]


_AUTOGRAD = {}


def _autograd(kind: str, n: int, p: int, at: str) -> np.ndarray:
    key = (kind, n, p, at)
    if key not in _AUTOGRAD:
        series = torch.tensor(_series(kind, n), dtype=torch.float64)
        _AUTOGRAD[key] = holt_winters.gradient_plain(series, p, LOGITS[at]).numpy()
    return _AUTOGRAD[key]


@pytest.mark.parametrize("at", sorted(LOGITS))
@pytest.mark.parametrize("choice", ["one", "two", "sqrt", "points", "kernel"])
@pytest.mark.parametrize("kind,n,p", GRADIENT_CASES)
def test_blocked_gradient_matches_autograd(kind, n, p, choice, at):
    """One step's gradient by blocks equals fit_plain's autograd
    gradient: for B = 1, 2, about sqrt(n) (an uneven last block where n
    is not a multiple), n, and the kernel's blocks of a multiple of p."""
    block_len = _block_len(choice, n, p)
    want = _autograd(kind, n, p, at)
    got = blocked_gradient(_series(kind, n), p, LOGITS[at], block_len)
    assert np.max(np.abs(got - want)) <= GRAD_RTOL * np.max(np.abs(want)), (got, want, block_len)


@pytest.mark.parametrize("kind,n,p", [("milk", 36, 12), ("weekly", 28, 7)])
def test_blocked_fit_matches_reference(kind, n, p):
    """The kernel's whole fit, emulated, within 1e-12 of the reference's
    jitted-autodiff fit."""
    # imported here, not at the top, so that the cuda-marked test runs on a
    # card whose Python has no JAX (pytest --noconftest)
    import deequ_tpu.anomaly.seasonal as ref_seasonal

    series = _series(kind, n)
    want = ref_seasonal._fit_parameters_jax(np.asarray(series), p)
    got = blocked_fit(series, p)
    assert np.max(np.abs(got - np.asarray(want))) <= FIT_TOL, (got, want)


@pytest.mark.parametrize("block_len", [1, 7, 24, 35])
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("p", holt_winters.KERNEL_PERIODICITIES)
def test_phi_from_the_value_basis_is_the_matrix_power(p, k, block_len):
    """The kernel builds Phi from p + 2 homogeneous runs; the system is
    block lower-triangular, so that is M^Lb."""
    Maug, caug, h = system(LOGITS["inner"], p, k)
    want = np.linalg.matrix_power(Maug, block_len)
    got = phi(Maug, caug, h, block_len)
    assert np.allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("p", [1, 2, 4, 6, 7, 8, 11, 12, 13, 24, 52])
def test_kernel_takes_periodicity_7_or_12(p):
    """On the card the wrapper refuses a periodicity the kernel is not
    built for; the CPU's plain version takes any."""
    if p in (7, 12):
        holt_winters.check_kernel_periodicity(p)
    else:
        with pytest.raises(ValueError, match="periodicity 7 or 12"):
            holt_winters.check_kernel_periodicity(p)


def test_plain_version_takes_any_periodicity():
    series = torch.tensor(_series("weekly", 20), dtype=torch.float64)
    got = holt_winters.fit(series, 5, steps=3)
    assert got.shape == (3,) and torch.isfinite(got).all()


@pytest.mark.parametrize("n,p", [
    (n, p) for p in holt_winters.KERNEL_PERIODICITIES
    for n in (14, 15, 24, 25, 36, 49, 358, 365, 366, 730, 10_000, 100_000) if n >= 2 * p
])
def test_blocking_covers_the_series(n, p):
    """Blocks of a multiple of p, every point in exactly one, no empty
    block, at most max_blocks(p) of them, about sqrt(n) points each
    where that many blocks fit."""
    block_len, blocks = holt_winters.blocking(n, p)
    assert block_len % p == 0 and block_len > 0
    assert (blocks - 1) * block_len < n <= blocks * block_len
    assert blocks <= holt_winters.max_blocks(p) == 31 - p
    if -(-n // p) <= holt_winters.max_blocks(p):
        assert abs(block_len - math.sqrt(n)) <= max(p, block_len - p)


@pytest.mark.parametrize("block_len", [0, -7, 5, 8, 1])
def test_blocking_refuses_a_length_off_the_ring(block_len):
    with pytest.raises(ValueError, match="multiple of the periodicity"):
        holt_winters.blocking(365, 7, block_len)


def test_blocking_refuses_too_many_blocks():
    with pytest.raises(ValueError, match="at most 24"):
        holt_winters.blocking(365, 7, 7)


def test_bias_table_holds_fit_plains_divisors():
    table = holt_winters.bias_table(300)
    assert len(table) == 600
    for i in (1, 2, 150, 300):
        assert table[i - 1] == 1 - 0.9 ** i
        assert table[300 + i - 1] == 1 - 0.999 ** i


#: forced block lengths the kernel takes at n = 365, p = 7: its default's
#: 18 blocks of 21, then 11, 8, 3 (the last of 1 point), 2 (the last of
#: 1 point) and one block of the whole series
CUDA_BLOCK_LENGTHS = [None, 21, 35, 49, 182, 364, 371]


@pytest.mark.cuda
@pytest.mark.parametrize("block_len", CUDA_BLOCK_LENGTHS)
def test_kernel_blocks_against_plain_on_cuda(block_len):
    """The kernel at several blockings, from its default's 18 blocks to
    one, within 1e-12 of the plain fit (the card has no CPU mode: skips
    without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Holt-Winters kernel has no CPU mode")
    series = torch.tensor(_series("weekly", 365), dtype=torch.float64)
    want = holt_winters.fit_plain(series, 7, steps=20)
    out = torch.empty(3, dtype=torch.float64, device="cuda")
    holt_winters._launch(series.cuda(), 7, 20, out, block_len)
    assert (out.cpu() - want).abs().max().item() <= FIT_TOL


def test_cuda_block_lengths_are_ones_the_kernel_takes():
    """Every forced length of the cuda-marked test is a blocking the kernel
    takes at n = 365, p = 7, and together they run from 18 blocks to one."""
    got = [holt_winters.blocking(365, 7, b) for b in CUDA_BLOCK_LENGTHS]
    assert [blocks for _, blocks in got] == [18, 18, 11, 8, 3, 2, 1]
