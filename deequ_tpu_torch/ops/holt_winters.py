"""The Holt-Winters parameter fit — the port's counterpart of
``deequ_tpu/anomaly/seasonal.py:_fit_parameters_jax``.

The fit minimises the residual sum of squares of the one-step-ahead
ETS(A,A) forecasts over (alpha, beta, gamma), each the sigmoid of a logit,
with 300 Adam steps (lr 0.05, beta1 0.9, beta2 0.999, eps 1e-8) from the
logits of (0.3, 0.1, 0.1). One formulation per device:

- on a CUDA tensor, :func:`fit` launches the hand-written kernel of
  ``deequ_tpu_torch/csrc/holt_winters.cu``: the whole fit, every Adam step
  with its exact gradient carried forward through the recursion, in one
  launch (the source says why), or raises;
- on a CPU tensor it runs :func:`fit_plain`, the kernel's plain PyTorch
  version: the recursion of ``seasonal.py:93-111`` in torch autograd,
  ``backward()`` for the gradient, and the same Adam loop. The tests and
  ``chip_smoke.py`` hold the kernel against it.

Both fit the series less its first point. The fit does not change in
exact arithmetic (the recursion shifts with the series; its residuals do
not), but a large offset costs digits to cancellation in every residual
and sensitivity, enough on a series near 10^9 to put the forward-mode
kernel and the reverse-mode plain version ~1e-12 apart; centred they
agree within ~1e-14.

The kernel is compiled from the source in the checkout at first use and
bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from deequ_tpu_torch.exceptions import DeviceException
from deequ_tpu_torch.ops import cuda_build

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around its paths)
LAUNCHES = 0

#: Adam steps of one fit, and Adam's settings (seasonal.py:118-122)
STEPS = 300
LR, BETA1, BETA2, EPS = 0.05, 0.9, 0.999, 1e-8
#: the initial logits: the reference's starting point (0.3, 0.1, 0.1)
INITIAL_LOGITS = (math.log(0.3 / 0.7), math.log(0.1 / 0.9), math.log(0.1 / 0.9))


def _check_args(series: torch.Tensor, periodicity: int, steps: int) -> None:
    if series.dtype != torch.float64 or series.dim() != 1:
        raise ValueError(
            f"holt_winters: series must be 1-d float64, got {series.dtype} "
            f"of shape {tuple(series.shape)}"
        )
    if periodicity < 1 or series.numel() < 2 * periodicity:
        raise ValueError(
            f"holt_winters: need two full cycles ({2 * periodicity} points), "
            f"got {series.numel()}"
        )
    if steps < 0:
        raise ValueError(f"holt_winters: steps must be >= 0, got {steps}")


def fit_plain(series: torch.Tensor, periodicity: int, steps: int = STEPS) -> torch.Tensor:
    """(alpha, beta, gamma) as a (3,) float64 tensor on ``series``' device:
    the fit in torch autograd (module doc)."""
    _check_args(series, periodicity, steps)
    p = int(periodicity)
    series = series - series[0]  # centred, as the kernel is (module doc)
    ys = series.tolist()
    level0 = series[:p].sum() / p
    trend0 = (series[p:2 * p].sum() - series[:p].sum()) / (p * p)
    season0 = list((series[:p] - level0).unbind())
    params = torch.tensor(INITIAL_LOGITS, dtype=torch.float64, device=series.device,
                          requires_grad=True)
    m = torch.zeros(3, dtype=torch.float64, device=series.device)
    v = torch.zeros_like(m)
    for i in range(1, steps + 1):
        a, b, g = torch.sigmoid(params).unbind()
        ca, cb, cg = 1 - a, 1 - b, 1 - g
        level, trend, season = level0, trend0, list(season0)
        residuals = []
        for t, yt in enumerate(ys):
            st = season[t % p]
            lt = level + trend
            residuals.append(yt - (lt + st))
            new_level = a * (yt - st) + ca * lt
            new_trend = b * (new_level - level) + cb * trend
            season[t % p] = g * (yt - level - trend) + cg * st
            level, trend = new_level, new_trend
        r = torch.stack(residuals)
        (r * r).sum().backward()
        with torch.no_grad():
            grad = params.grad
            m = BETA1 * m + (1 - BETA1) * grad
            v = BETA2 * v + (1 - BETA2) * grad * grad
            mhat = m / (1 - BETA1 ** i)
            vhat = v / (1 - BETA2 ** i)
            params -= LR * mhat / (torch.sqrt(vhat) + EPS)
            params.grad = None
    return torch.sigmoid(params.detach())


def fit(series: torch.Tensor, periodicity: int, steps: int = STEPS) -> torch.Tensor:
    """(alpha, beta, gamma) fitted to ``series`` (1-d float64, at least two
    cycles of ``periodicity``), as a (3,) float64 tensor on its device. A
    CUDA tensor runs the CUDA kernel, one launch; a CPU tensor runs the
    plain version."""
    global LAUNCHES
    _check_args(series, periodicity, steps)
    if series.device.type == "cpu":
        return fit_plain(series, periodicity, steps)
    if series.device.type != "cuda":
        raise ValueError(f"holt_winters: unsupported device {series.device}")
    out = torch.empty(3, dtype=torch.float64, device=series.device)
    _launch(series.contiguous(), int(periodicity), int(steps), out)
    LAUNCHES += 1
    return out


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_hw_fit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_hw_fit.restype = ctypes.c_int
    lib.deequ_hw_dfma_cycles.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_hw_dfma_cycles.restype = ctypes.c_int


def _launch(series: torch.Tensor, periodicity: int, steps: int, out: torch.Tensor) -> None:
    """Enqueue one fit on the current stream into ``out`` ((3,) float64),
    with no allocation: :func:`fit` calls it once; ``chip_smoke.py`` times
    it alone. Raises if the launch was refused."""
    lib = cuda_build.library("holt_winters", _bind)
    n = series.numel()
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream(series.device).cuda_stream
        rc = lib.deequ_hw_fit(
            series.data_ptr(), n, periodicity, steps,
            INITIAL_LOGITS[0], INITIAL_LOGITS[1], LR, BETA1, BETA2, EPS,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise DeviceException(
            f"holt_winters kernel launch failed: CUDA error {rc} "
            f"(n={n}, p={periodicity}, steps={steps})"
        )


def dfma_cycles(device, chain: int = 1 << 16) -> float:
    """Cycles of one dependent float64 FMA on ``device``, measured on one
    thread over a chain of ``chain`` (the latency the fit's bound counts:
    one a point and step, csrc/holt_winters.cu says why)."""
    lib = cuda_build.library("holt_winters", _bind)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.deequ_hw_dfma_cycles(chain, cycles.data_ptr(), sink.data_ptr(), stream)
    if rc != 0:
        raise DeviceException(f"dfma latency probe failed: CUDA error {rc}")
    return int(cycles.item()) / chain
