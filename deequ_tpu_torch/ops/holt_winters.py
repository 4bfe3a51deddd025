"""The Holt-Winters parameter fit — the port's counterpart of
``deequ_tpu/anomaly/seasonal.py:_fit_parameters_jax``.

The fit minimises the residual sum of squares of the one-step-ahead
ETS(A,A) forecasts over (alpha, beta, gamma), each the sigmoid of a logit,
with 300 Adam steps (lr 0.05, beta1 0.9, beta2 0.999, eps 1e-8) from the
logits of (0.3, 0.1, 0.1). One formulation per device:

- on a CUDA tensor, :func:`fit` launches the hand-written kernel of
  ``deequ_tpu_torch/csrc/holt_winters.cu``: the whole fit in one launch,
  each Adam step's recursion and its exact gradient evaluated in blocks of
  the series at once (the source says how), for the periodicities 7 and
  12 that ``HoltWinters`` admits; or it raises;
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

from deequ_tpu_torch.exceptions import DeviceException, launch_error
from deequ_tpu_torch.ops import counters, cuda_build

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around its paths)
LAUNCHES = 0

#: Adam steps of one fit, and Adam's settings (seasonal.py:118-122)
STEPS = 300
LR, BETA1, BETA2, EPS = 0.05, 0.9, 0.999, 1e-8
#: the initial logits: the reference's starting point (0.3, 0.1, 0.1)
INITIAL_LOGITS = (math.log(0.3 / 0.7), math.log(0.1 / 0.9), math.log(0.1 / 0.9))

#: the periodicities the kernel is built for: those HoltWinters admits
#: (weekly seasonality of daily metrics, yearly of monthly ones)
KERNEL_PERIODICITIES = (7, 12)
#: the kernel's lanes a warp: block 0, blocks 1 .. B-2 and the p + 2
#: columns of Phi each take one, so B <= 31 - p (csrc/holt_winters.cu)
_WARP = 32


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


def check_kernel_periodicity(periodicity: int) -> None:
    """Raise ValueError unless the kernel is built for ``periodicity``
    (the CPU's plain version takes any)."""
    if periodicity not in KERNEL_PERIODICITIES:
        raise ValueError(
            f"holt_winters: the CUDA kernel fits periodicity 7 or 12 (the "
            f"HoltWinters seasonalities), got {periodicity}"
        )


def max_blocks(periodicity: int) -> int:
    """The most blocks a fit may be cut into: a warp's lanes hold block 0,
    blocks 1 .. B-2 and the p + 2 columns of Phi."""
    return _WARP + 1 - (periodicity + 2)


def blocking(n: int, periodicity: int, block_len: int | None = None) -> tuple:
    """(block_len, blocks) of the kernel's evaluation of n points: blocks of
    ``block_len`` points, a multiple of p (so every block starts at ring
    slot 0), the last holding the rest. By default about sqrt(n) points a
    block, lengthened until at most :func:`max_blocks` blocks remain. A
    ``block_len`` given (the checks' forced blockings, :func:`_launch`)
    must be a positive multiple of p that leaves at most that many
    blocks."""
    p = int(periodicity)
    limit = max_blocks(p)
    if block_len is None:
        block_len = p * max(1, math.floor(math.sqrt(n) / p + 0.5), -(-n // (limit * p)))
    if block_len <= 0 or block_len % p:
        raise ValueError(f"holt_winters: block length {block_len} is not a positive "
                         f"multiple of the periodicity {p}")
    blocks = -(-n // block_len)
    if blocks > limit:
        raise ValueError(f"holt_winters: {blocks} blocks of {block_len} points, "
                         f"at most {limit} at periodicity {p}")
    return block_len, blocks


def _plain_start(series: torch.Tensor, p: int):
    """The centred series as floats and the initial (level, trend, season)
    of seasonal.py:88-91."""
    series = series - series[0]  # centred, as the kernel is (module doc)
    level0 = series[:p].sum() / p
    trend0 = (series[p:2 * p].sum() - series[:p].sum()) / (p * p)
    season0 = list((series[:p] - level0).unbind())
    return series.tolist(), level0, trend0, season0


def _plain_rss(params: torch.Tensor, ys, p: int, level0, trend0, season0) -> torch.Tensor:
    """The residual sum of squares of the one-step-ahead forecasts at the
    logits ``params``, in torch autograd (seasonal.py:93-111)."""
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
    return (r * r).sum()


def gradient_plain(series: torch.Tensor, periodicity: int, logits) -> torch.Tensor:
    """d RSS / d logits at ``logits`` (3 floats), as a (3,) float64 tensor:
    one step's gradient of :func:`fit_plain`."""
    _check_args(series, periodicity, 0)
    p = int(periodicity)
    ys, level0, trend0, season0 = _plain_start(series, p)
    params = torch.tensor(list(logits), dtype=torch.float64, device=series.device,
                          requires_grad=True)
    _plain_rss(params, ys, p, level0, trend0, season0).backward()
    return params.grad.detach()


def fit_plain(series: torch.Tensor, periodicity: int, steps: int = STEPS) -> torch.Tensor:
    """(alpha, beta, gamma) as a (3,) float64 tensor on ``series``' device:
    the fit in torch autograd (module doc)."""
    _check_args(series, periodicity, steps)
    p = int(periodicity)
    ys, level0, trend0, season0 = _plain_start(series, p)
    params = torch.tensor(INITIAL_LOGITS, dtype=torch.float64, device=series.device,
                          requires_grad=True)
    m = torch.zeros(3, dtype=torch.float64, device=series.device)
    v = torch.zeros_like(m)
    for i in range(1, steps + 1):
        _plain_rss(params, ys, p, level0, trend0, season0).backward()
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
    CUDA tensor runs the CUDA kernel, one launch (periodicity 7 or 12); a
    CPU tensor runs the plain version."""
    _check_args(series, periodicity, steps)
    if series.device.type == "cpu":
        return fit_plain(series, periodicity, steps)
    if series.device.type != "cuda":
        raise ValueError(f"holt_winters: unsupported device {series.device}")
    out = torch.empty(3, dtype=torch.float64, device=series.device)
    _launch(series.contiguous(), int(periodicity), int(steps), out)
    counters.inc(globals(), "LAUNCHES")
    return out


#: {(device, steps): the bias-correction table on that device}
_BIAS = {}


def bias_table(steps: int) -> list:
    """Adam's bias-correction divisors, 1 - beta1^i for i = 1 .. steps, then
    1 - beta2^i: Python's ``**``, the bits :func:`fit_plain` divides by."""
    return ([1 - BETA1 ** i for i in range(1, steps + 1)]
            + [1 - BETA2 ** i for i in range(1, steps + 1)])


def _bias(device: torch.device, steps: int) -> torch.Tensor:
    key = (str(device), steps)
    table = _BIAS.get(key)
    if table is None:
        table = torch.tensor(bias_table(steps) or [0.0], dtype=torch.float64, device=device)
        _BIAS[key] = table
    return table


def _bind(lib: ctypes.CDLL) -> None:
    lib.deequ_hw_fit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_hw_fit.restype = ctypes.c_int
    lib.deequ_hw_op_cycles.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.deequ_hw_op_cycles.restype = ctypes.c_int


def _launch(series: torch.Tensor, periodicity: int, steps: int, out: torch.Tensor,
            block_len: int | None = None) -> None:
    """Enqueue one fit on the current stream into ``out`` ((3,) float64),
    in :func:`blocking`'s blocks, with no allocation after a first fit of
    ``steps`` on the device: :func:`fit` calls it once; ``chip_smoke.py``
    times it alone. ``block_len`` is for the checks alone (the tests and
    ``chip_smoke.py`` hold the kernel at forced blockings against the plain
    fit, ``tools/time_holt_winters.py --sweep`` times them); :func:`fit`
    never passes it. Raises if the launch was refused."""
    check_kernel_periodicity(periodicity)
    lib = cuda_build.library("holt_winters", _bind)
    n = series.numel()
    block_len, blocks = blocking(n, periodicity, block_len)
    bias = _bias(series.device, steps)
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream(series.device).cuda_stream
        rc = lib.deequ_hw_fit(
            series.data_ptr(), n, periodicity, steps, block_len, blocks, bias.data_ptr(),
            INITIAL_LOGITS[0], INITIAL_LOGITS[1], LR, BETA1, BETA2, EPS,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise launch_error(
            f"holt_winters kernel launch failed (n={n}, p={periodicity}, steps={steps}, "
            f"blocks={blocks} of {block_len})", rc,
        )


#: the operations whose latency the bound counts, by their code in
#: deequ_hw_op_cycles
LATENCY_OPS = {"fma": 0, "sqrt": 1, "div": 2, "exp": 3}


def op_cycles(device, chain: int = 1 << 14) -> dict:
    """{op: cycles of one dependent float64 op} on ``device`` for each of
    :data:`LATENCY_OPS`, measured on one thread over a chain of ``chain``
    (the latencies the fit's bound counts, csrc/holt_winters.cu says
    which)."""
    lib = cuda_build.library("holt_winters", _bind)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float64, device=device)
    out = {}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for name, code in LATENCY_OPS.items():
            rc = lib.deequ_hw_op_cycles(code, chain, cycles.data_ptr(), sink.data_ptr(),
                                        stream)
            if rc != 0:
                raise DeviceException(f"{name} latency probe failed: CUDA error {rc}")
            out[name] = int(cycles.item()) / chain
    return out
