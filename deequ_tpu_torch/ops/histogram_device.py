"""Histogram of segment ids — the port's counterpart of
``deequ_tpu/ops/histogram_device.py``.

The reference routes histograms through a tier of variants (scatter,
one-hot MXU matmul, and ``bincount_pallas``, its one Pallas kernel). The
port has one formulation per device:

- on a CUDA tensor, :func:`bincount` launches the hand-written kernel of
  ``deequ_tpu_torch/csrc/bincount.cu`` (shared-memory atomics for narrow
  key spaces, global 64-bit atomics for wide ones; the source says why),
  or raises;
- on a CPU tensor it runs :func:`bincount_plain`, the kernel's plain
  PyTorch version, which is also what tests and ``chip_smoke.py`` hold
  the kernel against.

Contract (the reference's, shared by every variant): counts over
``[0, num_segments)``; ids outside that range — negative sentinels,
padding — are dropped; optional int32 weights replace the 1; results are
exact integers.

The kernel is compiled from the source in the checkout with ``nvcc`` at
first use into ``build/deequ_tpu_torch/`` (rebuilt when the source
changes) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from deequ_tpu_torch.exceptions import DeviceException

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bincount.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deequ_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches since the last reset: one per launch of the CUDA
#: kernel, and nowhere else (chip_smoke.py reads it around the main path)
LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceException(
        "nvcc not found (PATH, $CUDA_HOME/bin): the bincount kernel is built "
        "from deequ_tpu_torch/csrc/bincount.cu at first use"
    )


def build(verbose: bool = False) -> Path:
    """Compile the kernel's shared library if the one for this source's
    hash is missing; returns its path. A failed build raises."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    target = _BUILD_DIR / f"libbincount_{digest}.so"
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise DeviceException(
            f"nvcc failed ({proc.returncode}) building {_SOURCE.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, target)
    return target


def _library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.deequ_bincount.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.deequ_bincount.restype = ctypes.c_int
            lib.deequ_bincount_uses_shared.argtypes = [ctypes.c_longlong]
            lib.deequ_bincount_uses_shared.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def uses_shared_memory(num_segments: int) -> bool:
    """Which regime the kernel takes at this width on the current card."""
    return bool(_library().deequ_bincount_uses_shared(int(num_segments)))


def _check_args(seg, num_segments, weights) -> None:
    if not isinstance(seg, torch.Tensor) or seg.dim() != 1:
        raise ValueError("bincount: seg must be a 1-D tensor")
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"bincount: seg must be int32 or int64, got {seg.dtype}")
    if int(num_segments) < 0:
        raise ValueError(f"bincount: num_segments must be >= 0, got {num_segments}")
    if weights is not None:
        if not isinstance(weights, torch.Tensor) or weights.shape != seg.shape:
            raise ValueError("bincount: weights must be a tensor shaped like seg")
        if weights.dtype != torch.int32:
            raise TypeError(f"bincount: weights must be int32, got {weights.dtype}")
        if weights.device != seg.device:
            raise ValueError("bincount: weights and seg lie on different devices")


def bincount_plain(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """The kernel's plain PyTorch version: out-of-range ids map to a
    trailing slot, one ``index_add_`` counts every slot, the trailing slot
    is cut off."""
    _check_args(seg, num_segments, weights)
    num_segments = int(num_segments)
    slots = torch.where(
        (seg >= 0) & (seg < num_segments), seg, num_segments
    ).to(torch.int64)
    add = (
        torch.ones_like(slots)
        if weights is None
        else weights.to(torch.int64)
    )
    counts = torch.zeros(num_segments + 1, dtype=torch.int64, device=seg.device)
    counts.index_add_(0, slots, add)
    return counts[:num_segments].to(dtype)


def bincount(
    seg: torch.Tensor, num_segments: int, weights=None, dtype=torch.int64
) -> torch.Tensor:
    """Histogram of ``seg`` over ``[0, num_segments)`` (module doc). A CUDA
    tensor runs the CUDA kernel; a CPU tensor runs the plain version."""
    global LAUNCHES
    _check_args(seg, num_segments, weights)
    if seg.device.type == "cpu":
        return bincount_plain(seg, num_segments, weights, dtype)
    if seg.device.type != "cuda":
        raise ValueError(f"bincount: unsupported device {seg.device}")
    if not seg.is_contiguous() or (
        weights is not None and not weights.is_contiguous()
    ):
        raise ValueError("bincount: seg and weights must be contiguous")
    num_segments = int(num_segments)
    out = torch.zeros(num_segments, dtype=torch.int64, device=seg.device)
    n = seg.numel()
    if n == 0 or num_segments == 0:
        return out.to(dtype)
    lib = _library()
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        rc = lib.deequ_bincount(
            seg.data_ptr(), 1 if seg.dtype == torch.int64 else 0,
            None if weights is None else weights.data_ptr(),
            n, num_segments, out.data_ptr(), stream,
        )
    if rc != 0:
        raise DeviceException(
            f"bincount kernel launch failed: CUDA error {rc} "
            f"(n={n}, num_segments={num_segments})"
        )
    LAUNCHES += 1
    return out if dtype == torch.int64 else out.to(dtype)
