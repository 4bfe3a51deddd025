"""Builds and loads the port's hand-written CUDA kernels.

Each kernel is one source ``deequ_tpu_torch/csrc/<name>.cu`` with a plain
C interface. At first use it is compiled with ``nvcc`` for ``sm_90a``
into ``build/deequ_tpu_torch/lib<name>_<hash>.so`` (the hash is the
source's, so an edited source builds anew) and loaded with ``ctypes``.
:func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together. A failed build or load raises
``DeviceCompileException`` (boundary ``"trace"``).

No ``--use_fast_math`` and no ``-ftz=true``: the HLL hash reads the bits
of float32 subnormals, which either flag would flush, and K4's select
keeps the bits of f64 subnormals and NaN payloads.
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
from typing import Callable, Dict

from deequ_tpu_torch.exceptions import DeviceCompileException

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deequ_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceCompileException(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels are built "
        "from deequ_tpu_torch/csrc/*.cu at first use",
        boundary="trace",
    )


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(*names: str, verbose: bool = False) -> Dict[str, Path]:
    """Compile the shared library of every named kernel whose library for
    this source's hash is missing, one ``nvcc`` each, all at once; returns
    {name: path}. With ``verbose``, prints ptxas's register and shared
    memory report of each kernel built."""
    targets = {name: _target(name) for name in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n{out}")
            continue
        if verbose:
            print(out, flush=True)
        os.replace(tmp, todo[name])
    if failed:
        raise DeviceCompileException("\n".join(failed), boundary="trace")
    return targets


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built if needed; ``bind``
    sets its functions' argument and result types once, at load."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise DeviceCompileException(
                    f"loading {path.name} failed: {e}", boundary="trace"
                ) from e
            bind(lib)
            _LIBS[name] = lib
        return lib
