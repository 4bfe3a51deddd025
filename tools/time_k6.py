"""Time K6, the one-hot count (``csrc/onehot.cu``, ``bincount_onehot``),
against other builds of the same source and against K5, in turns on one
card.

    git archive <parent> | tar -x -C build/parent      # build/ is ignored
    python3 tools/time_k6.py [--parent build/parent] [--rows N]
                             [--widths 9,128,...] [NAME=FLAG:VALUE,...]

Builds this checkout's ``onehot.cu`` (``tree``), the parent checkout's
(``parent``, with ``--parent``; a source whose entry takes no scratch is
called as such) and each named variant of this checkout's source
(``group_loads=DEEQU_K6_GROUP_LOADS:1`` builds it with
``-DDEEQU_K6_GROUP_LOADS=1``: the source's ``DEEQU_K6_*`` macros), each
with ``nvcc -Xptxas -v`` into ``build/deequ_tpu_torch/probe/``. At each
width of ``--widths`` (10^7 int64 Zipf ids of chip_smoke.py's sweep, seed
20) every build is held bit for bit against ``bincount_plain`` (a build
that fails is reported and not timed), then every build and K5 in its
regime are timed alone (``chip_smoke.in_turns``: 20 launches queued behind
a device spin, three rounds, the order reversed every other round). Prints
one JSON line a build (ptxas's registers, shared memory and spills by
kernel), one a width (each build's median and rounds, K5's, the bytes
bound), and the card's name and power limit.
"""

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_probe(name: str, source: str, flags) -> tuple:
    """``source`` compiled with ``-D`` flags into the probe directory and
    loaded; returns the library, whether its entry takes scratch, and
    ptxas's report by kernel."""
    from deequ_tpu_torch.ops import cuda_build, histogram_device

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libonehot_{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in flags), "-o", str(target), source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    report, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # a mangled name spells each identifier as its length, then it
            name_at = re.search(r"(\d+)(onehot_\w*)", m.group(1))
            kernel = (name_at.group(2)[:int(name_at.group(1))] if name_at else m.group(1))
            kernel += "" if kernel not in report else f"#{len(report)}"
            report[kernel] = {}
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            report[kernel].update(registers=int(m.group(1)),
                                  static_smem=int(smem.group(1)) if smem else 0)
        if "spill" in line and kernel:
            report[kernel]["spills"] = line.strip()
    lib = ctypes.CDLL(str(target))
    scratch = hasattr(lib, "deequ_onehot_scratch_bytes")
    if scratch:
        histogram_device._bind_onehot(lib)
    else:
        lib.deequ_onehot.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.deequ_onehot.restype = ctypes.c_int
    return lib, scratch, report


def launcher(lib, takes_scratch: bool, seg, m: int):
    """fn(i) enqueueing one launch of ``lib``'s K6 over ``seg`` into a
    zeroed output it adds to, and that output."""
    import torch

    n = seg.numel()
    out = torch.zeros(m, dtype=torch.int64, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    args = [seg.data_ptr(), 1 if seg.dtype == torch.int64 else 0, None, n, m]
    scratch = None
    if takes_scratch:
        nbytes = lib.deequ_onehot_scratch_bytes(m, n, 0)
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=seg.device)
        args.append(scratch.data_ptr() if nbytes else None)

    def fn(i, _scratch=scratch):  # the scratch lives as long as the launcher
        rc = lib.deequ_onehot(*args, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"onehot launch failed: CUDA error {rc}")

    return fn, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a checkout whose onehot.cu is timed as 'parent'")
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--widths", default="9,128,1024,2048,5001,16384,131072,4194304")
    parser.add_argument("variants", nargs="*", help="NAME=FLAG:VALUE,FLAG:VALUE")
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import histogram_device as hd

    if not torch.cuda.is_available():
        print("time_k6: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build("bincount")
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    source = str(cuda_build.CSRC / "onehot.cu")
    builds = {"tree": (source, [])}
    if args.parent:
        builds["parent"] = (os.path.join(os.path.abspath(args.parent), "deequ_tpu_torch",
                                         "csrc", "onehot.cu"), [])
    for arg in args.variants:
        name, _, spec = arg.partition("=")
        builds[name] = (source, [tuple(f.split(":")) for f in spec.split(",") if f])
    libs = {}
    for name, (src, flags) in builds.items():
        lib, takes_scratch, ptxas = build_probe(name, src, flags)
        libs[name] = (lib, takes_scratch)
        cs.emit({"build": name, "flags": dict(flags), "scratch_api": takes_scratch,
                 "ptxas": ptxas, "card": smi})

    rng = np.random.default_rng(20)
    for m in (int(w) for w in args.widths.split(",")):
        seg = torch.from_numpy(cs.zipf_ids(rng, args.rows, m)).to(device)
        want = hd.bincount_plain(seg, m)
        fns, held = {}, {}
        for name, (lib, takes_scratch) in libs.items():
            fn, out = launcher(lib, takes_scratch, seg, m)
            fn(0)
            torch.cuda.synchronize()
            held[name] = bool(torch.equal(out, want))
            if held[name]:
                fns[name] = fn
        regime = hd.regime(m)
        bufs = hd._buffers(seg, m, None, regime)
        fns["k5"] = lambda i: hd._launch(seg, m, None, *bufs, regime_name=regime)
        turns = cs.in_turns(fns, args.reps)
        bound_ms = (seg.numel() * 8 + m * 8) / rate * 1e3
        cs.emit({"num_segments": m, "n": seg.numel(), "ids": "int64 Zipf",
                 "held_bit_for_bit": held, "regime_k5": regime,
                 "median_ms": {k: statistics.median(v) for k, v in turns.items()},
                 "turns_ms": turns, "bound_ms": bound_ms, "bound_by": "bytes", "card": smi})
        del seg, want, fns, bufs
    return 0


if __name__ == "__main__":
    sys.exit(main())
