"""Time K1 (csrc/masked_reduce.cu) alone on the resident main chunk's batch
at its built geometry and at others, on one card, to measure what holds it
below its bound.

    python3 tools/time_k1.py [--rows N] [NAME=FLAG:VALUE,FLAG:VALUE ...]

e.g. ``threads512=DEEQU_K1_THREADS:512`` builds the same source with
``-DDEEQU_K1_THREADS=512`` (the source's ``DEEQU_K1_*`` macros: threads a
block, rows a tile, blocks an SM the registers allow, and the probe
switches below). Makes chip_smoke.py's 10^7-row main table (seed 0),
``persist()``s it, records the K1 batch of one pass of the main
check's scan analyzers, then for each build (the unchanged source first,
as ``built``): compiles it with ``nvcc -Xptxas -v`` into
``build/deequ_tpu_torch/probe/``, binds it in place of the package's
library, holds every task against its plain version (chip_smoke.k1_hold)
and times the batch (chip_smoke.time_queued, 20 calls), twice, in turns
(every build, then every build again in reverse order). A build with
``DEEQU_K1_COPY_ONLY`` stages the tiles and computes nothing (its results
are not held). A build with
``DEEQU_K1_STAGE_CLOCK`` reads its clock64 stage counters over one batch
(thread 0's cycles a tile in each stage of ``k1_tiles``: the copies, the
row patterns, phase A, the tile sums, phase B, the partials). Prints one
JSON line a build (registers and shared memory from ptxas, both times, the
bound and share of chip_smoke.k1_bound, the stage cycles) and the card's
name and power limit.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(name: str, flags) -> tuple:
    from deequ_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libmasked_reduce_{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in flags), "-o", str(target),
           str(cuda_build.CSRC / "masked_reduce.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    report = {}
    kernel = None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '\S*?(k1_\w+?)E", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and kernel:
            report[kernel] = {"registers": int(m.group(1)), "static_smem": int(m.group(2))}
        if "spill" in line and kernel:
            report.setdefault(kernel, {})["spills"] = line.strip()
    return target, report


#: k1_tiles' stages, in the order of its clock marks
STAGES = ("copies", "row_patterns", "phase_a", "tile_sums", "phase_b", "partials")


def _stage_cycles(lib, run) -> dict:
    import torch

    buf = (ctypes.c_ulonglong * 8)()
    lib.deequ_k1_stage_cycles.argtypes = [ctypes.c_void_p]
    lib.deequ_k1_stage_cycles(buf)  # zero
    run()
    torch.cuda.synchronize()
    if lib.deequ_k1_stage_cycles(buf) != 0:
        raise SystemExit("deequ_k1_stage_cycles failed")
    tiles = max(int(buf[7]), 1)
    return {"tiles": int(buf[7]), **{k: int(buf[i]) / tiles for i, k in enumerate(STAGES)}}


def main(argv) -> None:
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    rows = 10_000_000
    if argv[:1] == ["--rows"]:
        rows, argv = int(argv[1]), argv[2:]
    variants = [("built", [])]
    for arg in argv:
        name, _, spec = arg.partition("=")
        variants.append((name, [tuple(f.split(":")) for f in spec.split(",") if f]))

    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import AnalysisRunner
    from deequ_tpu_torch.ops import cuda_build, masked_reduce

    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    rate = cs.hbm_rate(torch.cuda.get_device_name(device))
    table = cs.make_table(rows, 0)
    table.persist()
    scanning = list(dict.fromkeys(a for a in cs.build_check().required_analyzers()
                                  if isinstance(a, ScanShareableAnalyzer)))
    with cs.K1Spy() as spy:
        AnalysisRunner._run_scanning_analyzers(table, scanning, device)
    torch.cuda.synchronize()
    _, tasks, offsets = spy.batches[0]
    out = torch.empty(sum(t.n_outputs for t in tasks), dtype=torch.float64, device=device)
    bound = cs.k1_bound(tasks, offsets, rate)

    libs = {}
    for name, flags in variants:
        path, report = _build(name, flags)
        lib = ctypes.CDLL(str(path))
        masked_reduce._bind(lib)
        libs[name] = (lib, report, flags)
    results = {name: {"flags": dict(flags), "ptxas": report, "kernel_ms": []}
               for name, (lib, report, flags) in libs.items()}
    order = [name for name, _ in variants]
    for name in order + order[::-1]:
        cuda_build._LIBS["masked_reduce"] = libs[name][0]
        results[name]["geometry"] = masked_reduce.geometry()
        if not dict(libs[name][2]).get("DEEQU_K1_COPY_ONLY"):
            results[name]["held"] = cs.k1_hold(tasks, f"build {name}")["worst_share_of_bound"]
        results[name]["kernel_ms"].append(cs.time_queued(
            lambda i: masked_reduce.reduce_into(out, tasks, offsets), reps=20))
        if dict(libs[name][2]).get("DEEQU_K1_STAGE_CLOCK"):
            results[name]["stage_cycles_a_tile"] = _stage_cycles(
                libs[name][0], lambda: masked_reduce.reduce_into(out, tasks, offsets))
    table.unpersist()
    card = cs.nvidia_smi_line()
    for name in order:
        r = results[name]
        best = min(r["kernel_ms"])
        print(json.dumps({"build": name, **r, "bound_ms": bound["bound_ms"],
                          "bound_share": bound["bound_ms"] / best, "card": card}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
