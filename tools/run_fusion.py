"""Run ``chip_smoke.py``'s ``fusion_path`` phase alone on the card, after
K7's parity cases.

    python3 tools/run_fusion.py [--rows 10000000] [--seed 0]

Builds the kernels, holds K7 (the histogram kernel's multi-input entry,
``fused_bincount``) against its plain version over ``kernel_parity``'s
fused cases, runs ``main_path`` (the main suite over the main table in
memory, checked against numpy, with its fused-launch hold), then the
suite once over the persisted table (the resident run the phase holds to
no fused pass), then the phase: the fused and unfused runs held and timed
in turns, the demotion, K7 alone at the main path's shape. Each step is
one JSON line with the card's name and power limit. Exits non-zero on a
failed hold.
"""

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build, histogram_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS

    if not torch.cuda.is_available():
        print("run_fusion: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    cs.emit({"phase": "build", "card": smi, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    parity = cs.fused_parity(device, np.random.default_rng(7), histogram_device.regime_widths())
    cs.emit({"phase": "kernel_parity", "kernel": "fused_bincount (K7)", "card": smi,
             **parity, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    report, table, main_result = cs.main_path(args.rows, args.seed, device)
    cs.emit({**report, "card": smi, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    suite = cs.build_suite(table)
    table.persist(device)
    suite.run()
    cs.kernel_counts_zero()
    suite.run()
    res_main = {"kernel_launches": cs.kernel_counts(), "scan_stats": SCAN_STATS.snapshot()}
    table.unpersist()
    cs.emit({"phase": "resident_run", "card": smi, **res_main,
             "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    fusion = cs.fusion_path(table, main_result, res_main, device, smi, rate)
    cs.emit({**fusion, "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
