"""Run ``chip_smoke.py``'s ``device_fault_path`` phase alone on the card.

    python3 tools/run_device_faults.py [--rows 10000000] [--seed 0]

Builds the kernels, makes the main table (``--rows``, seed ``--seed``),
runs the main suite once in memory (the run the phase holds its later
runs against, bit for bit), then the phase's four parts — ``real_oom``,
``injected_oom_mid_fold``, ``hang``, ``budget_degrade`` — with every hold
of the script, each part printed as one JSON line with the card's name
and power limit, then the phase's line. Exits non-zero on a failed hold.
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
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_device_faults: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    build_s = time.perf_counter() - t0
    table = cs.make_table(args.rows, args.seed)
    main_result = cs.build_suite(table).run()
    t0 = time.perf_counter()
    faults = cs.device_fault_path(table, main_result, device, smi)
    cs.emit({"phase": "device_fault_path", "card": smi, "rows": args.rows, **faults,
             "seconds": time.perf_counter() - t0, "build_s": build_s})
    return 0


if __name__ == "__main__":
    sys.exit(main())
