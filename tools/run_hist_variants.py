"""Run ``chip_smoke.py``'s K6 parity and ``hist_variant_path`` phase alone on
the card.

    python3 tools/run_hist_variants.py [--rows 10000000] [--seed 0] [--parts parity,sweep,path]

Builds the kernels, then the parts named by ``--parts`` (all three by
default), each printed as one JSON line with the card's name and power
limit: ``parity`` holds K6 against its plain versions (the script's
``onehot_parity``), ``sweep`` times K6, K5 and torch.bincount at the
sweep's widths and prints the cap it sets, and ``path`` makes the main
table (``--rows``, seed ``--seed``), runs the main suite once in memory
(the result the phase holds its runs against) and then the whole phase.
Exits non-zero on a failed hold.
"""

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parts", default="parity,sweep,path")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_hist_variants: no CUDA device", file=sys.stderr)
        return 2
    parts = [p for p in args.parts.split(",") if p]
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS, verbose=True)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    rate, ops_rate = cs.hbm_rate(name), cs.int8_rate(name)
    cs.emit({"phase": "build", "card": smi, "seconds": time.perf_counter() - t0})
    if "parity" in parts:
        t0 = time.perf_counter()
        parity = cs.onehot_parity(device, np.random.default_rng(7))
        cs.emit({"phase": "onehot_parity", "card": smi, **parity,
                 "seconds": time.perf_counter() - t0})
    if "sweep" in parts:
        t0 = time.perf_counter()
        sweep = cs.hist_variant_sweep(device, rate, ops_rate, args.seed)
        cs.emit({"phase": "hist_variant_sweep", "card": smi, **sweep,
                 "seconds": time.perf_counter() - t0})
    if "path" in parts:
        table = cs.make_table(args.rows, args.seed)
        main_result = cs.build_suite(table).run()
        t0 = time.perf_counter()
        hv = cs.hist_variant_path(table, main_result, device, smi, rate, args.seed)
        cs.emit({**hv, "rows": args.rows, "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
