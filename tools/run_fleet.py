"""Run ``chip_smoke.py``'s ``fleet_path`` phase alone on the card.

    python3 tools/run_fleet.py [--rows 10000000] [--seed 0] [--out fleet_path.json]

Builds the kernels, the main table (``--rows``, seed ``--seed``; the
whole-check tenants are cut from it past Load B's) and Load A (serve_path's
1,000 tenants), then runs the phase with every hold of the script: the
healthy fleet against a 1-worker fleet in turns, the scripted death, the
monitored stall and warm rejoin, the shared quarantine, the durable ledger
and the whole-check tenants. Prints the phase's line with the card's name
and power limit (and writes it to ``--out`` when given). Exits non-zero on
a failed hold.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_fleet: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = cs.make_table(args.rows, args.seed)
    load = cs.serve_load(args.seed)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = cs.fleet_path(table, load, args.seed, device, smi)
    line = {"phase": "fleet_path", "card": smi, **fleet,
            "seconds": time.perf_counter() - t0, "build_s": build_s, "setup_s": setup_s}
    cs.emit(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(line, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
