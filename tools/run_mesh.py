"""Run ``chip_smoke.py``'s ``mesh_path`` phase alone on the card.

    python3 tools/run_mesh.py [--rows 10000000] [--seed 0] [--parts sharded,reshard]

Builds the kernels, makes the main table (``--rows``, seed ``--seed``),
runs the main suite once in memory on one device (the result the phase
holds its sharded runs against), then the phase's parts — ``sharded``,
``reshard``, ``straggler``, ``all_lost``, ``processes``, ``cards``, or
those ``--parts`` names — with every hold of the script, each part
printed as one JSON line with the card's name and power limit, then the
phase's line. Exits non-zero on a failed hold.
"""

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parts", default="")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_mesh: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    build_s = time.perf_counter() - t0
    table = cs.make_table(args.rows, args.seed)
    main_result = cs.build_suite(table).run()
    t0 = time.perf_counter()
    mesh = cs.mesh_path(table, main_result, args.rows, args.seed, device, smi, rate,
                        parts=[p for p in args.parts.split(",") if p] or None)
    cs.emit({"phase": "mesh_path", "card": smi, "rows": args.rows, **mesh,
             "seconds": time.perf_counter() - t0, "build_s": build_s})
    return 0


if __name__ == "__main__":
    sys.exit(main())
