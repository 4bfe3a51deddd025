"""Run ``chip_smoke.py``'s ``out_of_core_path`` phase alone on the card,
for a quicker look at the streams than the whole script gives.

    python3 tools/run_out_of_core.py [--rows 10000000] [--sketch-rows N] [--seed 0]

Builds the kernels, makes the main table (``--rows``, seed ``--seed``),
runs the main suite over it once in memory (the run the streams are held
against), then the phase's four parts with every hold of the script;
``--sketch-rows`` (default ten times ``--rows``, as the script) sizes the
config-3 stream; the Parquet part reads all ``--rows`` (the script reads
the first half). Prints the script's lines for the parts and one summary
line with the card's name and power limit; exits non-zero on a failed
hold.
"""

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--sketch-rows", type=int, default=None)
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
        print("run_out_of_core: no CUDA device", file=sys.stderr)
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
    sketch_rows = args.sketch_rows or 10 * args.rows
    ooc, _ = cs.out_of_core_path(table, main_result, args.seed, device, smi, sketch_rows,
                                 parquet_cut=1)
    cs.emit({"phase": "out_of_core_path", "card": smi, "rows": args.rows,
             "sketch_rows": sketch_rows, "build_s": build_s, **ooc,
             "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
