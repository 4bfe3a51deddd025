"""Time ``chip_smoke.py``'s main path ``run()`` of one checkout, to
compare two commits on the same card within one call.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do python3 tools/time_main_path.py $t; done

Builds the checkout's kernels, makes the 10^7-row main table (seed 0),
runs its suite once warm and five times timed (host clock ending in a
device synchronisation), and prints one JSON line.
"""

import json
import os
import statistics
import sys
import time


def main(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    suite = cs.build_suite(cs.make_table(10_000_000, 0))
    suite.run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"tree": tree, "card": cs.nvidia_smi_line(),
                      "main_run_wall_s": walls, "median": statistics.median(walls)}))


if __name__ == "__main__":
    main(sys.argv[1])
