"""Time K9, the Holt-Winters fit kernel, of one checkout, to compare two
commits on the same card within one call.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do python3 tools/time_holt_winters.py $t; done

Builds the checkout's kernel and times it alone as ``chip_smoke.py``'s
``holt_winters_timing`` does (CUDA events, the median of 5 after a warm
launch; here also over 25) on the weekly parity series at n = 365 and
730 (p = 7, 300 steps, seed 0), and prints one JSON line with the
fitted (alpha, beta, gamma).
"""

import json
import os
import sys


def main(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch.ops import cuda_build, holt_winters

    cuda_build.build("holt_winters")
    device = torch.device("cuda", 0)
    cases = cs.hw_parity_cases(0)
    out = {"tree": tree, "card": cs.nvidia_smi_line()}
    for name in ("weekly_n365", "weekly_n730"):
        series, n, p = cases[name]
        x = torch.tensor(series[:n], device=device)
        buf = torch.empty(3, dtype=torch.float64, device=device)

        def launch():
            holt_winters._launch(x, p, holt_winters.STEPS, buf)

        out[name] = {"kernel_ms_median_of_5": cs.time_cuda(launch, reps=5, warmup=1),
                     "kernel_ms_median_of_25": cs.time_cuda(launch, reps=25, warmup=1),
                     "abg": buf.tolist()}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
