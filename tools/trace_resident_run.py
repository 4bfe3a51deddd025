"""Trace one whole resident ``main_path`` ``run()`` of a checkout on a card,
to compare two commits on the same card within one call.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do python3 tools/trace_resident_run.py $t; done

Imports ``deequ_tpu_torch`` and ``chip_smoke.py`` from the checkout given
(its kernels, table and suite), builds its kernels, makes the 10^7-row
main table (seed 0) and ``persist()``s it, runs the suite once warm and
three times timed (host clock ending in a device synchronisation), then
once under torch.profiler through this checkout's
``chip_smoke.trace_run`` (the device's busy and idle share of the run's
window, its kernels, the host time between launches), then the given
checkout's own ``chip_smoke.fused_scan_timing`` (its K1 alone on the
resident main chunk's batch, every task held against its plain version,
its bound; the fused scan's device kernels), and prints one JSON line with
the card's name and power limit.
"""

import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _this_chip_smoke():
    spec = importlib.util.spec_from_file_location("trace_chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(tree: str, rows: int = 10_000_000) -> None:
    tracer = _this_chip_smoke()
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
    table = cs.make_table(rows, 0)
    table.persist()
    suite = cs.build_suite(table)
    suite.run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        suite.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace = tracer.trace_run(suite.run)
    k1 = cs.fused_scan_timing(table, device, cs.hbm_rate(torch.cuda.get_device_name(device)))
    table.unpersist()
    print(json.dumps({"tree": tree, "card": tracer.nvidia_smi_line(), "rows": rows,
                      "resident_run_wall_s": walls,
                      "median": statistics.median(walls), "trace": trace,
                      "k1_fused_scan": k1}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:]))
