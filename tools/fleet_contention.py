"""Time the serving fleet on the reference probe's 144 tenants with and
without the device turn (``serve/executor.py:_device_turn``).

    python3 tools/fleet_contention.py [--seed 0] [--passes 3] [--out FILE] [--cpu]

For each arm (the turn as shipped; the turn replaced by a null context)
and each submitter count (1 and 4): a 4-worker and a 1-worker fleet, each
warmed by one pass, then ``--passes`` passes of each in turns. Reports
suites/s from each fleet's fastest pass, the fleet's rate over the
1-worker fleet's, and each pass's coalesced batches and dispatch and
drain seconds (``SCAN_STATS``), summed over the workers. Runs on the
card; ``--cpu`` runs it on the CPU. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--passes", type=int, default=3)
    parser.add_argument("--out", default="")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import use_device
    from deequ_tpu_torch.ops.scan_engine import SCAN_STATS
    from deequ_tpu_torch.serve import VerificationFleet, executor

    if args.cpu:
        scope, card = use_device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            print("fleet_contention: no CUDA device", file=sys.stderr)
            return 2
        from deequ_tpu_torch import native
        from deequ_tpu_torch.ops import cuda_build

        cuda_build.build(*cs.KERNELS)
        native.build()
        scope, card = contextlib.nullcontext(), subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    turn = executor._device_turn
    no_turn = lambda device: contextlib.nullcontext()  # noqa: E731 — the arm without it

    def census():
        return (SCAN_STATS.coalesced_batches, SCAN_STATS.dispatch_seconds,
                SCAN_STATS.drain_wait_seconds)

    report = {"card": card, "passes": args.passes, "arms": {}}
    with scope:
        death = cs.fleet_death_load(args.seed)
        analyzers = cs.fleet_analyzers()
        load = [(t, tb, []) for t, tb in death]
        for arm, fn in (("turn", turn), ("no_turn", no_turn)):
            executor._device_turn = fn
            try:
                for subs in (1, cs.FLEET_SUBMITTERS):
                    fleets = {"fleet": VerificationFleet(n_workers=cs.FLEET_WORKERS,
                                                         monitor=False),
                              "one_worker": VerificationFleet(n_workers=1, monitor=False)}
                    runs = {name: [] for name in fleets}
                    try:
                        for flt in fleets.values():
                            cs.fleet_pass(flt, load, threads=subs, required_analyzers=analyzers)
                        for _ in range(args.passes):
                            for name, flt in fleets.items():
                                before = census()
                                wall, futures, _ = cs.fleet_pass(flt, load, threads=subs,
                                                                 required_analyzers=analyzers)
                                cs.fleet_once(futures, f"{arm} {name}")
                                after = census()
                                runs[name].append({
                                    "wall_s": wall, "batches": after[0] - before[0],
                                    "dispatch_s": after[1] - before[1],
                                    "drain_s": after[2] - before[2]})
                    finally:
                        for flt in fleets.values():
                            flt.stop()
                    rates = {name: len(load) / min(r["wall_s"] for r in rs)
                             for name, rs in runs.items()}
                    report["arms"][f"{arm}, {subs} submitters"] = {
                        "fleet_suites_per_s": rates["fleet"],
                        "one_worker_suites_per_s": rates["one_worker"],
                        "fleet_over_one_worker": rates["fleet"] / rates["one_worker"],
                        "passes": runs}
            finally:
                executor._device_turn = turn
    line = json.dumps({"tool": "fleet_contention", **report})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
