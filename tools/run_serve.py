"""Run ``chip_smoke.py``'s ``serve_path`` phase alone on the card.

    python3 tools/run_serve.py [--rows 10000000] [--seed 0] [--out serve_path.json]
                               [--profile serve_worker.txt]

Builds the kernels and the main table (``--rows``, seed ``--seed``; Load B's
tenants are cut from it), then runs the phase with every hold of the script:
Load A (the reference's serving load: 1,000 tenants of 256 rows, cold and
sustained, the serial baseline, latency, kill-and-resume), its traced run,
Load B (64 tenants at main_path's width coalesced, 4 on the whole check
served serially), the isolation parts and the coalesced batch's K1 and
fold-merge timing. Prints the phase's line with the card's name and power
limit (and writes it to ``--out`` when given). ``--profile`` runs the
first service's worker thread (Load A's: its cold, sustained and watched
passes) under cProfile and writes its top functions by own and by
cumulative time to that file. Exits non-zero on a failed hold.
"""

import argparse
import json
import os
import sys
import time


def profile_first_worker(path: str) -> None:
    """Run the first VerificationService worker under cProfile; its stats
    are written to ``path`` when the worker ends."""
    import cProfile
    import io
    import pstats

    from deequ_tpu_torch.serve import service

    original = service.VerificationService._worker
    state = {"done": False}

    def worker(self):
        if state["done"]:
            return original(self)
        state["done"] = True
        prof = cProfile.Profile()
        try:
            prof.runcall(original, self)
        finally:
            out = io.StringIO()
            stats = pstats.Stats(prof, stream=out)
            stats.sort_stats("tottime").print_stats(40)
            stats.sort_stats("cumulative").print_stats(40)
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as fh:
                fh.write(out.getvalue())

    service.VerificationService._worker = worker


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    parser.add_argument("--profile", default="")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_serve: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    build_s = time.perf_counter() - t0
    if args.profile:
        profile_first_worker(args.profile)
    t0 = time.perf_counter()
    table = cs.make_table(args.rows, args.seed)
    serve, _ = cs.serve_path(table, args.seed, device, smi, rate)
    line = {"phase": "serve_path", "card": smi, **serve,
            "seconds": time.perf_counter() - t0, "build_s": build_s}
    cs.emit(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(line, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
