"""Time the main suite with the watchdog armed and not, call by call.

    python3 tools/time_watchdog.py [--rows 10000000] [--runs 4] [--deadline 2.0]

Builds the kernels, makes the main table (``chip_smoke.make_table``), warms
both suites, then runs the main suite unarmed and with
``with_device_deadline(--deadline)`` in turns, ``--runs`` times each, and
prints one JSON line: each side's walls and the median seconds of each
kind of ``device_call`` (a chunk's transfer — host packing and the copy
to the card —, its step, the fetch); then a 2.5·10^6-row chunk packed and
copied, and packed alone, on this thread and on a watchdog worker, in
turns. With the card's name and power limit. Answers whether an armed
run's cost is the watchdog or where its worker runs the host's packing.
"""

import argparse
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--deadline", type=float, default=2.0)
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build, device_policy, scan_engine

    if not torch.cuda.is_available():
        print("time_watchdog: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    table = cs.make_table(args.rows, 0)
    suites = {"unarmed": cs.build_suite(table),
              "armed": cs.build_suite(table).with_device_deadline(args.deadline)}
    for suite in suites.values():
        suite.run()

    calls = []
    original = scan_engine.device_call

    def timed_call(fn, boundary, what="device call", deadline=None, hook_ctx=None,
                   device=None):
        t0 = time.perf_counter()
        try:
            return original(fn, boundary, what, deadline, hook_ctx, device)
        finally:
            kind = f"chunk {what.split()[-1]}" if what.startswith("chunk") else what
            calls.append((kind, time.perf_counter() - t0))

    scan_engine.device_call = timed_call
    runs = {name: [] for name in suites}
    try:
        for _ in range(args.runs):
            for name, suite in suites.items():
                calls.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                suite.run()
                torch.cuda.synchronize()
                by_kind = {}
                for kind, seconds in calls:
                    by_kind[kind] = by_kind.get(kind, 0.0) + seconds
                runs[name].append((time.perf_counter() - t0, by_kind))
    finally:
        scan_engine.device_call = original

    packer = scan_engine._ChunkPacker({n: table[n] for n in table.column_names})
    rows = min(2_500_000, args.rows)

    def pack_copy():
        packer.to_device(packer.pack(0, rows), device)
        torch.cuda.synchronize()

    pieces = {}
    for label, fn in (("pack_and_copy", pack_copy), ("pack", lambda: packer.pack(0, rows))):
        for where in ("caller", "worker", "caller", "worker"):
            t0 = time.perf_counter()
            if where == "caller":
                fn()
            else:
                device_policy.call_with_deadline(fn, 60.0, label, "transfer", device)
            pieces.setdefault(f"{label}_{where}_s", []).append(time.perf_counter() - t0)
    line = {"tool": "time_watchdog", "card": cs.nvidia_smi_line(), "rows": args.rows,
            "deadline_s": args.deadline, "chunk_rows_of_pieces": rows, **pieces}
    for name, items in runs.items():
        line[f"{name}_wall_s"] = [w for w, _ in items]
        line[f"{name}_wall_s_median"] = statistics.median(w for w, _ in items)
        kinds = sorted({k for _, by in items for k in by})
        line[f"{name}_call_s_median"] = {
            k: statistics.median(by.get(k, 0.0) for _, by in items) for k in kinds}
    cs.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
