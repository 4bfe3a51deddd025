#!/usr/bin/env python3
"""Several processes split a table by row ranges and merge their scan
states over a gloo process group — the port's counterpart of the
reference's ``__graft_entry__.py:dryrun_multihost``.

Each worker joins the group (``parallel/distributed.py:
initialize_multi_host``), builds ``chip_smoke.make_table(rows, seed)`` (the
chip-smoke schema), keeps its ``host_row_range``, persists it on
``--device`` when asked (``--persist``), scans the scan-shareable
analyzers of ``chip_smoke.build_suite`` over it, and folds every worker's
states in rank order with ``merge_process_states``. Rank 0 writes the
merged metrics, as ``{repr(analyzer): value}``, with its times, to
``--out``. The grouping analyzers' frequency tables do not travel through
the fused scan and are not merged, as in the reference's
``dryrun_multihost``.

``--kill-rank R``: worker R exits right after it joined the group; the
others run ``chip_smoke.build_suite`` over the whole table with
``.on_peer_loss("degrade", --peer-timeout)``, as the reference's builder
takes it (the peer check counts the table's rows), and rank 0 writes the
result's ``unverified_row_ranges``, its ``peer_lost`` events and its
status, merging nothing.

Spawn the workers (a free localhost port, one process each, all stopped
on a timeout) and print rank 0's JSON:

    python3 tools/multiprocess_merge.py --spawn 2 --rows 20000 --device cpu \\
        --out /tmp/merged.json [--timeout 120] [--kill-rank 1]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan_analyzers(table):
    """The scan-shareable analyzers of the chip-smoke suite: the states a
    row-range split merges (the grouping sets' frequency tables do not
    travel through the fused scan)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.runner import _is_grouping_shared

    suite = chip_smoke.build_suite(table)
    analyzers = list(suite._required_analyzers)
    for check in suite._checks:
        analyzers.extend(check.required_analyzers())
    unique = list(dict.fromkeys(analyzers))
    return [a for a in unique
            if isinstance(a, ScanShareableAnalyzer) and not _is_grouping_shared(a)]


def metric_values(ctx, analyzers) -> dict:
    out = {}
    for a in analyzers:
        value = ctx.metric(a).value
        out[repr(a)] = value.get() if value.is_success else f"failure: {value.exception}"
    return out


def worker(args) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
    from deequ_tpu_torch.ops.scan_engine import run_scan
    from deequ_tpu_torch.parallel.distributed import (
        host_row_range,
        initialize_multi_host,
        merge_process_states,
    )

    t0 = time.perf_counter()
    initialize_multi_host(args.init, args.world, args.rank)
    if args.kill_rank == args.rank:
        os._exit(0)  # a peer lost before its scan
    times = {"join_s": time.perf_counter() - t0}
    device = torch.device(args.device)
    if args.kill_rank is not None:
        return degraded_worker(args, device, times)
    t = time.perf_counter()
    full = chip_smoke.make_table(args.rows, args.seed)
    start, stop = host_row_range(args.rows)
    shard = chip_smoke.slice_rows(full, start, stop)
    del full
    times["table_s"] = time.perf_counter() - t
    analyzers = scan_analyzers(shard)
    t = time.perf_counter()
    if args.persist:
        shard.persist(device)
    times["persist_s"] = time.perf_counter() - t
    ops, scannable, failures = AnalysisRunner._build_scan_ops(shard, analyzers)
    if failures:
        raise RuntimeError(f"scan ops failed to build: {failures}")
    exec_ops, plan = AnalysisRunner._coalesce_scan_ops(ops)
    t = time.perf_counter()
    results = run_scan(shard, exec_ops, device)
    times["scan_s"] = time.perf_counter() - t
    if args.persist:
        shard.unpersist()
    t = time.perf_counter()
    results = merge_process_states(exec_ops, results)
    times["merge_s"] = time.perf_counter() - t
    ctx = AnalysisRunner._finalize_scanning_analyzers(
        AnalyzerContext.empty(), scannable, plan, results
    )
    if args.rank == 0:
        write_out(args, {"world": args.world, "rows": args.rows, "shard": [start, stop],
                         "device": str(device), "metrics": metric_values(ctx, analyzers),
                         "times": times})
    import torch.distributed as dist

    # a lost peer never reaches a barrier: only a whole group leaves
    # through one
    dist.barrier()
    dist.destroy_process_group()
    return 0


def degraded_worker(args, device, times: dict) -> int:
    """A survivor of ``--kill-rank``: the chip-smoke suite over the whole
    table through the builder's peer-loss policy."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from deequ_tpu_torch.device import use_device
    from deequ_tpu_torch.parallel.distributed import host_row_range

    t = time.perf_counter()
    table = chip_smoke.make_table(args.rows, args.seed)
    times["table_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if args.persist:
        table.persist(device)
    times["persist_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with use_device(device):
        result = (chip_smoke.build_suite(table)
                  .on_peer_loss("degrade", timeout=args.peer_timeout).run())
    times["run_s"] = time.perf_counter() - t
    if args.persist:
        table.unpersist()
    if args.rank == 0:
        failed = [repr(a) for a, m in result.metrics.items() if not m.value.is_success]
        write_out(args, {
            "world": args.world, "rows": args.rows, "shard": list(host_row_range(args.rows)),
            "device": str(device), "status": result.status.value,
            "unverified_row_ranges": [list(r) for r in result.unverified_row_ranges],
            "peer_lost_events": [e for e in result.mesh_events if e["kind"] == "peer_lost"],
            "metrics": len(result.metrics), "failed_metrics": failed, "times": times,
        })
    return 0


def write_out(args, out: dict) -> None:
    with open(args.out, "w") as f:
        json.dump(out, f)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args) -> dict:
    """Start ``args.spawn`` workers, wait for them (all stopped past
    ``args.timeout`` seconds) and return rank 0's JSON."""
    init = f"tcp://127.0.0.1:{free_port()}"
    base = [sys.executable, os.path.abspath(__file__), "--world", str(args.spawn),
            "--init", init, "--rows", str(args.rows), "--seed", str(args.seed),
            "--device", args.device, "--out", args.out,
            "--peer-timeout", str(args.peer_timeout)]
    if args.persist:
        base.append("--persist")
    if args.kill_rank is not None:
        base += ["--kill-rank", str(args.kill_rank)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(args.spawn)]
    deadline = time.monotonic() + args.timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the workers did not finish within {args.timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes[0] != 0 or any(c != 0 for r, c in enumerate(codes) if r != args.kill_rank):
        raise RuntimeError(f"workers exited {codes}:\n" + "\n---\n".join(outs))
    with open(args.out) as f:
        return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spawn", type=int, default=0)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--init", default="")
    parser.add_argument("--rows", type=int, default=20_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--persist", action="store_true")
    parser.add_argument("--kill-rank", type=int, default=None)
    parser.add_argument("--peer-timeout", type=float, default=10.0)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    if args.spawn:
        print(json.dumps(spawn(args)))
        return 0
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
