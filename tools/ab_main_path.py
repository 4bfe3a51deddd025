"""Time two checkouts' main suite in turns on one card: an A/B of two trees.

    python3 tools/ab_main_path.py --base DIR [--runs 5] [--rows 10000000]

``DIR`` is the root of another checkout of the repo (for example the parent
commit, unpacked with ``git archive``). One worker process a tree imports
that tree's ``deequ_tpu_torch`` and ``chip_smoke``, builds its kernels,
makes ``chip_smoke``'s main table (``make_table(--rows, 0)``) and warms its
suite. Then the two workers run, one at a time and in turns (base, this,
this, base, ...), ``--runs`` times each:

- ``stream``: the main suite's ``run()`` over the table in memory, its
  chunks packed and copied each run;
- ``persist``: ``unpersist()`` then ``persist()`` of the table;
- ``resident``: the main suite's ``run()`` over the persisted table.

Prints one JSON line: each tree's walls and medians of each kind, the
ratio of the medians (this tree over the base), whether the two trees'
metrics were the same, and the card's name and power limit. The same line
goes to ``chiprun_out/ab_main_path.json``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

KINDS = ("stream", "persist", "resident")
MARK = "AB_RESULT "


def worker(root: str, rows: int) -> int:
    """Serve timing requests for the checkout at ``root`` (stdin: one kind
    a line; stdout: one marked JSON line a request)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    table = cs.make_table(rows, 0)
    suite = cs.build_suite(table)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def repersist():
        if table._device_cache is not None:
            table.unpersist()
        table.persist(device)

    warm = suite.run()
    metrics = sorted(
        (repr(a), repr(m.value.get()) if m.value.is_success else "failure")
        for a, m in warm.metrics.items()
    )
    repersist()
    suite.run()
    table.unpersist()
    print(MARK + json.dumps({"ready": True, "metrics": metrics}), flush=True)
    for line in sys.stdin:
        kind = line.strip()
        if kind == "quit":
            break
        if kind == "persist":
            if table._device_cache is not None:
                table.unpersist()
            seconds = timed(lambda: table.persist(device))
        elif kind in ("stream", "resident"):
            if (table._device_cache is not None) != (kind == "resident"):
                raise RuntimeError(f"{kind}: the table's residency is not as asked")
            seconds = timed(suite.run)
        else:
            raise ValueError(f"unknown request {kind!r}")
        print(MARK + json.dumps({"kind": kind, "s": seconds}), flush=True)
    return 0


class Worker:
    def __init__(self, root: str, rows: int):
        self.root = root
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", root, "--rows", str(rows)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1,
        )

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(MARK):
                return json.loads(line[len(MARK):])
        raise RuntimeError(f"worker for {self.root} ended (rc {self.proc.wait()})")

    def ask(self, kind: str) -> float:
        self.proc.stdin.write(kind + "\n")
        self.proc.stdin.flush()
        return self.read()["s"]

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", help="root of the checkout to compare with")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.rows)
    if not args.base:
        parser.error("--base is required")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ab_main_path: no CUDA device", file=sys.stderr)
        return 2
    trees = {"base": Worker(os.path.abspath(args.base), args.rows), "this": Worker(root, args.rows)}
    try:
        ready = {name: w.read() for name, w in trees.items()}
        walls = {name: {kind: [] for kind in KINDS} for name in trees}
        for kind in KINDS:
            for r in range(args.runs):
                order = ("base", "this") if r % 2 == 0 else ("this", "base")
                for name in order:
                    walls[name][kind].append(trees[name].ask(kind))
    finally:
        for w in trees.values():
            w.close()
    line = {"tool": "ab_main_path", "card": cs.nvidia_smi_line(), "rows": args.rows,
            "runs": args.runs,
            "same_metrics": ready["base"]["metrics"] == ready["this"]["metrics"],
            "metrics": len(ready["this"]["metrics"])}
    for name in trees:
        for kind in KINDS:
            line[f"{name}_{kind}_s"] = walls[name][kind]
            line[f"{name}_{kind}_s_median"] = statistics.median(walls[name][kind])
    for kind in KINDS:
        line[f"{kind}_this_over_base"] = (line[f"this_{kind}_s_median"]
                                          / line[f"base_{kind}_s_median"])
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "ab_main_path.json"), "w") as f:
        json.dump(line, f)
    cs.emit(line)
    return 0 if line["same_metrics"] else 1


if __name__ == "__main__":
    sys.exit(main())
