"""Stream BASELINE config 4 at its full size under a group memory budget on
the card, or run ``chip_smoke.py``'s ``spill_path`` phase alone.

    python3 tools/run_spill.py [--rows 100000000] [--batch-rows 1048576]
                               [--budget BYTES] [--seed 0]
    python3 tools/run_spill.py --phase [--rows 10000000] [--seed 0]

Default: config 4 (one string column of rows // 3 distinct labels
``id_%09d``, uniform codes) from a ``GeneratorBatchSource`` whose batch b
draws its codes from (seed, b) and labels them with the batch's own
dictionary, so the table is never held; the config 4 check
(ApproxCountDistinct, Histogram with 1,000 detail bins, Uniqueness) runs
under ``--budget`` (default ``spill.DEFAULT_BUDGET_BYTES``, 512 MiB). The
Histogram's bins, its number of bins and Uniqueness are held against a
numpy ``bincount`` of the same codes made again batch by batch; the run
prints its wall, rows/s, the spill counters, the spill directories' peak
bytes, the host RSS growth and the launches, with the card's name and
power limit, as one JSON line. Exits non-zero on a failed hold.

``--phase``: builds the kernels, makes the main table (``--rows``, seed
``--seed``), runs the main suite once in memory and once as a stream of
2^20-row batches (the runs the phase holds against), then the phase's
four parts with every hold of the script.
"""

import argparse
import os
import sys
import time


def config4_stream(rows: int, batch_rows: int, seed: int):
    """(StreamingTable, cardinality, codes of batch b): config 4 made a
    batch at a time from (seed, b)."""
    import numpy as np

    from deequ_tpu_torch import StreamingTable
    from deequ_tpu_torch.data.source import GeneratorBatchSource
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType, Field, Schema

    cardinality = max(rows // 3, 1)
    n_batches = -(-rows // batch_rows)

    def codes_of(b: int):
        n = min(batch_rows, rows - b * batch_rows)
        return np.random.default_rng((seed, b)).integers(0, cardinality, n)

    def batches():
        for b in range(n_batches):
            uniq, inv = np.unique(codes_of(b), return_inverse=True)
            labels = np.char.add("id_", np.char.zfill(uniq.astype("U9"), 9)).astype(object)
            yield ColumnarTable([Column("key", DType.STRING,
                                        codes=inv.astype(np.int32), dictionary=labels)])

    schema = Schema([Field("key", DType.STRING)])
    return StreamingTable(GeneratorBatchSource(schema, batches, num_rows=rows)), \
        cardinality, codes_of, n_batches


def full_run(args, smi: str) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import VerificationSuite
    from deequ_tpu_torch.spill import DEFAULT_BUDGET_BYTES

    budget = args.budget or DEFAULT_BUDGET_BYTES
    stream, cardinality, codes_of, n_batches = config4_stream(
        args.rows, args.batch_rows, args.seed)
    suite = (VerificationSuite.on_data(stream).add_check(cs.build_config4_check())
             .with_group_memory_budget(budget))
    cs.kernel_counts_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cs.RssSampler() as rss, cs.SpillDirSampler() as disk:
        result = suite.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cs.kernel_counts()
        spill = cs.spill_counters()
        got = {m.name: m for m in result.metrics.values()}
        del result
    left = disk.left()

    t0 = time.perf_counter()
    counts = np.zeros(cardinality + 1, dtype=np.int64)
    for b in range(n_batches):
        counts[1:] += np.bincount(codes_of(b), minlength=cardinality)
    want_hist = cs.numpy_histogram(
        counts, lambda i: "NullValue" if i == 0 else f"id_{i - 1:09d}", 1000, args.rows)
    want_unique = float((counts == 1).sum()) / args.rows
    numpy_s = time.perf_counter() - t0
    if cs.distribution_of(got["Histogram"]) != want_hist:
        cs.fail("run_spill: the Histogram differs from numpy's bincount")
    if got["Uniqueness"].value.get() != want_unique:
        cs.fail(f"run_spill: Uniqueness {got['Uniqueness'].value.get()} != {want_unique}")
    if left:
        cs.fail(f"run_spill: spill directories left behind: {left}")
    distinct = int((counts > 0).sum())
    return {
        "tool": "run_spill", "card": smi, "rows": args.rows, "batch_rows": args.batch_rows,
        "batches": n_batches, "cardinality": cardinality, "distinct": distinct,
        "budget_bytes": budget, **spill, "spill_dir_peak_bytes": disk.peak,
        "run_wall_s": wall, "rows_per_s": args.rows / wall,
        "host_rss_growth_bytes": rss.growth, "kernel_launches": launches,
        "approx_count_distinct_rel_err":
            abs(got["ApproxCountDistinct"].value.get() - distinct) / distinct,
        "holds": "Histogram 1,000 bins and number of bins, Uniqueness == numpy bincount",
        "numpy_reference_s": numpy_s,
    }


def phase_run(args, smi: str, device) -> dict:
    import chip_smoke as cs
    from deequ_tpu_torch import stream_table

    table = cs.make_table(args.rows, args.seed)
    main_result = cs.build_suite(table).run()
    streamed = cs.build_suite(stream_table(table, batch_rows=cs.OOC_BATCH_ROWS)).run()
    t0 = time.perf_counter()
    spill = cs.spill_path(table, main_result, streamed, args.seed, device, smi, args.rows)
    return {"phase": "spill_path", "card": smi, "rows": args.rows, **spill,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", action="store_true")
    parser.add_argument("--rows", type=int, default=None)
    parser.add_argument("--batch-rows", type=int, default=1 << 20)
    parser.add_argument("--budget", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.rows is None:
        args.rows = 10_000_000 if args.phase else 100_000_000
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("run_spill: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    cuda_build.build(*cs.KERNELS)
    native.build()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    build_s = time.perf_counter() - t0
    line = phase_run(args, smi, device) if args.phase else full_run(args, smi)
    cs.emit({**line, "build_s": build_s})
    return 0


if __name__ == "__main__":
    sys.exit(main())
