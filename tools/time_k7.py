"""Time K7, the histogram kernel's multi-input entry (``csrc/bincount.cu``,
``fused_bincount``), at a fused group of the main suite against other
builds of the same entry, in turns on one card.

    git archive <parent> | tar -x -C build/parent      # build/ is ignored
    python3 tools/time_k7.py [--parent build/parent] [--shape main|partition]
                             [--split] [--rows N] [NAME=FLAG:VALUE,...]

Builds this checkout's ``bincount.cu`` (``tree``), the parent checkout's
(``parent``, with ``--parent``) and each named variant of this checkout's
source (``cluster1=DEEQU_K7_CLUSTER:1`` builds it with
``-DDEEQU_K7_CLUSTER=1``: the source's ``DEEQU_K7_*`` macros), each with
``nvcc -Xptxas -v`` into ``build/deequ_tpu_torch/probe/``. Each build,
bound in place of the package's library, is held bit for bit against
``fused_bincount_plain`` over chip_smoke.py's ``fused_parity`` cases
(``--no-parity`` skips them; a ``DEEQU_K7_PROBE_*`` build is timed only).
Then every build and the K5 launches the entry replaces (one a set) are
timed in turns, every build and then the K5 launches, then the same in
reverse (``chip_smoke.k7_turns``: the kernel alone, 20 launches queued
behind a device spin, and torch.profiler's time by kernel), at the main
path's fused group (chip_smoke.py's table of ``--rows`` rows, seed 0; the
keys of customer_id, status and region as the grouping layer prepares
them) or, with ``--shape partition``, at one of ``partition_path``'s (the
first of its ten slices: customer_id, id, status and region); ``--split``
also times the wide sets alone and the narrow ones alone. Prints one JSON
line a build (ptxas's registers and shared memory by kernel, parity, both
turns, the profiler's split, the bound and its share), one for the K5
launches, one for the plain version and the library call at the same
shape (``fused_bincount_plain``, and ``torch.bincount`` of the keys the
reference offsets and concatenates on the host, both as chip_smoke.py's
``fused_dispatch_timing`` times them), and the card's name and power
limit.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_probe(name: str, source: str, flags) -> tuple:
    """``source`` compiled with ``-D`` flags into the probe directory,
    loaded and bound as the package binds ``bincount.cu``; returns the
    library and ptxas's report by kernel."""
    from deequ_tpu_torch.ops import cuda_build, histogram_device

    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libbincount_{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in flags), "-o", str(target), source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    report, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # a mangled name spells each identifier as its length, then it
            name_at = re.search(r"(\d+)(bincount_\w*)", m.group(1))
            kernel = (name_at.group(2)[:int(name_at.group(1))] if name_at else m.group(1))
            kernel += "" if kernel not in report else f"#{len(report)}"
            report[kernel] = {}
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            report[kernel].update(registers=int(m.group(1)),
                                  static_smem=int(smem.group(1)) if smem else 0)
        if "spill" in line and kernel:
            report[kernel]["spills"] = line.strip()
    lib = ctypes.CDLL(str(target))
    histogram_device._bind(lib)
    return lib, report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a checkout whose bincount.cu is timed as 'parent'")
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-parity", action="store_true")
    parser.add_argument("--shape", choices=("main", "partition"), default="main")
    parser.add_argument("--split", action="store_true",
                        help="also time each build on the wide inputs alone and the narrow "
                             "ones alone")
    parser.add_argument("variants", nargs="*", help="NAME=FLAG:VALUE,FLAG:VALUE")
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch import native
    from deequ_tpu_torch.ops import cuda_build
    from deequ_tpu_torch.ops import histogram_device as hd
    from deequ_tpu_torch.ops import segment

    if not torch.cuda.is_available():
        print("time_k7: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build("bincount")
    native.build()
    device = torch.device("cuda", 0)
    source = str(cuda_build.CSRC / "bincount.cu")
    builds = {"tree": (source, [])}
    if args.parent:
        builds["parent"] = (os.path.join(os.path.abspath(args.parent), "deequ_tpu_torch",
                                         "csrc", "bincount.cu"), [])
    for arg in args.variants:
        name, _, spec = arg.partition("=")
        builds[name] = (source, [tuple(f.split(":")) for f in spec.split(",") if f])
    libs, rows = {}, {}
    for name, (src, flags) in builds.items():
        libs[name], ptxas = build_probe(name, src, flags)
        rows[name] = {"build": name, "flags": dict(flags), "ptxas": ptxas}

    package = hd._library()
    unheld = [name for name, (_, flags) in builds.items()
              if any(k.startswith("DEEQU_K7_PROBE") for k, _ in flags)]
    for name, lib in list(libs.items()):
        if args.no_parity:
            break
        if name in unheld:
            rows[name]["parity"] = "a probe: computes something else, timed only"
            continue
        cuda_build._LIBS["bincount"] = lib
        try:
            rows[name]["parity"] = cs.fused_parity(device, np.random.default_rng(7),
                                                   hd.regime_widths())
        except SystemExit as e:  # a build that fails parity is reported, not timed
            rows[name]["parity"] = str(e)
            del libs[name]
        finally:
            cuda_build._LIBS["bincount"] = package

    table = cs.make_table(args.rows, 0)
    sets = cs.FUSED_SETS
    if args.shape == "partition":
        table = cs.slice_rows(table, 0, args.rows // cs.PARTITIONS)
        sets = ("customer_id", "id", "status", "region")
    preps = [segment._prepare_grouping(table, [c], device) for c in sets]
    spaces = [p.keyspace for p in preps]
    keys = [torch.from_numpy(p.keys).to(device) for p in preps]
    total = sum(spaces)
    offsets = np.cumsum([0] + spaces[:-1])
    combined = np.concatenate([np.where(p.keys >= 0, p.keys + off, -1)
                               for p, off in zip(preps, offsets)])
    slots = torch.from_numpy(np.where(combined >= 0, combined, total)).to(device)
    del table, preps, combined
    turns = cs.k7_turns(keys, spaces, libs, args.reps, unheld)
    if args.split:
        # the wide inputs alone, and the narrow ones (at most 16,384 bins of
        # their own) alone: an empty input of 100,000 bins keeps them in
        # the partition regime
        wide = [(k, sp) for k, sp in zip(keys, spaces) if sp > 16_384]
        narrow = [(k, sp) for k, sp in zip(keys, spaces) if sp <= 16_384]
        narrow.append((torch.zeros(0, dtype=torch.int64, device=device), 100_000))
        for label, pairs in {"wide_only": wide, "narrow_only": narrow}.items():
            ks, sp = [k for k, _ in pairs], [x for _, x in pairs]
            part = cs.k7_turns(ks, sp, libs, args.reps, unheld)
            for name in libs:
                turns[name][f"{label}_kernel_ms"] = part[name]["kernel_ms"]
                turns[name][f"{label}_profiler_ms"] = part[name]["profiler_ms"]
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    n = sum(k.numel() for k in keys)
    bound_ms = (n * 8 + sum(spaces) * 8) / rate * 1e3
    card = cs.nvidia_smi_line()
    shape = {"shape": args.shape, "sets": list(sets),
             "rows_per_input": [k.numel() for k in keys], "keyspaces": spaces,
             "bound_ms": bound_ms, "bound_by": "bytes", "card": card}
    for name in [*rows, "k5"]:
        row = {**rows.get(name, {"build": name}), **turns.get(name, {}), **shape}
        if row.get("kernel_ms"):
            row["kernel_ms_median"] = statistics.median(row["kernel_ms"])
            row["bound_share"] = bound_ms / row["kernel_ms_median"]
        print(json.dumps(row), flush=True)
    plain_ms = cs.time_queued(lambda i: hd.fused_bincount_plain(keys, spaces), args.reps)
    library_ms = cs.time_queued(lambda i: torch.bincount(slots, minlength=total + 1),
                                args.reps, waits=True)
    print(json.dumps({"build": "plain and library", "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_call": "torch.bincount of the host-offset, concatenated keys",
                      **shape}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
