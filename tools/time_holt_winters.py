"""Time K9, the Holt-Winters fit kernel, of one checkout, to compare two
commits on the same card within one call.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do python3 tools/time_holt_winters.py $t; done
    python3 tools/time_holt_winters.py . --sweep      # every blocking, held to the plain fit

Builds the checkout's kernel and times it alone as ``chip_smoke.py``'s
``holt_winters_timing`` does (CUDA events, the median of 5 after a warm
launch; here also over 25) on the parity series at n = 365 and 730
(weekly, p = 7) and n = 730 (monthly, p = 12), 300 steps, seed 0, and
prints one JSON line with the fitted (alpha, beta, gamma), the card's
``nvidia-smi`` name and power limit, and, where the checkout's kernel
evaluates in blocks, the blocks it chose and the f64 latencies its bound
counts. Where the checkout's source has the stage clock, it also builds
the probe library (the same source with ``-DDEEQU_HW_STAGE_CLOCK``: the
kernel reads clock64 at its warp synchronisation points) and prints the
cycles of each stage of a step, with the probe fit's distance from the
package kernel's (``stage_probe_abg_diff``). With ``--sweep`` (a checkout
with blocks) it also times every block length the kernel takes at each
shape (the median of 5) and holds each one's 10-step fit against the
plain version's 10 steps on the card (``max_abs_err``).
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

CASES = ("weekly_n365", "weekly_n730", "monthly_n730")
#: the stages of a step, as the probe build's clock64 reads cut them:
#: block 0, the driven responses and Phi's columns; the join; the replay;
#: the gradient's warp reduction; the Adam update, the sigmoid and the
#: barrier
STAGES = ("drive", "join", "replay", "reduce", "update")


def main(tree: str, sweep: bool = False) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from deequ_tpu_torch.ops import cuda_build, holt_winters

    cuda_build.build("holt_winters")
    probe = stage_clock_library(cuda_build)
    device = torch.device("cuda", 0)
    cases = cs.hw_parity_cases(0)
    blocking = getattr(holt_winters, "blocking", None)
    out = {"tree": tree, "card": cs.nvidia_smi_line()}
    if hasattr(holt_winters, "op_cycles"):
        out["op_cycles"] = holt_winters.op_cycles(device)
    for name in CASES:
        series, n, p = cases[name]
        x = torch.tensor(series[:n], device=device)
        buf = torch.empty(3, dtype=torch.float64, device=device)

        def launch():
            holt_winters._launch(x, p, holt_winters.STEPS, buf)

        row = {"kernel_ms_median_of_5": cs.time_cuda(launch, reps=5, warmup=1),
               "kernel_ms_median_of_25": cs.time_cuda(launch, reps=25, warmup=1),
               "abg": buf.tolist()}
        if blocking is not None:
            row["block_len"], row["blocks"] = blocking(n, p)
        if probe is not None:
            row["stage_cycles"], abg = stage_cycles(probe, holt_winters, x, p)
            row["stage_probe_abg_diff"] = max(abs(a - b) for a, b in zip(abg, row["abg"]))
        if sweep:
            row["sweep"] = sweep_blocks(holt_winters, cs, x, p)
        out[name] = row
    print(json.dumps(out))


def stage_clock_library(cuda_build):
    """The checkout's kernel built with -DDEEQU_HW_STAGE_CLOCK beside the
    package's library, or None where its source has no stage clock."""
    source = cuda_build.CSRC / "holt_winters.cu"
    text = source.read_bytes()
    if b"DEEQU_HW_STAGE_CLOCK" not in text:
        return None
    digest = hashlib.sha256(text).hexdigest()[:16]
    target = cuda_build.BUILD_DIR / f"libholt_winters_stage_clock_{digest}.so"
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DDEEQU_HW_STAGE_CLOCK",
                        "-o", str(target), str(source)], check=True)
    lib = ctypes.CDLL(str(target))
    lib.deequ_hw_fit_stage_clock.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.deequ_hw_fit_stage_clock.restype = ctypes.c_int
    return lib


def stage_cycles(lib, holt_winters, x, p: int):
    """({stage: cycles a step}, the fitted (alpha, beta, gamma)) of one
    300-step fit by the probe build at the default blocks: each warp's
    cycles in the stage over the steps, the mean over the three warps."""
    import torch

    n, steps = x.numel(), holt_winters.STEPS
    block_len, blocks = holt_winters.blocking(n, p)
    bias = holt_winters._bias(x.device, steps)
    out = torch.empty(3, dtype=torch.float64, device=x.device)
    clocks = torch.zeros(3, len(STAGES), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.deequ_hw_fit_stage_clock(
        x.data_ptr(), n, p, steps, block_len, blocks, bias.data_ptr(),
        holt_winters.INITIAL_LOGITS[0], holt_winters.INITIAL_LOGITS[1], holt_winters.LR,
        holt_winters.BETA1, holt_winters.BETA2, holt_winters.EPS,
        out.data_ptr(), clocks.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stage-clock probe launch failed: CUDA error {rc}")
    per_step = clocks.double().mean(dim=0) / steps
    return dict(zip(STAGES, per_step.tolist())), out.tolist()


def sweep_blocks(holt_winters, cs, x, p: int) -> list:
    """Every block length the kernel takes at this shape: kernel ms (the
    median of 5) and the 10-step fit's distance from the plain one's."""
    import torch

    n = x.numel()
    want = holt_winters.fit_plain(x, p, steps=10)
    buf = torch.empty(3, dtype=torch.float64, device=x.device)
    rows = []
    for block_len in range(p, n + p, p):
        if -(-n // block_len) > holt_winters.max_blocks(p):
            continue
        holt_winters._launch(x, p, 10, buf, block_len)
        err = (buf - want).abs().max().item()
        ms = cs.time_cuda(lambda: holt_winters._launch(x, p, holt_winters.STEPS, buf, block_len),
                          reps=5, warmup=1)
        rows.append({"block_len": block_len, "blocks": -(-n // block_len), "kernel_ms": ms,
                     "max_abs_err_10_steps": err})
    return rows


if __name__ == "__main__":
    main(sys.argv[1], "--sweep" in sys.argv[2:])
