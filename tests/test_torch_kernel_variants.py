"""The port's histogram kernel-variant tier (``deequ_tpu_torch/ops/
histogram_device.py``, ``device_policy.resolve_hist_variant``, the
``ScanPlan.hist_variant`` seam and the per-variant census on
``ScanStats``), held against the reference on the CPU.

Twins of tests/test_kernel_variants.py on the port's plain versions
(``bincount_onehot_plain`` for "onehot", ``bincount_plain`` for "scatter"
and "pallas"), each also held against the reference's function on the same
inputs made from a seed with numpy — the reference's "pallas" in interpret
mode, as its own tests run it. Exact throughout: counts are integers.

Beyond the twins: the reference's and the port's policies agree over a
grid of widths and rows (equal caps set through both packages' switches);
int64 ids past 2^31 drop, as ``np.bincount``'s semantics say (the
reference casts ids to int32 and wraps them, so this case is the port's
alone); the grouping counts and top-k under each forced variant equal the
reference's under the same force; the suite on the chip-smoke schema gives
the same metrics under each forced variant as unforced, in memory and
persisted, over a virtual mesh of 8 members and without; a fused group of
narrow sets resolves "onehot" and counts bit for bit as unfused; the
parity grid takes K6's route edges (the narrow route to 2,048 bins, 512
weighted; the wide route's radix step at 2^21) and the card sweep's
widths to 2^22 at small row counts; ``chip_smoke.cap_from_sweep``, the
rule that sets the card's one-hot cap, holds on made-up sweeps. The
``cuda``-marked cases hold K6 against its plain versions on both routes,
at their edges, with hot tiles, dropped rows, unaligned ids and the
multi-input entry, and run the suite under each forced variant on a
card; they skip here.

Every case resets ``SCAN_STATS`` before it reads it, and reads no other
process-global counter, so it holds under any xdist split.
"""

import struct
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deequ_tpu.ops.histogram_device as ref_hd
import deequ_tpu.ops.segment as ref_segment
import deequ_tpu_torch
import deequ_tpu_torch.ops.segment as port_segment
from deequ_tpu.data.table import Column as RefColumn
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.data.table import DType as RefDType
from deequ_tpu.ops.device_policy import resolve_hist_variant as ref_resolve
from deequ_tpu.parallel.mesh import use_mesh as ref_use_mesh
from deequ_tpu_torch import use_device
from deequ_tpu_torch.analyzers import ApproxQuantile, Mean
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.table import Column, ColumnarTable, DType
from deequ_tpu_torch.envcfg import env_value, registry_snapshot
from deequ_tpu_torch.exceptions import DeviceHangException, EnvConfigError
from deequ_tpu_torch.ops import device_policy, histogram_device
from deequ_tpu_torch.ops.device_policy import (
    HIST_MIN_ROWS,
    HIST_ONEHOT_CPU_MAX_SEGMENTS,
    HIST_ONEHOT_MXU_MAX_SEGMENTS,
    resolve_hist_variant,
)
from deequ_tpu_torch.ops.histogram_device import (
    HIST_VARIANTS,
    _onehot_geometry,
    active_hist_variant,
    bincount,
    bincount_onehot_plain,
    bincount_plain,
    bincount_variant,
    current_hist_variant,
    fused_bincount,
    fused_bincount_plain,
)
from deequ_tpu_torch.ops.scan_engine import SCAN_STATS, run_scan
from deequ_tpu_torch.ops.select_device import PASSES
from deequ_tpu_torch.parallel.mesh import use_mesh
from torch_parity import port_mesh_mode, port_table, smoke_schema_table  # noqa: F401

pytestmark = [pytest.mark.kernelv, pytest.mark.torch_port]

VARIANTS = list(HIST_VARIANTS)
BUDGET = 1 << 30


@pytest.fixture(autouse=True)
def _one_thread_no_force(monkeypatch):
    """One torch thread (tier-1 runs several workers), no force switch of
    either package left set, counters at 0."""
    for name in ("DEEQU_TORCH_HIST_VARIANT", "DEEQU_TPU_HIST_VARIANT"):
        monkeypatch.delenv(name, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    SCAN_STATS.reset()
    yield
    torch.set_num_threads(threads)


def _ref_bincount(seg: np.ndarray, m: int, weights=None) -> np.ndarray:
    """Host reference: counts over [0, m), everything else dropped."""
    keep = (seg >= 0) & (seg < m)
    if weights is None:
        return np.bincount(seg[keep], minlength=m)[:m].astype(np.int64)
    return np.bincount(seg[keep], weights=weights[keep], minlength=m)[:m].astype(np.int64)


def _port(variant, seg: np.ndarray, m: int, weights=None) -> np.ndarray:
    w = None if weights is None else torch.from_numpy(weights.astype(np.int32))
    return bincount_variant(variant, torch.from_numpy(seg), m, weights=w).numpy()


def _reference(variant, seg: np.ndarray, m: int, weights=None) -> np.ndarray:
    w = None if weights is None else jnp.asarray(weights)
    return np.asarray(ref_hd.bincount_variant(
        variant, jnp.asarray(seg), m, jnp, weights=w, dtype=jnp.int64))


# -- kernel parity -------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize(
    "n,m",
    [
        (0, 5),          # empty input
        (1, 1),          # single row, single segment
        (100, 7),        # negatives + tiny keyspace
        (4096, 16),      # exactly one one-hot block
        (4095, 33),      # one row short of the block boundary
        (4097, 33),      # one row past it (second block of 1)
        (8192, 300),     # width past the 128-lane radix (A > 2)
        (5000, 1 << 12),  # square-ish factored split
        # K6's route edges: the weighted narrow edge (512) and the narrow
        # edge (2,048) each side, a wide tile's edge (4,096), and the
        # sweep's wide widths (K5's shared edge, 2^20, 2^22) at 300 rows
        (300, 511),
        (300, 513),
        (300, 2047),
        (300, 2048),
        (300, 2049),
        (300, 4096),
        (300, 4097),
        (300, 58112),
        (300, 1 << 20),
        (300, 1 << 21),        # the wide route's radix step
        (300, (1 << 21) + 1),
        (300, 1 << 22),
    ],
)
def test_bincount_parity(variant, n, m):
    rng = np.random.default_rng(n * 31 + m)
    seg = rng.integers(-2, m, n).astype(np.int64)
    want = _ref_bincount(seg, m)
    np.testing.assert_array_equal(_port(variant, seg, m), want)
    np.testing.assert_array_equal(_reference(variant, seg, m), want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_bincount_dtype_parity(variant, dtype):
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 50, 3000).astype(dtype)
    want = _ref_bincount(seg.astype(np.int64), 50)
    np.testing.assert_array_equal(_port(variant, seg, 50), want)
    np.testing.assert_array_equal(_reference(variant, seg, 50), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bincount_empty_segments_and_trailing_slot(variant):
    """Untouched segments stay zero; the engine's invalid-row idiom (an
    allocated trailing slot, sliced off by the caller) counts exactly."""
    m = 40
    seg = np.array([3, 3, 3, m - 1, m - 1], dtype=np.int64)
    want = np.zeros(m, dtype=np.int64)
    want[3], want[m - 1] = 3, 2
    np.testing.assert_array_equal(_port(variant, seg, m), want)
    np.testing.assert_array_equal(_reference(variant, seg, m), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_weighted_segment_sum_parity(variant):
    rng = np.random.default_rng(9)
    seg = rng.integers(-1, 25, 2048).astype(np.int64)
    w = rng.integers(0, 7, 2048).astype(np.int64)
    want = _ref_bincount(seg, 25, weights=w)
    np.testing.assert_array_equal(_port(variant, seg, 25, w), want)
    np.testing.assert_array_equal(_reference(variant, seg, 25, w), want)


def test_weighted_onehot_exact_past_f32_planes():
    """Twin of the reference's bf16-plane case: the port's weighted one-hot
    plane rides f64, so integer weights whose block totals pass f32's 2^24
    (and int32's) stay exact, each bin's total read mod 2^32 as an int32 —
    bit for bit the scatter form's."""
    rng = np.random.default_rng(11)
    seg = rng.integers(-1, 9, 5000).astype(np.int64)
    for w in (rng.integers(200, 5000, 5000), rng.integers(2**24, 2**31 - 1, 5000),
              rng.integers(-(2**31), 2**31, 5000)):
        w = w.astype(np.int32)
        got = bincount_onehot_plain(torch.from_numpy(seg), 9, torch.from_numpy(w))
        want = bincount_plain(torch.from_numpy(seg), 9, torch.from_numpy(w))
        assert torch.equal(got, want)
        exact = _ref_bincount(seg, 9, weights=w.astype(np.int64))
        np.testing.assert_array_equal(
            got.numpy(), exact.astype(np.uint32).astype(np.int32).astype(np.int64))


def test_onehot_block_boundary_exactness():
    """Row counts straddling the one-hot row-block boundary fold across
    blocks exactly; the port's geometry is the reference's."""
    m = 16
    _, _, block = _onehot_geometry(m)
    rng = np.random.default_rng(2)
    for n in (block - 1, block, block + 1, 2 * block + 3):
        seg = rng.integers(0, m, n).astype(np.int64)
        np.testing.assert_array_equal(_port("onehot", seg, m), _ref_bincount(seg, m))
    for width in (1, 7, 8, 9, 127, 128, 129, 5001, 1 << 16, 1 << 17):
        assert _onehot_geometry(width) == ref_hd._onehot_geometry(width)


def test_host_numpy_path():
    seg = np.array([-1, 0, 2, 2, 9, 4], dtype=np.int64)
    got = port_segment._host_bincount(seg, 5)
    np.testing.assert_array_equal(got, _ref_bincount(seg, 5))
    np.testing.assert_array_equal(got, ref_hd.bincount(seg, 5, np))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [1, 8, 9, 127, 128, 129, 5001, 511, 512, 513, 1024, 2048, 2049])
def test_variants_match_reference_over_widths(variant, m):
    """The port's plain version of each variant against the reference's
    function, int32 and int64 ids, unweighted and weighted, ids on both
    sides of the range."""
    rng = np.random.default_rng(m)
    for dtype in (np.int32, np.int64):
        seg = rng.integers(-3, m + 3, 3000).astype(dtype)
        w = rng.integers(-1000, 1000, 3000).astype(np.int64)
        np.testing.assert_array_equal(_port(variant, seg, m), _reference(variant, seg, m))
        np.testing.assert_array_equal(_port(variant, seg, m, w),
                                      _reference(variant, seg, m, w))


@pytest.mark.parametrize("variant", VARIANTS)
def test_int64_ids_past_int32_are_dropped(variant):
    """Port-only: int64 ids at or past 2^31 lie outside every keyspace and
    drop, as np.bincount's semantics say (the reference casts to int32)."""
    seg = np.array([0, 3, 2**31, 2**31 + 3, 2**32 + 1, 2**40 + 2, -(2**40), 4, 3],
                   dtype=np.int64)
    np.testing.assert_array_equal(_port(variant, seg, 5), _ref_bincount(seg, 5))


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_bincount_variant_matches_plain(variant):
    """The multi-input entry under each variant (its plain version on the
    CPU) is the reference's formulation: offset, concatenate, count."""
    rng = np.random.default_rng(4)
    spaces = [9, 5001, 3]
    keys = [torch.from_numpy(rng.integers(-1, k + 2, 4000)) for k in spaces]
    got = fused_bincount(keys, spaces, variant)
    assert torch.equal(got, fused_bincount_plain(keys, spaces))
    combined = np.concatenate([np.where(k.numpy() >= 0, k.numpy() + off, -1)
                               for k, off in zip(keys, np.cumsum([0] + spaces[:-1]))])
    np.testing.assert_array_equal(got.numpy(), _ref_bincount(combined, sum(spaces)))


# -- active-variant seam -------------------------------------------------------


def test_active_variant_binds_and_restores():
    assert current_hist_variant() == "scatter"
    with active_hist_variant("onehot"):
        assert current_hist_variant() == "onehot"
        with active_hist_variant("pallas"):
            assert current_hist_variant() == "pallas"
        assert current_hist_variant() == "onehot"
    assert current_hist_variant() == "scatter"


def test_active_variant_validates():
    with pytest.raises(ValueError, match="hist variant"):
        with active_hist_variant("mxu"):
            pass
    with pytest.raises(ValueError, match="hist variant"):
        bincount_variant("bogus", torch.zeros(1, dtype=torch.int32), 4)


def test_ambient_bincount_reads_the_bound_variant(monkeypatch):
    """``bincount`` runs the bound variant's version."""
    seen = []
    real = histogram_device.bincount_onehot

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(histogram_device, "bincount_onehot", spy)
    seg = torch.tensor([0, 1, 1, -1])
    bincount(seg, 2)
    assert not seen
    with active_hist_variant("onehot"):
        assert torch.equal(bincount(seg, 2), torch.tensor([1, 2]))
    assert seen == [1]


# -- policy resolution ---------------------------------------------------------


def test_policy_cpu_crossover():
    big = HIST_MIN_ROWS * 4
    assert resolve_hist_variant(
        (HIST_ONEHOT_CPU_MAX_SEGMENTS,), rows=big, platform="cpu") == "onehot"
    assert resolve_hist_variant(
        (HIST_ONEHOT_CPU_MAX_SEGMENTS + 1,), rows=big, platform="cpu") == "scatter"
    # the plan-level rule resolves over the WIDEST pass
    assert resolve_hist_variant(
        (8, HIST_ONEHOT_CPU_MAX_SEGMENTS * 4), rows=big, platform="cpu") == "scatter"


def test_policy_accelerator_cap(monkeypatch):
    """The card's cap: the module default (the sweep's, PERF.md) routes
    widths within it to "onehot" and wider ones to "scatter"; the switch
    moves it, the reference's cap of 2^17 included."""
    big = HIST_MIN_ROWS * 4
    for width in (1, 9, 128, 1024, 1 << 16, 1 << 17, (1 << 17) + 1):
        want = "onehot" if width <= HIST_ONEHOT_MXU_MAX_SEGMENTS else "scatter"
        assert resolve_hist_variant((width,), rows=big, platform="cuda") == want
    monkeypatch.setenv("DEEQU_TORCH_HIST_ACCEL_CAP", str(1 << 17))
    assert resolve_hist_variant((1 << 16,), rows=big, platform="cuda") == "onehot"
    assert resolve_hist_variant(((1 << 17) + 1,), rows=big, platform="cuda") == "scatter"


def test_policy_row_floor_and_unknown_rows():
    assert resolve_hist_variant((16,), rows=HIST_MIN_ROWS - 1, platform="cpu") == "scatter"
    # rows=None means "large" (resident chunks)
    assert resolve_hist_variant((16,), rows=None, platform="cpu") == "onehot"


def test_policy_never_auto_pallas(monkeypatch):
    """"pallas" resolves only through the force switch."""
    monkeypatch.setenv("DEEQU_TORCH_HIST_ACCEL_CAP", str(1 << 22))
    for platform in ("cpu", "cuda"):
        for width in (4, 1 << 16, 1 << 22):
            assert resolve_hist_variant((width,), rows=1 << 22, platform=platform) != "pallas"


def test_policy_force_knob(monkeypatch):
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "pallas")
    assert resolve_hist_variant((1 << 22,), rows=10) == "pallas"
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "onehot")
    assert resolve_hist_variant((1 << 22,), rows=10) == "onehot"
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "mxu")
    with pytest.raises(EnvConfigError):
        env_value("DEEQU_TORCH_HIST_VARIANT")
    with pytest.raises(ValueError):
        resolve_hist_variant((4,), force="mxu")


def test_policy_no_widths_is_scatter():
    assert resolve_hist_variant((), rows=1 << 20) == "scatter"


def test_policy_platform_is_the_default_device():
    """With no platform given, the port's default device decides (the CPU
    here: the CPU cap applies)."""
    with use_device("cpu"):
        assert device_policy.default_platform() == "cpu"
        assert resolve_hist_variant((HIST_ONEHOT_CPU_MAX_SEGMENTS,)) == "onehot"


def _sweep(times):
    """Made-up sweep rows: {width: (K6 ms, K5 ms)}."""
    return [{"num_segments": m, "kernel_ms": k6, "k5_ms": k5} for m, (k6, k5) in times.items()]


@pytest.mark.parametrize("times,cap", [
    # wins everywhere: the widest swept width
    ({9: (0.02, 0.03), 2048: (0.04, 0.05), 1 << 17: (0.06, 0.07)}, 1 << 17),
    # a loss at the narrowest: nothing routes to K6
    ({9: (0.04, 0.03), 2048: (0.04, 0.05), 1 << 17: (0.06, 0.07)}, 0),
    # a band past a loss: the cap stops before the loss, the band is not
    # taken (rows in any order)
    ({1 << 22: (0.1, 0.2), 9: (0.02, 0.03), 5001: (0.09, 0.03), 1 << 20: (0.1, 0.2),
      2048: (0.03, 0.04)}, 2048),
    # a tie is no slower
    ({9: (0.03, 0.03), 128: (0.03, 0.03), 1024: (0.05, 0.04)}, 128),
])
def test_cap_from_sweep_rule(times, cap):
    """chip_smoke.py's rule for the card's one-hot cap: the widest swept
    width such that K6 was no slower than K5 at every swept width up to it."""
    import chip_smoke

    assert chip_smoke.cap_from_sweep(_sweep(times)) == cap


WIDTH_GRID = (1, 8, 31, 32, 33, 64, 1000, 1 << 16, 1 << 17, (1 << 17) + 1, 1 << 22)
ROW_GRID = (None, 1, HIST_MIN_ROWS - 1, HIST_MIN_ROWS, 1 << 20)


@pytest.mark.parametrize("caps", [(32, 1 << 17), (64, 1000), (1, 1 << 22)])
def test_policy_matches_reference(monkeypatch, caps):
    """The reference's resolve_hist_variant and the port's decide alike
    over a grid of widths (one and two a plan) and rows: "cpu" on both
    sides, and the reference's "tpu" against the port's "cuda", with the
    caps set equal through both packages' switches."""
    cpu_cap, accel_cap = caps
    for prefix in ("DEEQU_TPU", "DEEQU_TORCH"):
        monkeypatch.setenv(f"{prefix}_HIST_CPU_CAP", str(cpu_cap))
        monkeypatch.setenv(f"{prefix}_HIST_ACCEL_CAP", str(accel_cap))
    plans = [(w,) for w in WIDTH_GRID] + [(8, w) for w in WIDTH_GRID] + [()]
    for widths in plans:
        for rows in ROW_GRID:
            for ref_platform, port_platform in (("cpu", "cpu"), ("tpu", "cuda")):
                assert resolve_hist_variant(widths, rows, port_platform) == ref_resolve(
                    widths, rows, ref_platform), (widths, rows, port_platform)
    for force in VARIANTS:
        monkeypatch.setenv("DEEQU_TPU_HIST_VARIANT", force)
        monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
        assert resolve_hist_variant((5,), 1, "cpu") == ref_resolve((5,), 1, "cpu") == force


def test_cap_knobs_typed_validation_and_snapshot(monkeypatch):
    """Twin of tests/test_plan_optimizer.py's: the cap switches validate
    typed, appear in the registry snapshot, and steer the caps."""
    snap = registry_snapshot()
    for name in ("DEEQU_TORCH_HIST_CPU_CAP", "DEEQU_TORCH_HIST_ACCEL_CAP",
                 "DEEQU_TORCH_HIST_VARIANT"):
        assert name in snap
    for name in ("DEEQU_TORCH_HIST_CPU_CAP", "DEEQU_TORCH_HIST_ACCEL_CAP"):
        for bad in ("banana", "0"):
            monkeypatch.setenv(name, bad)
            with pytest.raises(EnvConfigError):
                env_value(name)
        monkeypatch.delenv(name)
    assert device_policy.hist_cpu_cap() == HIST_ONEHOT_CPU_MAX_SEGMENTS
    assert device_policy.hist_accel_cap() == HIST_ONEHOT_MXU_MAX_SEGMENTS
    monkeypatch.setenv("DEEQU_TORCH_HIST_CPU_CAP", "77")
    monkeypatch.setenv("DEEQU_TORCH_HIST_ACCEL_CAP", "4096")
    assert (device_policy.hist_cpu_cap(), device_policy.hist_accel_cap()) == (77, 4096)


# -- plan routing through the engine -------------------------------------------


def _quantile_table(n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    return ColumnarTable([Column("v", DType.FRACTIONAL, values=rng.normal(0.0, 1.0, n))])


def _run_resident_quantile(monkeypatch, force=None):
    if force is None:
        monkeypatch.delenv("DEEQU_TORCH_HIST_VARIANT", raising=False)
    else:
        monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
    analyzers = [ApproxQuantile("v", 0.5, relative_error=0.05), Mean("v")]
    with use_device("cpu"), use_mesh(None):
        table = _quantile_table().persist(max_bytes=BUDGET)
        SCAN_STATS.reset()
        ctx = AnalysisRunner.do_analysis_run(table, analyzers)
        snap = SCAN_STATS.snapshot()
        table.unpersist()
    return [ctx.metric(a).value.get() for a in analyzers], snap


@pytest.mark.parametrize("force", ["scatter", "onehot", "pallas"])
def test_resident_quantile_bit_identical_per_variant(monkeypatch, force):
    """Each forced variant gives the exact metrics of the unforced run,
    keeps the zero-sort and one-fetch contracts, and the census names the
    variant: every pass of the plain select is one dispatch under it
    (the port's select runs eight one-byte passes where the reference's
    runs three)."""
    base, _ = _run_resident_quantile(monkeypatch, None)
    got, snap = _run_resident_quantile(monkeypatch, force)
    assert [struct.pack("<d", v) for v in got] == [struct.pack("<d", v) for v in base]
    assert snap["device_sort_passes"] == 0
    assert snap["device_select_passes"] >= 1
    assert snap["device_fetches"] == 1
    assert snap[f"hist_{force}_dispatches"] == PASSES * snap["device_select_passes"]
    for other in set(VARIANTS) - {force}:
        assert snap[f"hist_{other}_dispatches"] == 0


def test_plan_declares_hist_variant(monkeypatch):
    from deequ_tpu_torch.analyzers.sketches import _kll_scan_op
    from deequ_tpu_torch.ops.scan_plan import plan_scan_ops

    op = _kll_scan_op("v", 256)
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "onehot")
    plan = plan_scan_ops([op], None, resident=True, chunk_rows=4096)
    assert plan.hist_variant == "onehot"
    assert plan.select_ops == 1
    # non-resident plans run no histogram passes at all
    monkeypatch.delenv("DEEQU_TORCH_HIST_VARIANT")
    plan = plan_scan_ops([op], None, resident=False, chunk_rows=4096)
    assert plan.hist_variant == "none"
    # unforced on the CPU: the select's width ((k + 2) * 256) is past the
    # CPU one-hot cap, so the policy keeps the scatter variant
    plan = plan_scan_ops([op], None, resident=True, chunk_rows=4096, platform="cpu")
    assert plan.hist_variant == "scatter"
    assert op.hist_widths == ((256 + 2) * 256,)


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_plan_binds_hist_variant_on_the_cpu_only(monkeypatch, platform):
    """The plan binds its variant around a select update only where the
    plain select runs (the CPU); on a card K4 counts its passes itself, so
    the update stays bare while the plan still declares the variant."""
    from deequ_tpu_torch.analyzers.sketches import _kll_scan_op
    from deequ_tpu_torch.ops.scan_plan import plan_scan_ops

    op = _kll_scan_op("v", 256)
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "onehot")
    plan = plan_scan_ops([op], None, resident=True, chunk_rows=4096, platform=platform)
    assert plan.hist_variant == "onehot"
    assert (plan.ops[0].update is op.select_update) == (platform == "cuda")


def test_grouping_counts_identical_across_variants(monkeypatch):
    """The grouping path (dense count + top-k) gives identical states under
    every forced variant, the census counting the forced one."""
    rng = np.random.default_rng(11)
    card = 20
    codes = rng.integers(0, card, 1 << 15).astype(np.int32)
    dic = np.array([f"s{i:03d}" for i in range(card)], dtype=object)
    results = {}
    with use_mesh(None):
        for force in VARIANTS:
            monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
            table = ColumnarTable([Column("k", DType.STRING, codes=codes, dictionary=dic)])
            SCAN_STATS.reset()
            state = port_segment.group_counts_state(table, ["k"], "cpu")
            top = port_segment.group_top_k(table, "k", 5, "cpu")
            assert getattr(SCAN_STATS, f"hist_{force}_dispatches") >= 1, force
            results[force] = (state.as_dict(), state.num_rows, top.num_groups, tuple(top.top))
    assert results["scatter"] == results["onehot"] == results["pallas"]


def _ref_string_table(codes, dic):
    return RefTable([RefColumn("k", RefDType.STRING, codes=codes, dictionary=dic)])


@pytest.mark.parametrize("force", VARIANTS)
def test_grouping_state_matches_reference_per_variant(monkeypatch, force):
    """group_counts_state and group_top_k under each forced variant equal
    the reference's under the same force (its one-device route: its
    "pallas" runs in interpret mode)."""
    rng = np.random.default_rng(13)
    card = 20
    codes = rng.integers(-1, card, 1 << 15).astype(np.int32)
    dic = np.array([f"s{i:03d}" for i in range(card)], dtype=object)
    monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
    monkeypatch.setenv("DEEQU_TPU_HIST_VARIANT", force)
    table = ColumnarTable([Column("k", DType.STRING, codes=codes, dictionary=dic)])
    with use_mesh(None):
        state = port_segment.group_counts_state(table, ["k"], "cpu")
        top = port_segment.group_top_k(table, "k", 5, "cpu")
    ref = _ref_string_table(codes, dic)
    with ref_use_mesh(None):
        ref_state = ref_segment.group_counts_state(ref, ["k"])
        ref_top = ref_segment.group_top_k(ref, "k", 5)
    assert state.as_dict() == ref_state.as_dict()
    assert state.num_rows == ref_state.num_rows
    assert (top.num_groups, tuple(top.top)) == (ref_top.num_groups, tuple(ref_top.top))


# -- the DEEQU_TORCH_HOST_GROUP_LIMIT switch ------------------------------------


def test_host_group_limit_knob_sweeps_threshold(monkeypatch):
    keys = np.array([0, 1, 1, 2, -1, 2, 2], dtype=np.int64)
    ref = np.array([1, 2, 3], dtype=np.int64)

    def device_dispatches():
        return sum(getattr(SCAN_STATS, f"hist_{v}_dispatches") for v in VARIANTS)

    with use_mesh(None):
        monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "1000000")
        assert port_segment.host_group_limit() == 1_000_000
        SCAN_STATS.reset()
        np.testing.assert_array_equal(port_segment._device_bincount(keys, 3, "cpu"), ref)
        assert device_dispatches() == 0  # the host's latency regime: no variant

        monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "0")
        assert port_segment.host_group_limit() == 0
        SCAN_STATS.reset()
        np.testing.assert_array_equal(port_segment._device_bincount(keys, 3, "cpu"), ref)
        assert device_dispatches() == 1  # swept to 0: the device dispatch ran

    monkeypatch.delenv("DEEQU_TORCH_HOST_GROUP_LIMIT")
    assert port_segment.host_group_limit() == port_segment.HOST_GROUP_LIMIT
    monkeypatch.setenv("DEEQU_TORCH_HOST_GROUP_LIMIT", "not-a-number")
    with pytest.raises(EnvConfigError):
        port_segment.host_group_limit()


# -- abandoned-watchdog fetch accounting ---------------------------------------


def test_abandoned_watchdog_fetch_is_dropped():
    """A watchdog call that times out and later wakes up does not add its
    fetch to whatever run is active by then."""
    from deequ_tpu_torch.ops.device_policy import _WATCHDOG_POOL

    SCAN_STATS.reset()
    woke = threading.Event()

    def hung_fetch():
        time.sleep(0.4)
        SCAN_STATS.record_fetch(128)
        woke.set()

    with pytest.raises(DeviceHangException):
        _WATCHDOG_POOL.call(hung_fetch, 0.05, "hung probe", "fetch")
    assert woke.wait(5.0)
    assert SCAN_STATS.snapshot()["device_fetches"] == 0


def test_healthy_watchdog_fetch_still_counts():
    from deequ_tpu_torch.ops.device_policy import _WATCHDOG_POOL

    SCAN_STATS.reset()

    def quick_fetch():
        SCAN_STATS.record_fetch(64)
        return "ok"

    assert _WATCHDOG_POOL.call(quick_fetch, 5.0, "probe", "fetch") == "ok"
    assert SCAN_STATS.snapshot()["device_fetches"] == 1
    assert SCAN_STATS.snapshot()["bytes_fetched"] == 64


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)]


def test_run_scan_unaffected_by_forced_variants(monkeypatch):
    """A plain non-resident scan (the sort, no histogram passes) is
    oblivious to the force switch: the binding only wraps select updates."""
    table = _quantile_table(2048, seed=3)
    ops = [ApproxQuantile("v", 0.5).scan_op(table)]
    with use_mesh(None):
        base = run_scan(table, ops, "cpu")
        monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", "onehot")
        SCAN_STATS.reset()
        forced = run_scan(table, ops, "cpu")
    for b, f in zip(_leaves(base), _leaves(forced)):
        np.testing.assert_array_equal(b, f)
    assert SCAN_STATS.hist_onehot_dispatches == 0


# -- the routes: the suite and a fused group ------------------------------------


ROUTE_ROWS = 20_000


def _route_check(pkg):
    return (
        pkg.Check(pkg.CheckLevel.ERROR, "routes")
        .has_size(lambda n: n > 0)
        .has_mean("f0", lambda v: True)
        .has_approx_quantile("f1", 0.5, lambda v: True)
        .is_unique("id")
        .has_uniqueness(["customer_id"], lambda v: 0 < v < 1)
        .has_distinctness(["status"], lambda v: v > 0)
        .has_entropy("region", lambda v: v > 0)
        .has_histogram_values("status", lambda d: True)
        .has_number_of_distinct_values("region", lambda v: v > 0)
    )


def _metric_bits(result) -> dict:
    out = {}
    for analyzer, metric in result.metrics.items():
        assert metric.value.is_success, metric
        value = metric.value.get()
        out[str(analyzer)] = (struct.pack("<d", value) if isinstance(value, float)
                              else repr(value))
    return out


def _census() -> dict:
    return {v: getattr(SCAN_STATS, f"hist_{v}_dispatches") for v in VARIANTS}


def test_suite_same_metrics_under_every_forced_variant(monkeypatch, port_mesh_mode):
    """The chip-smoke schema's suite (main_path's small CPU twin) gives the
    same metrics under each forced variant as unforced, in memory and
    persisted, over the 8-member virtual mesh and without; a forced run's
    census counts its variant only, and at least once."""
    table = port_table(smoke_schema_table(ROUTE_ROWS, seed=31))
    suite = deequ_tpu_torch.VerificationSuite.on_data(table, device="cpu").add_check(
        _route_check(deequ_tpu_torch))
    for persisted in (False, True):
        if persisted:
            table.persist("cpu", max_bytes=BUDGET)
        monkeypatch.delenv("DEEQU_TORCH_HIST_VARIANT", raising=False)
        SCAN_STATS.reset()
        want = _metric_bits(suite.run())
        for force in VARIANTS:
            monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
            SCAN_STATS.reset()
            got = _metric_bits(suite.run())
            census = _census()
            assert got == want, (force, persisted, port_mesh_mode)
            assert census[force] >= 1, (force, census)
            assert all(n == 0 for v, n in census.items() if v != force), (force, census)
        if persisted:
            table.unpersist()


def test_unforced_narrow_counts_resolve_onehot_on_the_cpu(monkeypatch):
    """Unforced, past the row floor, a count within the CPU cap (status: 9
    slots) resolves "onehot" and a wider one (region) "scatter"."""
    table = port_table(smoke_schema_table(ROUTE_ROWS, seed=32))
    with use_mesh(None):
        SCAN_STATS.reset()
        port_segment.group_top_k(table, "status", 3, "cpu")
        assert _census() == {"scatter": 0, "onehot": 1, "pallas": 0}
        SCAN_STATS.reset()
        port_segment.group_top_k(table, "region", 3, "cpu")
        assert _census() == {"scatter": 1, "onehot": 0, "pallas": 0}


def test_fused_narrow_group_resolves_onehot_bit_for_bit(monkeypatch):
    """A fused group of narrow sets (summed width within the CPU cap, past
    the row floor) resolves "onehot" in one dispatch, and each set's state
    is bit for bit its own unfused pass's."""
    from deequ_tpu_torch.ops.segment import GroupRequest, fused_group_counts

    rng = np.random.default_rng(17)
    n = ROUTE_ROWS
    table = ColumnarTable([
        Column("a", DType.STRING, codes=rng.integers(-1, 8, n).astype(np.int32),
               dictionary=np.array([f"a{i}" for i in range(8)], dtype=object)),
        Column("b", DType.STRING, codes=rng.integers(0, 5, n).astype(np.int32),
               dictionary=np.array([f"b{i}" for i in range(5)], dtype=object)),
        Column("c", DType.BOOLEAN, values=rng.random(n) > 0.3, mask=rng.random(n) > 0.1),
    ])
    requests = [GroupRequest(("a",)), GroupRequest(("b",), "stats"), GroupRequest(("c",))]
    with use_mesh(None):
        want = {0: port_segment.group_counts_state(table, ["a"], "cpu"),
                1: port_segment.group_count_stats(table, ["b"], "cpu"),
                2: port_segment.group_counts_state(table, ["c"], "cpu")}
        SCAN_STATS.reset()
        got = fused_group_counts(table, requests, "cpu")
    assert _census() == {"scatter": 0, "onehot": 1, "pallas": 0}
    assert SCAN_STATS.fused_group_passes == 3
    for i in (0, 2):
        assert got[i].as_dict() == want[i].as_dict() and got[i].num_rows == want[i].num_rows
    assert (got[1].num_rows, got[1].num_groups, got[1].singletons) == (
        want[1].num_rows, want[1].num_groups, want[1].singletons)
    assert struct.pack("<d", got[1].entropy) == struct.pack("<d", want[1].entropy)


# -- on a card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    return torch.device("cuda", 0)


def _onehot_held(seg, m, w=None):
    """K6 on ``seg`` against both plain versions, one launch counted."""
    before = histogram_device.ONEHOT_LAUNCHES
    got = histogram_device.bincount_onehot(seg, m, w)
    assert histogram_device.ONEHOT_LAUNCHES == before + 1
    assert torch.equal(got, bincount_onehot_plain(seg, m, w))
    assert torch.equal(got, bincount_plain(seg, m, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 9, 128, 129, 2047, 2048, 2049, 4095, 4096, 4097, 5001,
                               1 << 16, 1 << 17, 1 << 21, (1 << 21) + 1, 1 << 22])
def test_cuda_onehot_kernel_matches_plain(cuda_device, m):
    """Both routes and their edges (the narrow route to 2,048 bins, wide
    tiles of 1,024 bins to 2^21, of 2,048 past it), int32 and int64 ids,
    unweighted and weighted up to the weighted widest; the multi-input
    entry with this width beside narrow sets."""
    rng = np.random.default_rng(m)
    for dtype in (torch.int32, torch.int64):
        seg = torch.from_numpy(rng.integers(-3, m + 3, 300_000)).to(cuda_device, dtype)
        _onehot_held(seg, m)
        if m <= histogram_device.onehot_widest(True):
            w = torch.from_numpy(rng.integers(-(2**31), 2**31, 300_000).astype(np.int32)).to(
                cuda_device)
            _onehot_held(seg, m, w)
    keys = [torch.from_numpy(rng.integers(-1, k + 2, 100_000)).to(cuda_device)
            for k in (m, 9, 5001)]
    spaces = [m, 9, 5001]
    if sum(spaces) <= histogram_device.onehot_widest():
        assert torch.equal(fused_bincount(keys, spaces, "onehot"),
                           fused_bincount_plain(keys, spaces))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [511, 512, 513, 1023, 1024, 1025, 1 << 20])
def test_cuda_onehot_weighted_edges(cuda_device, m):
    """The weighted route edges (narrow to 512 bins, wide tiles of 512) and
    the weighted widest: any int32 weights, and 255 in every byte (-1)
    with every row in one bin."""
    rng = np.random.default_rng(m)
    seg = torch.from_numpy(rng.integers(-3, m + 3, 300_000)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-(2**31), 2**31, 300_000).astype(np.int32)).to(cuda_device)
    _onehot_held(seg, m, w)
    one = torch.full((2_000_000,), m - 1, dtype=torch.int64, device=cuda_device)
    _onehot_held(one, m, torch.full_like(one, -1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot tile", "all dropped", "past 2^31", "offset"])
def test_cuda_onehot_edge_inputs(cuda_device, case):
    """10^7 ids in one bin at 2^17 (a hot tile over every multiplying
    block), all rows dropped, int64 ids past 2^31, ids off a 16-byte
    boundary (the narrow route's head and tail rows)."""
    rng = np.random.default_rng(21)
    if case == "hot tile":
        _onehot_held(torch.full((10_000_000,), 1 << 16, dtype=torch.int64,
                                device=cuda_device), 1 << 17)
    elif case == "all dropped":
        for m in (9, 2048, 4097, 1 << 17):
            _onehot_held(torch.full((100_000,), -1, dtype=torch.int64, device=cuda_device), m)
            _onehot_held(torch.full((100_000,), m, dtype=torch.int64, device=cuda_device), m)
    elif case == "past 2^31":
        far = np.array([2**31, 2**31 + 3, 2**32 + 1, 2**40 + 2, -(2**40)], dtype=np.int64)
        for m in (9, 2049, 1 << 17):
            seg = rng.permutation(np.concatenate([rng.integers(0, m, 50_000), far]))
            _onehot_held(torch.from_numpy(seg).to(cuda_device), m)
    else:
        for dtype in (torch.int32, torch.int64):
            for m in (9, 2048, 4097):
                base = torch.from_numpy(rng.integers(-1, m + 1, 100_003)).to(cuda_device, dtype)
                for k in (1, 2, 3):
                    _onehot_held(base[k:], m)
                    _onehot_held(base[k:k + 5], m)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["both routes", "more than 32 inputs", "past own keyspace"])
def test_cuda_onehot_multi_input(cuda_device, case):
    """The multi-input entry against ``fused_bincount_plain``: sets whose
    summed keyspace takes each route, more than 32 inputs on each, ids
    past their own keyspace landing in later sets' bins."""
    rng = np.random.default_rng(22)

    def held(keys_np, spaces):
        keys = [torch.from_numpy(np.asarray(k, dtype=np.int64)).to(cuda_device)
                for k in keys_np]
        before = histogram_device.ONEHOT_LAUNCHES
        got = fused_bincount(keys, spaces, "onehot")
        assert histogram_device.ONEHOT_LAUNCHES == before + 1
        assert torch.equal(got, fused_bincount_plain(keys, spaces))

    if case == "both routes":
        for spaces in ([9, 40, 1000], [9, 5001, 100_000]):
            held([rng.integers(-1, k + 2, 200_000) for k in spaces], spaces)
    elif case == "more than 32 inputs":
        for top in (50, 3000):
            spaces = [int(x) for x in rng.integers(1, top, 40)]
            held([rng.integers(-1, k + 2, int(rng.integers(0, 20_000))) for k in spaces], spaces)
    else:
        held([rng.integers(-1, 2000, 500_000), rng.integers(-1, 42, 500_000)], [9, 40])
        held([rng.integers(-1, 200_000, 500_000), rng.integers(-1, 150_002, 500_000)],
             [9, 150_000])


@pytest.mark.cuda
def test_cuda_suite_same_metrics_under_every_forced_variant(cuda_device, monkeypatch):
    table = port_table(smoke_schema_table(100_000, seed=33))
    suite = deequ_tpu_torch.VerificationSuite.on_data(table, device=cuda_device).add_check(
        _route_check(deequ_tpu_torch))
    want = _metric_bits(suite.run())
    for force in VARIANTS:
        monkeypatch.setenv("DEEQU_TORCH_HIST_VARIANT", force)
        SCAN_STATS.reset()
        before = histogram_device.ONEHOT_LAUNCHES
        assert _metric_bits(suite.run()) == want
        launched = histogram_device.ONEHOT_LAUNCHES - before
        assert SCAN_STATS.hist_onehot_dispatches == launched
        assert (launched > 0) == (force == "onehot")
