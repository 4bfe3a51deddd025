"""K1, the fused scan's masked reductions (deequ_tpu_torch/ops/masked_reduce.py)
against the reference's ``deequ_tpu/ops/df32.py``, on the CPU.

- the plain versions against the reference's functions run as the
  reference runs them on the CPU (JAX, x64), in its f64 route
  (``DEEQU_TPU_COMPUTE=f64``: ``lo=None``), on seeded numpy inputs with
  ±inf, NaN, -0.0 and subnormals, an all-masked task, one row, a constant
  column and a large offset, under one, two and three masks: counts and
  min/max exact, sums within 1e-12 relative, moments within 1e-10;
- the same against its default (hi, lo) f32-pair route on finite data:
  min/max within 2^-48 relative (ROADMAP queue 3: the pair path is not
  exact there), the rest as above;
- subnormal extrema against numpy, exactly (XLA on the CPU flushes them
  in the reference);
- a chunk resolved through ``Reduction`` tasks by the scan engine gives,
  bit for bit, the flat vector of the direct helpers;
- ``merge_tags`` against ``df32.merge_tags_f64`` with numpy as ``xp``;
- the wrappers' contract: a CPU tensor runs the plain version and
  launches nothing; a ``meta`` tensor raises (no branch falls back); bad
  tasks raise; the kernel's descriptor table; on a CUDA card the kernel
  against the plain version (``cuda`` marker, skipped here).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deequ_tpu  # noqa: F401  (x64 on, as the reference runs)
from deequ_tpu.ops import df32
from deequ_tpu_torch.ops import masked_reduce as k1
from deequ_tpu_torch.ops import scan_engine
from deequ_tpu_torch.ops.scan_engine import ScanOp, _DeviceFoldPlan

pytestmark = pytest.mark.torch_port

N = 2_000


def _column(kind: str, rng, n: int = N):
    if kind == "normal":
        return rng.normal(3.0, 2.0, n)
    if kind == "edges":
        x = rng.normal(0.0, 1.0, n)
        x[: 8] = [np.inf, -np.inf, np.nan, -0.0, 0.0, 5e-324, -1e-310, 2.5e-308]
        return rng.permutation(x)
    if kind == "constant":
        return np.full(n, 3.7)
    if kind == "offset":
        return 1e9 + rng.standard_normal(n)
    if kind == "integral":
        return rng.integers(-1000, 1000, n).astype(np.float64)
    raise ValueError(kind)


# (column kind, rows, mask mode): "all" masks every row out, "none" keeps
# every row; otherwise random masks
CASES = [
    ("normal", N, "random"),
    ("edges", N, "random"),
    ("constant", N, "random"),
    ("offset", N, "random"),
    ("integral", N, "random"),
    ("normal", 1, "none"),
    ("normal", N, "all"),
    ("normal", N, "none"),
]


def _masks(rng, n: int, mode: str, count: int):
    if mode == "none":
        return [np.ones(n, dtype=bool) for _ in range(count)]
    if mode == "all":
        return [np.ones(n, dtype=bool) for _ in range(count - 1)] + [np.zeros(n, dtype=bool)]
    return [rng.random(n) >= 0.1 for _ in range(count)]


def _same(a: float, b: float) -> bool:
    """Exact, with NaN equal to NaN."""
    return (math.isnan(a) and math.isnan(b)) or a == b


def _close(a: float, b: float, rel: float, scale: float, atol: float = 0.0) -> bool:
    """Within ``rel`` of ``scale`` (at least of ``b``) plus ``atol``."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return _same(a, b)
    return abs(a - b) <= rel * max(scale, abs(b), 1e-300) + atol


def _inputs(case, masks_n: int, seed: int):
    kind, n, mode = case
    rng = np.random.default_rng(seed)
    x = _column(kind, rng, n)
    y = 0.5 * _column("normal", rng, n) + 0.25 * np.where(np.isfinite(x), x, 0.0)
    masks = _masks(rng, n, mode, masks_n)
    ok = np.logical_and.reduce(masks)
    return x, y, masks, ok


def _port(kind, data, masks):
    task = k1.Reduction(kind, [torch.from_numpy(d) for d in data],
                        [torch.from_numpy(m) for m in masks])
    return [float(v) for v in task.plain()]


def _floor(x, ok) -> float:
    """The two-pass m2's rounding floor: n · (eps · max|x|)^2, the square
    of a mean's rounding summed over the rows."""
    v = np.abs(x[ok & np.isfinite(x)])
    return float(ok.sum()) * (1e-15 * (v.max() if v.size else 0.0)) ** 2


def _pair_loss(x, y, ok) -> float:
    """What the f32 pair's ~48 bits cost a centred sum: each value off by
    up to 2^-48 of itself, times the other factor, summed over the rows."""
    xs, ys = x[ok], y[ok]
    dx, dy = np.abs(xs - xs.mean()) if xs.size else xs, np.abs(ys - ys.mean()) if ys.size else ys
    return 2.0 ** -46 * float((np.abs(xs) * dy + np.abs(ys) * dx).sum())


@pytest.mark.parametrize("masks_n", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_plain_against_reference_f64(case, masks_n):
    x, y, masks, ok = _inputs(case, masks_n, seed=masks_n)
    jx, jy, jok = jnp.asarray(x), jnp.asarray(y), jnp.asarray(ok)
    scale = float(np.abs(np.where(ok, x, 0.0)).sum())

    (cnt,) = _port("count", [], masks)
    assert cnt == int(df32.masked_count(jok, jnp)) == ok.sum()
    (s,) = _port("sum", [x], masks)
    assert _close(s, float(df32.masked_sum(jx, None, jok, jnp)), 1e-12, scale)
    for mode in ("min", "max"):
        (e,) = _port(mode, [x], masks)
        want = float(df32.masked_extremum(jx, None, jok, jnp, mode))
        assert _same(e, want), (mode, e, want)

    n_, mean, m2 = _port("moments", [x], masks)
    rc, _, rmean, rm2 = df32.masked_moments(jx, None, jok, jnp)
    assert n_ == int(rc)
    assert _close(mean, float(rmean), 1e-12, scale / max(n_, 1))
    assert _close(m2, float(rm2), 1e-10, 0.0, _floor(x, ok))

    got = _port("comoments", [x, y], masks)
    want = [float(v) for v in df32.masked_comoments(jx, None, jy, None, jok, jnp)]
    assert got[0] == want[0]
    assert _close(got[1], want[1], 1e-12, scale / max(got[0], 1))
    assert _close(got[2], want[2], 1e-12, float(np.abs(np.where(ok, y, 0)).sum()) / max(got[0], 1))
    floor = max(_floor(x, ok), _floor(y, ok))
    assert _close(got[4], want[4], 1e-10, 0.0, floor)
    assert _close(got[5], want[5], 1e-10, 0.0, floor)
    ck_scale = math.sqrt(abs(want[4] * want[5])) if math.isfinite(want[4] * want[5]) else 0.0
    assert _close(got[3], want[3], 1e-10, ck_scale, floor)


PAIR_CASES = [c for c in CASES if c[0] != "edges"]


@pytest.mark.parametrize("masks_n", [1, 3])
@pytest.mark.parametrize("case", PAIR_CASES, ids=["-".join(map(str, c)) for c in PAIR_CASES])
def test_plain_against_reference_pairs(case, masks_n):
    """The reference's default route: (hi, lo) f32 pairs from the packer's
    split. Min/max are off the data value by up to 2^-48 relative there,
    and a centred sum by what the pair's ~48 bits cost (:func:`_pair_loss`)."""
    x, y, masks, ok = _inputs(case, masks_n, seed=10 + masks_n)
    xh, xl = (jnp.asarray(p) for p in df32.split_pair_np(x))
    yh, yl = (jnp.asarray(p) for p in df32.split_pair_np(y))
    jok = jnp.asarray(ok)
    scale = float(np.abs(np.where(ok, x, 0.0)).sum())

    (s,) = _port("sum", [x], masks)
    assert _close(s, float(df32.masked_sum(xh, xl, jok, jnp)), 1e-12, scale)
    for mode in ("min", "max"):
        (e,) = _port(mode, [x], masks)
        want = float(df32.masked_extremum(xh, xl, jok, jnp, mode))
        assert _close(e, want, 2.0 ** -48, 0.0), (mode, e, want)
    n_, mean, m2 = _port("moments", [x], masks)
    rc, _, rmean, rm2 = df32.masked_moments(xh, xl, jok, jnp)
    assert n_ == int(rc)
    assert _close(mean, float(rmean), 1e-12, scale / max(n_, 1))
    assert _close(m2, float(rm2), 1e-10, 0.0, _floor(x, ok) + _pair_loss(x, x, ok))
    got = _port("comoments", [x, y], masks)
    want = [float(v) for v in df32.masked_comoments(xh, xl, yh, yl, jok, jnp)]
    assert got[0] == want[0]
    floor = max(_floor(x, ok), _floor(y, ok))
    assert _close(got[4], want[4], 1e-10, 0.0, floor + _pair_loss(x, x, ok))
    assert _close(got[5], want[5], 1e-10, 0.0, floor + _pair_loss(y, y, ok))
    assert _close(got[3], want[3], 1e-10, math.sqrt(want[4] * want[5]),
                  floor + _pair_loss(x, y, ok))


def test_subnormal_extrema_exact_against_numpy():
    """XLA on the CPU flushes f64 subnormals in the reference's min/max
    (ROADMAP queue 3); the port keeps them, as numpy does."""
    x = np.array([5e-324, 1e-310, -1e-310, 1.0, -2.0, 1e-40, 3e-39, 1e-38])
    ok = np.array([True, True, True, False, False, True, True, True])
    (lo,) = _port("min", [x], [ok])
    (hi,) = _port("max", [x], [ok])
    assert lo == -1e-310 and hi == 1e-38
    (lo,) = _port("min", [x[:2]], [ok[:2]])
    assert lo == 5e-324 and lo == np.min(x[:2])


def test_empty_task_gives_identities():
    x = torch.zeros(0, dtype=torch.float64)
    m = torch.zeros(0, dtype=torch.bool)
    assert [float(v) for v in k1.extremum(x, "min", m).plain()] == [math.inf]
    assert [float(v) for v in k1.extremum(x, "max", m).plain()] == [-math.inf]
    assert [float(v) for v in k1.total(x, m).plain()] == [0.0]
    assert [float(v) for v in k1.moments(x, m).plain()] == [0.0, 0.0, 0.0]


def test_int32_lengths_widen_exactly():
    lengths = torch.tensor([3, 17, 0, 5], dtype=torch.int32)
    ok = torch.tensor([True, True, False, True])
    assert float(k1.extremum(lengths, "min", ok).plain()[0]) == 3.0
    assert float(k1.extremum(lengths, "max", ok).plain()[0]) == 17.0
    assert k1.extremum(lengths, "max", ok).plain()[0].dtype == torch.float64


# -- the engine's resolution -------------------------------------------------


def _chunk(seed: int, n: int = 1000):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(5.0, 3.0, n))
    y = torch.from_numpy(rng.normal(-1.0, 0.5, n))
    x[::50] = float("nan") if seed % 2 else 0.0
    mx = torch.from_numpy(rng.random(n) >= 0.05)
    my = torch.from_numpy(rng.random(n) >= 0.05)
    pred = torch.from_numpy(rng.random(n) >= 0.3)
    lengths = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    return x, y, mx, my, pred, lengths


def _direct_update(x, y, mx, my, pred, lengths, row_valid):
    """The partials as the scan built them before K1 had tasks."""
    P = k1
    ok = row_valid & pred & mx
    cnt, mean, m2 = P.masked_moments(x, ok)
    co = P.masked_comoments(x, y, row_valid & mx & my)
    return [
        {"n": P.masked_count(row_valid)},
        {"matches": P.masked_count(row_valid & mx), "count": P.masked_count(row_valid)},
        {"value": P.masked_extremum(x, ok, "min"), "n": P.masked_count(ok)},
        {"value": P.masked_extremum(x, row_valid & mx, "max"), "n": P.masked_count(row_valid & mx)},
        {"sum": P.masked_sum(x, ok), "n": P.masked_count(ok)},
        {"n": cnt, "avg": mean, "m2": m2},
        dict(zip(("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk"), co)),
        {"value": P.masked_extremum(lengths.to(torch.float32), row_valid & pred, "max")
         .to(torch.float64), "n": P.masked_count(row_valid & pred)},
        {"counts": torch.stack([P.masked_count(row_valid & pred & (lengths % 5 == k))
                                for k in range(5)])},
        {"registers": lengths[:8].clone(), "hash_version": torch.tensor(2, dtype=torch.int32)},
    ]


def _task_update(x, y, mx, my, pred, lengths, row_valid):
    """The same partials as K1 tasks, each mask its own."""
    rows = row_valid & pred
    mom = k1.moments(x, rows, mx)
    co = k1.comoments(x, y, row_valid, mx, my)
    classes = lengths % 5
    return [
        {"n": k1.count(row_valid)},
        {"matches": k1.count(row_valid, mx), "count": k1.count(row_valid)},
        {"value": k1.extremum(x, "min", rows, mx), "n": k1.count(rows, mx)},
        {"value": k1.extremum(x, "max", row_valid, mx), "n": k1.count(row_valid, mx)},
        {"sum": k1.total(x, rows, mx), "n": k1.count(rows, mx)},
        {"n": mom[0], "avg": mom[1], "m2": mom[2]},
        {f: co[i] for i, f in enumerate(("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk"))},
        {"value": k1.extremum(lengths, "max", rows), "n": k1.count(rows)},
        {"counts": [k1.count(rows, classes == k) for k in range(5)]},
        {"registers": lengths[:8].clone(), "hash_version": torch.tensor(2, dtype=torch.int32)},
    ]


_TAGS = [{"n": "sum"}, {"matches": "sum", "count": "sum"}, {"value": "min", "n": "sum"},
         {"value": "max", "n": "sum"}, {"sum": "sum", "n": "sum"},
         {"n": "gather", "avg": "gather", "m2": "gather"},
         {k: "gather" for k in ("n", "x_avg", "y_avg", "ck", "x_mk", "y_mk")},
         {"value": "max", "n": "sum"}, {"counts": "sum"},
         {"registers": "max", "hash_version": "max"}]


def _ops():
    return [ScanOp((), lambda *a: None, tags) for tags in _TAGS]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_through_tasks_is_bit_for_bit_the_direct_helpers(seed):
    x, y, mx, my, pred, lengths = _chunk(seed)
    row_valid = torch.ones(x.numel(), dtype=torch.bool)
    direct = _direct_update(x, y, mx, my, pred, lengths, row_valid)
    tasks = _task_update(x, y, mx, my, pred, lengths, row_valid)
    plan_d = _DeviceFoldPlan(_ops(), direct, 1, "cpu")
    plan_t = _DeviceFoldPlan(_ops(), tasks, 1, "cpu")
    assert plan_d._layout == plan_t._layout
    flat_d = plan_d.flatten(direct, row_valid)
    flat_t = plan_t.flatten(tasks, row_valid)
    assert flat_d.numpy().tobytes() == flat_t.numpy().tobytes()
    # the fetched, folded vector too
    assert plan_d.single(flat_d).numpy().tobytes() == plan_t.single(flat_t).numpy().tobytes()


def test_row_valid_is_dropped_and_masks_dedupe():
    x = torch.arange(6, dtype=torch.float64)
    rv = torch.ones(6, dtype=torch.bool)
    m = torch.tensor([True, False, True, True, False, True])
    task = k1.total(x, rv, m, m)
    assert len(task.masks) == 2
    assert task.without(rv).masks == (m,)
    assert task.without(torch.ones(6, dtype=torch.bool)) is task
    assert float(task.without(rv).plain()[0]) == 0 + 2 + 3 + 5


def test_launches_only_on_a_card():
    before = (k1.LAUNCHES, k1.MERGE_LAUNCHES)
    x, y, mx, my, pred, lengths = _chunk(3)
    row_valid = torch.ones(x.numel(), dtype=torch.bool)
    tasks = _task_update(x, y, mx, my, pred, lengths, row_valid)
    plan = _DeviceFoldPlan(_ops(), tasks, 2, "cpu")
    plan.merge(plan.flatten(tasks, row_valid))
    plan.merge(plan.flatten(tasks, row_valid))
    assert (k1.LAUNCHES, k1.MERGE_LAUNCHES) == before


# -- merge_tags ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_tags_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = 257
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1e300, -1e-300])
    acc = np.where(rng.random(m) < 0.2, rng.choice(specials, m), rng.normal(0, 1e3, m))
    new = np.where(rng.random(m) < 0.2, rng.choice(specials, m), rng.normal(0, 1e3, m))
    tag = rng.integers(0, 3, m)
    is_sum, is_min = tag == 0, tag == 1
    want = df32.merge_tags_f64(is_sum, is_min, acc, new, np)
    got = k1.merge_tags(torch.from_numpy(is_sum), torch.from_numpy(is_min),
                        torch.from_numpy(acc), torch.from_numpy(new))
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    # through a gather of a longer flat vector, as the fold reads it
    flat = np.concatenate([rng.normal(size=5), new, rng.normal(size=3)])
    src = torch.arange(5, 5 + m)
    got = k1.merge_tags(torch.from_numpy(is_sum), torch.from_numpy(is_min),
                        torch.from_numpy(acc), torch.from_numpy(flat), src)
    assert np.array_equal(got.numpy(), want, equal_nan=True)


# -- the wrappers' contract ------------------------------------------------------


def test_reduce_into_raises_on_meta():
    x = torch.zeros(4, dtype=torch.float64, device="meta")
    m = torch.zeros(4, dtype=torch.bool, device="meta")
    flat = torch.empty(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.reduce_into(flat, [k1.total(x, m), k1.count(m)], [(0,), (1,)])


def test_merge_tags_raises_on_meta():
    b = torch.zeros(3, dtype=torch.bool, device="meta")
    v = torch.zeros(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.merge_tags(b, b, v, v)


@pytest.mark.parametrize("build", [
    lambda: k1.Reduction("median", [torch.zeros(3, dtype=torch.float64)]),
    lambda: k1.Reduction("sum", []),
    lambda: k1.total(torch.zeros(3, dtype=torch.float32)),
    lambda: k1.total(torch.zeros(3, dtype=torch.float64), torch.zeros(4, dtype=torch.bool)),
    lambda: k1.count(*[torch.zeros(3, dtype=torch.bool) for _ in range(4)]),
    lambda: k1.count(torch.zeros(3, dtype=torch.int32)),
    lambda: k1.count(),
    lambda: k1.extremum(torch.zeros(3, dtype=torch.float64), "mean"),
], ids=["kind", "no-data", "float32", "length", "four-masks", "int-mask", "no-n", "mode"])
def test_bad_tasks_raise(build):
    with pytest.raises((ValueError, TypeError)):
        build()


def test_reduce_into_checks_offsets():
    x = torch.arange(4, dtype=torch.float64)
    flat = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        k1.reduce_into(flat, [k1.total(x)], [(3,)])
    with pytest.raises(ValueError):
        k1.reduce_into(flat, [k1.moments(x)], [(0, 1)])
    k1.reduce_into(flat, [k1.moments(x)], [(2, -1, 0)])
    assert flat.tolist() == [float(((x - 1.5) ** 2).sum()), 0.0, 4.0]


def test_outputs_of_leaves():
    x = torch.arange(4, dtype=torch.float64)
    mom = k1.moments(x)
    assert k1.outputs_of(x) is None
    r = k1.total(x)
    assert k1.outputs_of(r) == [k1.Output(r, 0)]
    assert k1.outputs_of(mom[2]) == [k1.Output(mom, 2)]
    assert [o.index for o in k1.outputs_of([mom[0], mom[1]])] == [0, 1]
    with pytest.raises(ValueError):
        k1.outputs_of(mom)
    with pytest.raises(IndexError):
        mom[3]
    with pytest.raises(TypeError):
        k1.outputs_of([x])


def test_descriptor_table():
    """The kernel's tables: one 104-byte source record (planes, masks, n,
    data types, planes and masks in use, its combos), one 24-byte combo
    (source, mask bits, plane, flags, outputs) and one 8-byte output
    (offset, field), where csrc/masked_reduce.cu's structs read them."""
    x = torch.arange(10, dtype=torch.float64)
    lengths = torch.arange(10, dtype=torch.int32)
    m1 = torch.ones(10, dtype=torch.bool)
    m2 = torch.zeros(10, dtype=torch.bool)
    m3 = torch.ones(10, dtype=torch.bool)
    tasks = [k1.count(m1, m2), k1.extremum(lengths, "max", m2), k1.moments(x, m1),
             k1.comoments(x, x, m1, m2, m3), k1.count(n=10)]
    assert tasks[-1].device == torch.device("cpu")
    offsets = [(4,), (0,), (1, 2, 3), (5, 6, 7, 8, 9, 10), (11,)]
    b = k1.group(tasks, offsets)
    assert (k1.SOURCE_DTYPE.itemsize, k1.COMBO_DTYPE.itemsize, k1.OUT_DTYPE.itemsize) == \
        (104, 24, 8)
    assert [k1.SOURCE_DTYPE.fields[f][1] for f in k1.SOURCE_DTYPE.names] == \
        [0, 8, 16, 72, 80, 84, 88, 92, 96, 100]
    # the pair (x, x) first, then the int32 lengths; the counts ride on them
    assert len(b.sources) == 2 and b.max_n == 10
    raw = b.sources.view(np.uint8).reshape(2, 104)
    pair, lens = b.sources
    assert int(np.frombuffer(raw[0, 0:8].tobytes(), "<u8")[0]) == x.data_ptr()
    assert int(np.frombuffer(raw[0, 8:16].tobytes(), "<u8")[0]) == x.data_ptr()
    assert int(np.frombuffer(raw[1, 0:8].tobytes(), "<u8")[0]) == lengths.data_ptr()
    assert (pair["nplanes"], pair["nmask"], lens["nplanes"], lens["nmask"]) == (2, 3, 1, 1)
    assert (lens["xtype"], pair["xtype"], pair["ytype"]) == (1, 0, 0)
    masks = {int(p) for p in pair["m"][:3]}
    assert masks == {m1.data_ptr(), m2.data_ptr(), m3.data_ptr()}
    assert int(np.frombuffer(raw[1, 24:72].tobytes(), "<u8").sum()) == 0
    assert list(np.frombuffer(raw[:, 72:80].tobytes(), "<i8")) == [10, 10]
    # combos: the pair's co-moments, x's moments under m1, the counts of
    # {m1, m2} and of no mask; the lengths' max under m2
    rows = [tuple(int(v) for v in c) for c in b.combos]
    assert [r[0] for r in rows] == [0] * int(pair["ncombo"]) + [1] * int(lens["ncombo"])
    assert (pair["combo0"], lens["combo0"]) == (0, pair["ncombo"])
    planes = {r[2] for r in rows if r[0] == 0}
    assert planes == {k1.PLANE_XY, k1.PLANE_X, k1.PLANE_NONE}
    comb = b.combos.view(np.uint8).reshape(-1, 24)
    assert list(np.frombuffer(comb[:, 8:12].tobytes(), "<i4")) == [r[2] for r in rows]
    # the launch's shared memory: the pair's tile (two planes, three masks),
    # more than two tiles of the lengths (one plane, one mask)
    assert k1.stage_bytes(b, 4096) == 2 * (4096 * 8 + 16) + 3 * (4096 + 16)
    assert k1.stage_bytes(b, 64) == 2 * (64 * 8 + 16) + 3 * (64 + 16)
    # one-plane sources alone: two tiles of the largest, within the cap
    singles = k1.group(tasks[1:3], offsets[1:3])
    assert k1.stage_bytes(singles, 4096) == 2 * (4096 * 8 + 16 + 4096 + 16)
    many = k1.group([k1.total(x, *[torch.ones(10, dtype=torch.bool) for _ in range(3)]),
                     k1.total(x, *[torch.ones(10, dtype=torch.bool) for _ in range(3)])],
                    [(0,), (1,)])
    assert k1.stage_bytes(many, 8192) == 8192 * 8 + 16 + 6 * (8192 + 16)
    placed = {int(o["offset"]): k1.FIELDS[int(o["field"])] for o in b.outs}
    assert placed == {0: "max", 1: "n", 2: "mean", 3: "m2", 4: "n", 5: "n", 6: "x_avg",
                      7: "y_avg", 8: "ck", 9: "x_mk", 10: "y_mk", 11: "n"}
    assert list(np.frombuffer(b.outs.view(np.uint8).reshape(-1, 8)[:, 0:4].tobytes(), "<i4")) \
        == list(b.outs["offset"])


# -- the grouping into sources and combos ------------------------------------------


def _combo_of(batch):
    """{offset: (source, combo index, field)} of a grouped batch."""
    where = {}
    for ci, c in enumerate(batch.combos):
        for o in batch.outs[c["out0"]:c["out0"] + c["nout"]]:
            assert int(o["offset"]) not in where, "an offset written twice"
            where[int(o["offset"])] = (int(c["source"]), ci, k1.FIELDS[int(o["field"])])
    return where


def _batches():
    """Batches of the scan's shapes: the engine's chunk, every kind under
    each prefix of three masks over two columns, and a pair sharing its
    planes with one-plane tasks."""
    x, y, mx, my, pred, lengths = _chunk(5)
    row_valid = torch.ones(x.numel(), dtype=torch.bool)
    engine = [t.without(row_valid) for t in _leaf_tasks(
        _task_update(x, y, mx, my, pred, lengths, row_valid))]
    kinds = []
    for j in range(4):
        ms = [mx, my, pred][:j]
        kinds += [k1.count(*ms, n=x.numel()), k1.total(x, *ms), k1.extremum(x, "min", *ms),
                  k1.extremum(lengths, "max", *ms), k1.moments(y, *ms), k1.comoments(x, y, *ms)]
    return {"engine": engine, "kinds": kinds}


def _leaf_tasks(partials):
    seen = {}
    for part in partials:
        for leaf in part.values():
            outs = k1.outputs_of(leaf)
            for task, _ in outs or ():
                seen.setdefault(id(task), task)
    return list(seen.values())


def _offsets(tasks):
    offsets, off = [], 0
    for t in tasks:
        offsets.append(tuple(range(off, off + t.n_outputs)))
        off += t.n_outputs
    return offsets, off


@pytest.mark.parametrize("name", ["engine", "kinds"])
def test_group_places_every_output_once(name):
    tasks = _batches()[name]
    offsets, size = _offsets(tasks)
    # an output left out (-1) is written nowhere
    offsets[0] = (-1,) * len(offsets[0])
    b = k1.group(tasks, offsets)
    where = _combo_of(b)
    assert sorted(where) == sorted(o for offs in offsets for o in offs if o >= 0)
    for t, offs in zip(tasks, offsets):
        for off, field in zip(offs, k1._fields(t)):
            if off >= 0:
                source, ci, got = where[off]
                assert got == k1.FIELDS[field]
                src = b.sources[source]
                combo = b.combos[ci]
                # the combo reads the task's planes and exactly its masks
                masks = {int(src["m"][j]) for j in range(int(src["nmask"]))
                         if int(combo["need"]) >> j & 1}
                assert masks == {m.data_ptr() for m in t.masks}
                planes = [int(src["x"]), int(src["y"])]
                if t.kind == "comoments":
                    assert combo["plane"] == k1.PLANE_XY
                    assert planes == [d.data_ptr() for d in t.data]
                elif t.data:
                    assert planes[int(combo["plane"])] == t.data[0].data_ptr()
    # every source's records are consistent
    assert int(b.sources["ncombo"].sum()) == len(b.combos)
    assert int(b.combos["nout"].sum()) == len(b.outs)
    assert (b.sources["nmask"] <= k1.SOURCE_MASKS).all()
    assert (b.sources["ncombo"] <= k1.SOURCE_COMBOS).all()


def test_group_identical_tasks_share_a_combo():
    x = torch.arange(100, dtype=torch.float64)
    m = torch.arange(100) % 3 > 0
    p = torch.arange(100) % 5 > 0
    tasks = [k1.count(m), k1.total(x, m), k1.count(m), k1.extremum(x, "min", m),
             k1.count(m, p), k1.count(p, m), k1.total(x, m), k1.moments(x, m)]
    offsets, _ = _offsets(tasks)
    b = k1.group(tasks, offsets)
    where = _combo_of(b)
    # every task under m alone rides on one combo; {m, p} twice is one
    under_m = {where[o][1] for o in (0, 1, 2, 3, 6, 7, 8)}
    assert len(under_m) == 1
    assert where[4][1] == where[5][1] != where[0][1]
    # x's source reads m alone, so the count of {m, p} reads its masks alone
    assert len(b.combos) == 2 and list(b.sources["nplanes"]) == [1, 0]
    assert b.combos[where[0][1]]["flags"] == k1.FLAG_MIN | k1.FLAG_CENTRED


def test_group_splits_a_source_past_its_caps():
    n = 64
    x = torch.arange(n, dtype=torch.float64)
    masks = [torch.arange(n) % (k + 2) > 0 for k in range(k1.SOURCE_MASKS + 3)]
    # more masks than a source takes, on one plane: two sources of x
    tasks = [k1.total(x, m) for m in masks]
    b = k1.group(tasks, _offsets(tasks)[0])
    assert len(b.sources) == 2
    assert list(b.sources["nmask"]) == [k1.SOURCE_MASKS, 3]
    assert set(int(v) for v in b.sources["x"]) == {x.data_ptr()}
    # more combos than a source takes: mask pairs over four masks on one plane
    pairs = [(i, j) for i in range(k1.SOURCE_MASKS) for j in range(i + 1, k1.SOURCE_MASKS)]
    tasks = [k1.total(x, masks[i], masks[j]) for i, j in pairs]
    assert len(tasks) > k1.SOURCE_COMBOS
    b = k1.group(tasks, _offsets(tasks)[0])
    assert list(b.sources["ncombo"]) == [k1.SOURCE_COMBOS, len(tasks) - k1.SOURCE_COMBOS]
    assert (b.sources["nmask"] <= k1.SOURCE_MASKS).all()
    # counts of many masks: sources of masks alone, each within its caps
    tasks = [k1.count(m) for m in masks] + [k1.count(masks[0], masks[-1])]
    b = k1.group(tasks, _offsets(tasks)[0])
    assert (b.sources["nplanes"] == 0).all() and len(b.sources) == 2
    assert (b.sources["nmask"] <= k1.SOURCE_MASKS).all()
    assert len(_combo_of(b)) == len(tasks)


@pytest.mark.parametrize("name", ["engine", "kinds"])
def test_group_reversed_batch_same_sources(name):
    tasks = _batches()[name]
    offsets, _ = _offsets(tasks)
    a = k1.group(tasks, offsets)
    b = k1.group(tasks[::-1], offsets[::-1])

    def shape(batch):
        out = set()
        for s in batch.sources:
            combos = batch.combos[s["combo0"]:s["combo0"] + s["ncombo"]]
            out.add((int(s["x"]), int(s["y"]), frozenset(int(m) for m in s["m"]),
                     int(s["n"]), frozenset(
                         (int(c["plane"]), int(c["flags"]),
                          frozenset(int(s["m"][j]) for j in range(7) if int(c["need"]) >> j & 1),
                          frozenset((int(o["offset"]), int(o["field"]))
                                    for o in batch.outs[c["out0"]:c["out0"] + c["nout"]]))
                         for c in combos)))
        return out

    assert shape(a) == shape(b)
    assert k1.stage_bytes(a, 4096) == k1.stage_bytes(b, 4096) and a.max_n == b.max_n


# -- a numpy model of the kernel's arithmetic -------------------------------------


#: rows a tile of the model (the kernel's tiles are larger; small tiles
#: give the model's merge many tiles at small sizes)
MODEL_TILE = 256


def _model(batch, arrays, size: int, tile: int = MODEL_TILE) -> np.ndarray:
    """What csrc/masked_reduce.cu computes, in numpy (a test helper, not a
    path): per combo, per tile of ``tile`` rows, the count, sums,
    extrema and the deviations from the tile's centre (its mean), S1 and
    S2 (and the pair's cross sum); the fold takes the mean from the summed
    sums and moves each tile's centred sums to it: S2 + e * (2 S1 + n e)."""
    flat = np.full(size, np.nan)
    for c in batch.combos:
        src = batch.sources[c["source"]]
        n = int(src["n"])
        planes = [arrays[int(src[p])].astype(np.float64) if int(src["nplanes"]) > i else None
                  for i, p in enumerate(("x", "y"))]
        ok = np.ones(n, dtype=bool)
        for j in range(int(src["nmask"])):
            if int(c["need"]) >> j & 1:
                ok &= arrays[int(src["m"][j])]
        plane = int(c["plane"])
        xs = planes[1] if plane == k1.PLANE_Y else planes[0]
        ys = planes[1]
        parts = []
        for lo in range(0, max(n, 1), tile):
            sl = slice(lo, min(lo + tile, n))
            keep = ok[sl]
            cnt = int(keep.sum())
            part = {"cnt": cnt}
            if plane != k1.PLANE_NONE:
                xv = np.where(keep, xs[sl], 0.0)
                part["s"] = float(xv.sum())
                part["lo"] = float(np.where(keep, xs[sl], np.inf).min()) if n else np.inf
                part["hi"] = float(np.where(keep, xs[sl], -np.inf).max()) if n else -np.inf
                cx = part["s"] / max(cnt, 1)
                dx = np.where(keep, xs[sl] - cx, 0.0)
                part["a"], part["xx"] = float(dx.sum()), float((dx * dx).sum())
                if plane == k1.PLANE_XY:
                    part["t"] = float(np.where(keep, ys[sl], 0.0).sum())
                    cy = part["t"] / max(cnt, 1)
                    dy = np.where(keep, ys[sl] - cy, 0.0)
                    part["b"], part["yy"] = float(dy.sum()), float((dy * dy).sum())
                    part["xy"] = float((dx * dy).sum())
            parts.append(part)
        cnt = sum(p["cnt"] for p in parts)
        vals = {"n": float(cnt)}
        if plane != k1.PLANE_NONE:
            s = math.fsum(p["s"] for p in parts)
            mean = s / max(cnt, 1)
            vals.update(sum=s, min=min(p["lo"] for p in parts), max=max(p["hi"] for p in parts),
                        mean=mean, x_avg=mean)
            mean_y = 0.0
            if plane == k1.PLANE_XY:
                mean_y = math.fsum(p["t"] for p in parts) / max(cnt, 1)
                vals["y_avg"] = mean_y
            xx = yy = xy = 0.0
            for p in parts:
                if not p["cnt"]:
                    continue
                ex = p["s"] / p["cnt"] - mean
                xx += p["xx"] + ex * (2.0 * p["a"] + p["cnt"] * ex)
                if plane == k1.PLANE_XY:
                    ey = p["t"] / p["cnt"] - mean_y
                    yy += p["yy"] + ey * (2.0 * p["b"] + p["cnt"] * ey)
                    xy += p["xy"] + ex * p["b"] + ey * p["a"] + p["cnt"] * ex * ey
            vals.update(m2=xx, x_mk=xx, y_mk=yy, ck=xy)
        for o in batch.outs[c["out0"]:c["out0"] + c["nout"]]:
            flat[int(o["offset"])] = vals[k1.FIELDS[int(o["field"])]]
    return flat


#: the centred sums' rounding floor of chip_smoke.py's k1_hold: the two
#: versions' means round up to 128 ulps of the largest |x| apart
MEAN_ULPS = 128 * 2.0 ** -52


def _hold(tasks, offsets, flat) -> None:
    """Each output against the plain version, under k1_hold's tolerances."""
    for t, offs in zip(tasks, offsets):
        want = [float(v) for v in t.plain()]
        ok = np.ones(t.n, dtype=bool)
        for m in t.masks:
            ok &= m.numpy()
        data = [d.numpy().astype(np.float64) for d in t.data]
        sums = [float(np.abs(np.where(ok, d, 0.0)).sum()) for d in data]
        big = max([float(np.abs(d[ok & np.isfinite(d)]).max(initial=0.0)) for d in data],
                  default=0.0)
        n = max(float(ok.sum()), 1.0)
        floor = n * (MEAN_ULPS * big) ** 2
        for name, off, w in zip(k1.OUTPUTS[t.kind], offs, want):
            h = float(flat[off])
            if name in ("n", "value") or not (math.isfinite(h) and math.isfinite(w)):
                assert _same(h, w), (t.kind, name, h, w)
            elif name in ("sum", "mean", "x_avg", "y_avg"):
                sx = sums[1 if name == "y_avg" else 0]
                assert abs(h - w) <= 1e-13 * sx / (1.0 if name == "sum" else n), (t.kind, name, h, w)
            elif name == "ck":
                assert abs(h - w) <= 1e-12 * math.sqrt(abs(want[4] * want[5])) + floor, (h, w)
            else:
                assert abs(h - w) <= 1e-12 * abs(w) + floor, (t.kind, name, h, w)


def _model_hold(tasks):
    offsets, size = _offsets(tasks)
    arrays = {}
    for t in tasks:
        for d in t.data + t.masks:
            arrays[d.data_ptr()] = d.numpy()
    batch = k1.group(tasks, offsets)
    _hold(tasks, offsets, _model(batch, arrays, size))


def _kinds_over(x, y, masks):
    tasks = []
    for j in range(len(masks) + 1):
        ms = masks[:j]
        tasks += [k1.count(*ms, n=x.numel()), k1.total(x, *ms), k1.extremum(x, "min", *ms),
                  k1.extremum(x, "max", *ms), k1.moments(x, *ms), k1.moments(y, *ms),
                  k1.comoments(x, y, *ms)]
    return tasks


#: (kind, rows): mean 1e8 and sd 1e-3; a constant; ordinary; tile edges
MODEL_CASES = [("ill", 48 * MODEL_TILE + 77), ("constant", 16 * MODEL_TILE),
               ("normal", MODEL_TILE - 1), ("normal", MODEL_TILE + 1), ("ill", 1), ("normal", 0)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[f"{k}-{n}" for k, n in MODEL_CASES])
def test_model_moments_against_two_pass(case):
    kind, n = case
    rng = np.random.default_rng(n)
    if kind == "ill":
        x = 1e8 + 1e-3 * rng.standard_normal(n)
        y = -3e7 + 1e-3 * rng.standard_normal(n) + 0.5 * (x - 1e8)
    elif kind == "constant":
        x, y = np.full(n, 3.7), np.full(n, -1e8)
    else:
        x, y = rng.normal(5.0, 2.0, n), rng.normal(-1.0, 1.0, n)
    masks = [torch.from_numpy(rng.random(n) >= p) for p in (0.1, 0.3)]
    _model_hold(_kinds_over(torch.from_numpy(x), torch.from_numpy(y), masks))


@pytest.mark.parametrize("seed", [0, 1])
def test_model_engine_chunk_against_plain(seed):
    """The engine's chunk through the grouping and the model: every field
    lands where the plain version puts it."""
    x, y, mx, my, pred, lengths = _chunk(seed, n=3 * 4096 + 5)
    row_valid = torch.ones(x.numel(), dtype=torch.bool)
    tasks = [t.without(row_valid) for t in _leaf_tasks(
        _task_update(x, y, mx, my, pred, lengths, row_valid))]
    _model_hold(tasks)


def test_engine_scan_on_cpu_counts_no_launch():
    """A whole scan on the CPU resolves its tasks by the plain versions."""
    from deequ_tpu_torch.analyzers import Correlation, MaxLength, StandardDeviation
    from deequ_tpu_torch.data.table import Column, ColumnarTable, DType

    rng = np.random.default_rng(4)
    table = ColumnarTable([
        Column("a", DType.FRACTIONAL, values=rng.normal(size=500), mask=rng.random(500) > 0.1),
        Column("b", DType.FRACTIONAL, values=rng.normal(size=500)),
        Column("s", DType.STRING, codes=rng.integers(-1, 3, 500).astype(np.int32),
               dictionary=np.array(["x", "yy", "zzz"], dtype=object)),
    ])
    before = k1.LAUNCHES
    ops = [StandardDeviation("a").scan_op(table), Correlation("a", "b").scan_op(table),
           MaxLength("s").scan_op(table)]
    res = scan_engine.run_scan(table, ops, "cpu", chunk_rows=128)
    assert k1.LAUNCHES == before
    a = table["a"].values[table["a"].mask]
    assert int(res[0]["n"].sum()) == a.size and res[2]["value"] == 3.0


# -- on a card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is CUDA C++ with no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    n = 70_001
    x = torch.from_numpy(_column("edges", rng, n)).to(dev)
    y = torch.from_numpy(rng.normal(size=n)).to(dev)
    masks = [torch.from_numpy(rng.random(n) >= 0.1).to(dev) for _ in range(3)]
    lengths = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)).to(dev)
    tasks = [k1.count(*masks), k1.total(y, masks[0]), k1.extremum(x, "min", masks[1]),
             k1.extremum(lengths, "max", *masks[:2]), k1.moments(y, masks[2]),
             k1.comoments(y, 2.0 * y + 1.0, masks[0], masks[1])]
    offsets, off = [], 0
    for t in tasks:
        offsets.append(tuple(range(off, off + t.n_outputs)))
        off += t.n_outputs
    flat = torch.full((off,), float("nan"), dtype=torch.float64, device=dev)
    before = k1.LAUNCHES
    k1.reduce_into(flat, tasks, offsets)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    want = torch.cat([torch.stack([v.to(torch.float64) for v in t.plain()]) for t in tasks])
    got, want = flat.cpu().numpy(), want.cpu().numpy()
    for i in (0, 2, 3, 4, 7):
        assert _same(float(got[i]), float(want[i]))
    for i in (1, 5, 6, 8, 9, 10, 11, 12, 13):
        assert _close(float(got[i]), float(want[i]), 1e-12, abs(float(want[i])))
