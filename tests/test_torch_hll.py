"""The HLL register file of the port (deequ_tpu_torch/ops/hll.py) against
the reference's (deequ_tpu/ops/hll.py), on the CPU, bit for bit.

- registers of f64 values through the port's plain version against the
  reference's two layouts: the default (hi, lo) pair path (the packer's
  numpy split, ``df32.split_pair_np``, then ``idx_rank_pair_device`` and
  the JAX register fold) and the wide f64 path (``idx_rank_numeric`` in
  JAX, as ``DEEQU_TPU_COMPUTE=f64`` runs it), over NaN with and without a
  payload, ±inf, ±0.0, f32-subnormal magnitudes, values past the f32
  range and the integer edges; the int32 pair (``df32.int32_pair``) of
  integral columns; boolean bits; string codes through the packed LUT;
- the reference's golden registers and estimates, and its accuracy and
  merge properties (tests/test_reference_conformance.py,
  tests/test_hll_properties.py), through the port;
- the wrapper's contract: a CPU tensor takes the plain version and
  launches nothing; bad input raises; on a CUDA card the kernel equals
  the plain version (``cuda`` marker, skipped here).

The two reference layouts disagree with each other at -0.0 (XLA folds
the wide path's ``x + 0.0`` away) and at magnitudes whose f32 rounding is
subnormal (XLA on the CPU flushes them); the port matches the default
pair path there (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as ref_analyzers
from deequ_tpu.data.table import ColumnarTable as RefTable
from deequ_tpu.ops import hll as ref_hll
from deequ_tpu.ops.df32 import int32_pair, split_pair_np
from deequ_tpu.parallel.mesh import use_mesh
from deequ_tpu_torch.analyzers import ApproxCountDistinct, ApproxCountDistinctState
from deequ_tpu_torch.ops import hll
from torch_parity import parity_env, port_table, ref_column  # noqa: F401

pytestmark = pytest.mark.torch_port

P = 9

_EDGE_BITS = np.array([
    0x0000000000000000, 0x8000000000000000,  # +0.0, -0.0
    0x7FF8000000000000, 0xFFF8000000000000,  # +NaN, -NaN
    0x7FF4000000000000, 0x7FF0000000000123,  # signalling NaNs, payload high / low
    0xFFFC00000000ABCD, 0x7FFFFFFFFFFFFFFF,  # payloads with the sign, all ones
    0x7FF0000000000000, 0xFFF0000000000000,  # ±inf
    0x47EFFFFFE0000000, 0x47EFFFFFF0000000,  # f32 max, and just past its rounding edge
    0x47F0000000000000, 0xC7F0000000000000,  # ±2^128
    0x7FEFFFFFFFFFFFFF, 0x0000000000000001,  # f64 max, smallest f64 subnormal
], dtype=np.uint64)

_SUBNORMAL_F32 = np.array([
    2.0 ** -149, -(2.0 ** -149), 2.0 ** -140 * 1.25, 1e-40, -1e-39, 2.0 ** -126 * 0.999,
])

_INTEGERS = np.array([
    2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 1, -(2.0 ** 31) + 1, 2.0 ** 53 + 1,
    -(2.0 ** 53) - 1, 2.0 ** 24 + 1, 16777217.0, 0.0, 1.0, -1.0, 12345678.0,
])


def _edge_values(seed=0, normals=5000):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        _EDGE_BITS.view(np.float64), _SUBNORMAL_F32, _INTEGERS,
        rng.normal(size=normals) * 1e3, rng.normal(size=normals),
        1e6 + rng.standard_normal(normals), np.float64(2.0 ** 53) + rng.integers(0, 9, 64),
    ])


def _ref_registers(idx, rank, valid):
    return np.asarray(ref_hll.registers_from_idx_rank(
        jnp.asarray(idx), jnp.asarray(rank), jnp.asarray(valid), P, jnp
    )).astype(np.int32)


def _port_registers(x, valid=None, lut=None):
    v = None if valid is None else torch.from_numpy(valid)
    return hll.registers(torch.from_numpy(x), v, P,
                         None if lut is None else torch.from_numpy(lut)).numpy()


def _ref_pair(x):
    hi, lo = split_pair_np(x)
    return ref_hll.idx_rank_pair_device(jnp.asarray(hi), jnp.asarray(lo), P, jnp)


def _ref_wide(x):
    return ref_hll.idx_rank_numeric(jnp.asarray(x), P, jnp)


def _wide_disagrees(x):
    """Where the reference's wide path leaves its pair path: -0.0, and
    magnitudes whose f32 hi or lo part is a subnormal (module doc)."""
    with np.errstate(all="ignore"):
        hi, lo = split_pair_np(x)
        sub = lambda a: (a != 0) & (np.abs(a) < np.finfo(np.float32).tiny)
    return (np.signbit(x) & (x == 0)) | sub(hi) | sub(lo)


def test_pair_and_wide_layouts_disagree_only_at_negative_zero_and_subnormals():
    x = _edge_values()
    pair = [np.asarray(a) for a in _ref_pair(x)]
    wide = [np.asarray(a) for a in _ref_wide(x)]
    differ = (pair[0] != wide[0]) | (pair[1] != wide[1])
    assert differ.any()
    assert not (differ & ~_wide_disagrees(x)).any()


@pytest.mark.parametrize("layout", ["pair", "wide"])
def test_idx_rank_matches_reference_layout(layout):
    x = _edge_values()
    idx, rank, _ = hll.idx_rank(torch.from_numpy(x), P)
    ref = _ref_pair(x) if layout == "pair" else _ref_wide(x)
    same = (idx.numpy() == np.asarray(ref[0])) & (rank.numpy() == np.asarray(ref[1]))
    if layout == "pair":
        assert same.all()
    else:
        assert (same | _wide_disagrees(x)).all()


@pytest.mark.parametrize("layout", ["pair", "wide"])
def test_registers_match_reference_with_nulls(layout):
    x = _edge_values(seed=1)
    valid = np.random.default_rng(2).random(len(x)) >= 0.1
    if layout == "wide":
        valid &= ~_wide_disagrees(x)
    idx, rank = _ref_pair(x) if layout == "pair" else _ref_wide(x)
    want = _ref_registers(idx, rank, valid)
    np.testing.assert_array_equal(_port_registers(x, valid), want)
    assert (want > 0).sum() > 400


def test_integral_int32_pair_matches_f64_split():
    """Integral columns within int32 ship as int32 in the reference and split
    on the device (df32.int32_pair); the port hashes the f64 value."""
    v = np.array([2**31 - 1, -(2**31) + 1, -(2**31), 0, 1, -1, 2**24 + 1, 123456789,
                  -987654321, 2**30 + 7], dtype=np.int32)
    hi, lo = int32_pair(jnp.asarray(v), jnp)
    ref = ref_hll.idx_rank_pair_device(hi, lo, P, jnp)
    idx, rank, _ = hll.idx_rank(torch.from_numpy(v.astype(np.float64)), P)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(ref[1]))


def test_bool_registers_match_reference():
    b = np.random.default_rng(3).random(1000) < 0.3
    valid = np.random.default_rng(4).random(1000) >= 0.2
    bits = b.astype(np.uint32)
    idx, rank = ref_hll.idx_rank_u32(jnp.asarray(bits), jnp.zeros_like(jnp.asarray(bits)), P, jnp)
    np.testing.assert_array_equal(
        _port_registers(b, valid), _ref_registers(idx, rank, valid)
    )
    assert hll.estimate_cardinality(_port_registers(b)) == 2.0


def test_string_lut_and_registers_match_reference():
    dictionary = np.array(
        [f"user-{i}" for i in range(300)] + ["", "é", "x" * 40, "日本語テキスト" * 5],
        dtype=object,
    )
    lut = hll.string_idx_rank_lut(dictionary, P)
    np.testing.assert_array_equal(lut, ref_hll.string_idx_rank_lut(dictionary, P))
    codes = np.random.default_rng(5).integers(-1, len(dictionary), 4000).astype(np.int32)
    valid = np.random.default_rng(6).random(4000) >= 0.1
    packed = lut[np.maximum(codes, 0)]
    want = _ref_registers(packed >> 6, packed & 0x3F, valid & (codes >= 0))
    np.testing.assert_array_equal(_port_registers(codes, valid, lut), want)
    np.testing.assert_array_equal(
        _port_registers(codes, None, lut),
        _ref_registers(packed >> 6, packed & 0x3F, codes >= 0),
    )
    assert hll.string_idx_rank_lut(np.array([], dtype=object), P).tolist() == [0]


# -- the reference's goldens and properties, through the port ----------------

_V2_FIXTURE = {
    7: 1, 43: 2, 70: 1, 85: 1, 108: 2, 128: 1, 149: 2, 170: 6, 171: 1,
    181: 1, 185: 1, 203: 4, 236: 1, 239: 2, 244: 2, 263: 3, 318: 2,
    332: 2, 333: 1, 337: 1, 352: 3, 366: 2, 369: 2, 391: 5, 405: 1,
    447: 1, 457: 1, 462: 1, 471: 1, 479: 1, 480: 3, 489: 1,
}


def test_golden_registers_precision_and_estimates():
    assert hll.precision_from_relative_sd() == P
    assert hll.precision_from_relative_sd(0.4) == 4
    assert hll.precision_from_relative_sd(0.01) == 14
    regs = _port_registers(np.arange(1.0, 33.0) * 1.5)
    assert {i: int(r) for i, r in enumerate(regs) if r} == _V2_FIXTURE
    assert hll.estimate_cardinality(regs) == 33.0
    assert hll.estimate_cardinality(np.zeros(512, np.int64)) == 0.0
    assert hll.estimate_cardinality(np.ones(512, np.int64)) == 739.0


def test_xxhash64_vectors():
    assert hll.xxhash64_bytes(b"", 0) == 0xEF46DB3751D8E999
    assert hll.xxhash64_bytes(b"a", 0) == 0xD24EC4F1A98C6E5B
    h = hll.hash_strings(np.array(["a", "b", "y" * 100], dtype=object))
    assert h.tolist() == [ref_hll.xxhash64_bytes(s.encode(), 42) for s in ("a", "b", "y" * 100)]


@pytest.mark.parametrize("true_count", [100, 1_000, 10_000, 100_000])
def test_deviation_bound(true_count):
    x = np.arange(true_count, dtype=np.float64) * 0.7 + 3.0
    est = hll.estimate_cardinality(_port_registers(x))
    assert abs(est - true_count) / true_count <= 0.06


def _state(values, where=None, **cols):
    t = port_table(RefTable([ref_column("x", "fractional", np.asarray(values, float))]
                            + [ref_column(k, "fractional", np.asarray(v, float))
                               for k, v in cols.items()]))
    return ApproxCountDistinct("x", where).compute_state_from(t, "cpu")


@pytest.mark.parametrize("true_count", [10, 1000, 20000])
def test_numeric_cardinality_accuracy(true_count):
    rng = np.random.default_rng(true_count)
    values = np.tile(rng.choice(true_count * 10, true_count, replace=False).astype(float), 3)
    rng.shuffle(values)
    est = _state(values).metric_value()
    assert abs(est - true_count) / true_count < 0.2, (true_count, est)


def test_small_cardinalities_are_nearly_exact():
    for k in (1, 2, 5, 17):
        est = _state([float(i % k) for i in range(1000)]).metric_value()
        assert abs(est - k) <= max(1, 0.05 * k), (k, est)


def test_register_merge_is_union_commutative_idempotent():
    sa = _state([float(i) for i in range(4000)])
    sb = _state([float(i) for i in range(2000, 6000)])
    union = _state([float(i) for i in range(6000)])
    assert sa.sum(sb).registers == union.registers
    assert sa.sum(sb) == sb.sum(sa)
    assert sa.sum(sa) == sa
    assert abs(sa.sum(sb).metric_value() - 6000) / 6000 < 0.15


def test_cross_version_merge_refused_on_both_sides():
    v2 = ApproxCountDistinctState((1, 2, 3))
    assert v2.hash_version == hll.HASH_VERSION == ref_hll.HASH_VERSION == 2
    with pytest.raises(ValueError, match="different suites"):
        v2.sum(ApproxCountDistinctState((1, 2, 3), hash_version=1))
    from deequ_tpu.analyzers.sketches import ApproxCountDistinctState as RefState

    with pytest.raises(ValueError, match="different suites"):
        RefState((1, 2, 3)).sum(RefState((1, 2, 3), hash_version=1))


def test_string_and_numeric_states_carry_their_suites(parity_env):
    """A string column's registers are suite 1, a numeric one's suite 2, in
    both packages; the two refuse to merge."""
    ref = RefTable([
        ref_column("s", "string", codes=np.arange(50, dtype=np.int32) % 50,
                   dictionary=[f"v{i}" for i in range(50)]),
        ref_column("x", "fractional", np.arange(50, dtype=float)),
    ])
    states = {}
    for col in ("s", "x"):
        states[col] = ApproxCountDistinct(col).compute_state_from(port_table(ref), "cpu")
        with use_mesh(None):
            want = ref_analyzers.ApproxCountDistinct(col).compute_state_from(ref)
        assert states[col].registers == want.registers
        assert states[col].hash_version == want.hash_version
    assert (states["s"].hash_version, states["x"].hash_version) == (1, 2)
    with pytest.raises(ValueError, match="different suites"):
        states["s"].sum(states["x"])


# -- the wrapper --------------------------------------------------------------


def test_cpu_route_launches_nothing():
    before = hll.LAUNCHES
    hll.registers(torch.zeros(10, dtype=torch.float64))
    hll.registers(torch.zeros(0, dtype=torch.float64))
    assert hll.LAUNCHES == before
    assert hll.registers(torch.zeros(0, dtype=torch.float64)).tolist() == [0] * 512


@pytest.mark.parametrize(
    "args,error",
    [
        ((torch.zeros((2, 2), dtype=torch.float64),), ValueError),
        ((torch.zeros(3, dtype=torch.float32),), TypeError),
        ((torch.zeros(3, dtype=torch.int32),), ValueError),  # codes without a lut
        ((torch.zeros(3, dtype=torch.float64), torch.ones(2, dtype=torch.bool)), ValueError),
        ((torch.zeros(3, dtype=torch.float64), None, 13), ValueError),
        ((torch.zeros(3, dtype=torch.float64), None, 9, torch.zeros(2, dtype=torch.int32)),
         ValueError),
    ],
    ids=["2d", "float32", "codes-no-lut", "valid-shape", "precision", "stray-lut"],
)
def test_registers_reject_bad_input(args, error):
    with pytest.raises(error):
        hll.registers(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f64", "bool", "lut"])
def test_cuda_kernel_matches_plain(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the HLL kernel has no CPU mode")
    rng = np.random.default_rng(11)
    n = 300_001
    valid = torch.from_numpy(rng.random(n) >= 0.05).cuda()
    lut = None
    if mode == "f64":
        x = torch.from_numpy(np.resize(_edge_values(), n)).cuda()
    elif mode == "bool":
        x = torch.from_numpy(rng.random(n) < 0.5).cuda()
    else:
        lut = torch.from_numpy(hll.string_idx_rank_lut(
            np.array([f"s{i}" for i in range(777)], dtype=object), P)).cuda()
        x = torch.from_numpy(rng.integers(-1, 777, n).astype(np.int32)).cuda()
    before = hll.LAUNCHES
    got = hll.registers(x, valid, P, lut)
    assert hll.LAUNCHES == before + 1
    assert torch.equal(got, hll.registers_plain(x, valid, P, lut))
