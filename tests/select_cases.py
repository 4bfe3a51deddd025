"""The adversarial columns of K4's parity checks, shared by
``tests/test_torch_select.py`` (K4's plain version against K3 on the CPU)
and ``chip_smoke.py``'s ``select_parity`` (the kernel against its plain
version and K3 on the card). numpy only: no JAX, no package import."""

import numpy as np


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.int64).view(np.float64)


def adversarial_cases(seed: int = 2024, n: int = 2000):
    """(rng, nan_bits, {name: (values, mask or None)}): ±0.0, NaN
    payloads, ±inf, all-null, one valid row, one row, ties at every digit
    boundary, subnormals, past 2^53, all equal, normals. ``rng`` is left
    where the columns leave it."""
    rng = np.random.default_rng(seed)
    nan_bits = rng.integers(0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF, n, dtype=np.int64)
    digit = 0x3FF0000000000000 + np.arange(n, dtype=np.int64) % 7 * (1 << 40)
    cases = {
        # -0.0 against +0.0 in every proportion, with some 1.0s between
        "signed_zeros": (rng.choice([-0.0, 0.0, 0.0, -1.0, 1.0], n), None),
        # NaN payloads of both signs, valid, beside normals and nulls
        "nan_payloads": (
            np.where(rng.random(n) < 0.3,
                     np.copysign(_from_bits(nan_bits), rng.choice([1.0, -1.0], n)),
                     rng.normal(0, 1, n)),
            rng.random(n) > 0.2,
        ),
        "infinities": (
            np.where(rng.random(n) < 0.1, rng.choice([np.inf, -np.inf], n),
                     rng.normal(0, 1, n)),
            rng.random(n) > 0.3,
        ),
        "all_null": (rng.normal(0, 1, 300), np.zeros(300, dtype=bool)),
        "one_valid_row": (rng.normal(0, 1, 300), np.arange(300) == 123),
        "single_row": (np.array([42.0]), None),
        # ties straddling each digit boundary: values that differ in one byte
        # of the key (and so meet only in later passes), heavily repeated
        "digit_boundaries": (
            _from_bits(digit + rng.integers(0, 3, n) * (1 << 8)
                       + rng.integers(0, 2, n) * (1 << 48)), None,
        ),
        "subnormals": (rng.choice([5e-324, -5e-324, 1e-310, -1e-310, 0.0, -0.0], n), None),
        "past_2_53": (
            (2.0 ** 53 + rng.integers(0, 64, n)) * rng.choice([1.0, -1.0], n), None,
        ),
        "all_equal": (np.full(n, 3.25), None),
        "normals": (rng.normal(100, 10, n), rng.random(n) > 0.05),
    }
    return rng, nan_bits, cases
