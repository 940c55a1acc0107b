"""Python-int oracles for the ring Z/(2^W+1)Z (copied from
mpir_fft_tpu/utils/oracle.py; tests/test_torch_params.py pins the copy).

Python's arbitrary-precision int is the trusted big-int implementation
(the reference trusts GMP/MPIR mpz, mul_fft.c:3677-3760)."""

from __future__ import annotations

import numpy as np

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, int_from_digits


def canon(val: int, W: int) -> int:
    """Map an integer to the library's canonical residue range [-1, 2^W - 1]."""
    p = (1 << W) + 1
    r = val % p
    return -1 if r == (1 << W) else r


def ref_norm(d: np.ndarray, W: int) -> int:
    """Value of mpn_normmod_2expp1 on a redundant digit vector (mul_fft.c:272)."""
    return canon(int_from_digits(d), W)


def ref_mul_2expmod(val: int, s: int, W: int) -> int:
    """(val * 2^s) mod p in canonical range (mul_fft.c:470-488)."""
    return canon(val * pow(2, s % (2 * W), (1 << W) + 1), W)


def ref_div_2expmod(val: int, s: int, W: int) -> int:
    """(val / 2^s) mod p: 2 is invertible, 2^-1 = 2^(2W-1) (mul_fft.c:494-512)."""
    return ref_mul_2expmod(val, (2 * W - s) % (2 * W), W)


def ref_sumdiff(a: int, b: int, W: int) -> tuple[int, int]:
    """(a+b, a-b) mod p (the mpn_sumdiff_n butterfly core)."""
    return canon(a + b, W), canon(a - b, W)


def rand_digits(rng: np.random.Generator, shape, lo=-(1 << 18), hi=1 << 18) -> np.ndarray:
    """Random *redundant* signed digits (the analogue of rand_n's random
    signed carry limb, mul_fft.c:3770-3775)."""
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def rand_canonical(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << DIGIT_BITS, size=shape, dtype=np.int64).astype(np.int32)
