"""Multiplication mod p = 2^N + 1 with algorithm choice (counterpart of
mpir_fft_tpu/ops/mulmod.py:220-240; ref fft_mulmod_2expp1,
mul_fft.c:3125-3167).  Only the base branch is ported: rings the schoolbook
serves go to mulmod_base; rings that need the recursive negacyclic FFT
raise NotImplementedError."""

from __future__ import annotations

import torch

from .limb import DIGIT_BITS
from .pointwise import base_serves, mulmod_base

# crossover in ring bits below which the direct base multiply beats a
# recursion level (the reference package's value; its role matches the
# reference's limbs < 250 delegation, mul_fft.c:3135-3139)
MULMOD_BASE_MAX_BITS = 131072


def mulmod(x: torch.Tensor, y: torch.Tensor, N: int, canonical: bool = False) -> torch.Tensor:
    """(x * y) mod 2^N+1, batched over leading dims of [..., N/16] digit
    vectors.  Inputs may be redundant (|digit| <= ~2^17) or canonical; with
    canonical=False the result is bounded redundant digits."""
    L = N // DIGIT_BITS
    assert x.shape[-1] == y.shape[-1] == L
    if N > MULMOD_BASE_MAX_BITS or not base_serves(L):
        raise NotImplementedError(
            f"N={N} (L={L}) needs the recursive Fermat mulmod (mulmod_fft), "
            "which is not ported yet")
    return mulmod_base(x, y, canonical=canonical)
