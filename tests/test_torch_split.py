"""Split/combine of the port (ops/split.py) and the exact carry
(canonicalize_plain, the plain version of csrc/canonicalize.cu) against
the JAX package -- including its Pallas two-level carry scan
(fused_canonicalize_plain, interpret mode) -- and Python ints.  Every
branch of the reference is exercised: digit-aligned strides, the
residue-class path and the gather path.  Exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import split as jsplit
from mpir_fft_tpu.ops.fused import fused_canonicalize_plain as j_fused_canon
from mpir_fft_tpu_torch.ops import split as tsplit
from mpir_fft_tpu_torch.ops.limb import digits_from_int, int_from_digits

# (bits, L): aligned; residue classes (S >= Lw + 1); gather (S < Lw + 1).  The
# combine serves bits >= ~W/4 (the drivers have bits ~ W/2), as in the reference
SPLIT_CASES = [(96, 16), (1005, 126), (20, 4), (8, 2)]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _branch(bits):
    P, S = tsplit._offset_classes(bits)
    if bits % 16 == 0:
        return "aligned"
    return "classes" if S >= -(-bits // 16) + 1 else "gather"


def test_cases_cover_every_branch():
    assert {_branch(b) for b, _ in SPLIT_CASES} == {"aligned", "classes", "gather"}
    combine = {("aligned" if b % 16 == 0 else
                "classes" if tsplit._offset_classes(b)[1] >= 2 else "gather")
               for b, _ in SPLIT_CASES}
    assert combine == {"aligned", "classes", "gather"}


@pytest.mark.parametrize("bits,L", SPLIT_CASES)
def test_split_matches_reference(rng, bits, L):
    nbits = 40 * bits - 7
    x = int.from_bytes(rng.bytes(-(-nbits // 8)), "little") >> (8 * -(-nbits // 8) - nbits)
    Lx = -(-nbits // 16)
    d = np.stack([digits_from_int(x, Lx), digits_from_int(x >> 5, Lx)])
    C = 48
    got = tsplit.fft_split_bits(T(d), bits, C, L).numpy()
    assert np.array_equal(got, np.asarray(jsplit.fft_split_bits(jnp.asarray(d), bits, C, L)))
    mask = (1 << bits) - 1
    for j in range(C):
        assert int_from_digits(got[0, j]) == (x >> (j * bits)) & mask


@pytest.mark.parametrize("bits,L", SPLIT_CASES)
def test_combine_matches_reference(rng, bits, L):
    C = 40
    W = 16 * L
    c = rng.integers(0, 1 << 16, (2, C, L)).astype(np.int32)
    c[1, :, :] = 0xFFFF                    # all-ones coefficients: longest carries
    vals = [[int_from_digits(c[b, j]) for j in range(C)] for b in range(2)]
    Lout = -(-((C - 1) * bits + W + 8) // 16) + 2
    got = tsplit.fft_combine_bits(T(c), bits, Lout).numpy()
    assert np.array_equal(got, np.asarray(jsplit.fft_combine_bits(jnp.asarray(c), bits, Lout)))
    for b in range(2):
        assert int_from_digits(got[b]) == sum(v << (j * bits) for j, v in enumerate(vals[b]))


def _canon_rows(rng, Bt, N, fill):
    """(Bt, N) digits in [0, 2^20) whose values fit their rows: random,
    random with a ripple from digit 0 through row 1 ("mixed": it must stop
    at row 2), every row that ripple, or every digit 2^20 - 1 ("max")."""
    if fill == "max":
        x = np.full((Bt, N), (1 << 20) - 1, dtype=np.int32)
    else:
        x = rng.integers(0, 1 << 20, (Bt, N)).astype(np.int32)
    ripple = {"mixed": [1], "ripple": list(range(Bt))}.get(fill, [])
    x[ripple] = 0xFFFF
    x[ripple, 0] = 0x1FFFF
    x[:, -2:] = 0
    return x


# the main path's row widths: the recursive pointwise's combine at 1.2 / 1.5
# x 10^9 bits (LN + K = 5120 + 49, 6144 + 65), several rows a launch
@pytest.mark.parametrize("Bt,N,fill", [
    (3, 9000, "mixed"), (4, 5169, "random"), (4, 5169, "ripple"), (4, 6209, "random"),
    (4, 6209, "ripple"), (3, 6209, "max")])
def test_canonicalize_matches_reference(rng, Bt, N, fill):
    x = _canon_rows(rng, Bt, N, fill)
    got = tsplit.canonicalize_plain(T(x)).numpy()
    assert np.array_equal(got, np.asarray(jsplit.canonicalize_plain(jnp.asarray(x))))
    assert np.array_equal(got, np.asarray(j_fused_canon(jnp.asarray(x))))
    assert np.array_equal(got[0], np.asarray(j_fused_canon(jnp.asarray(x[0]))))
    assert ((got >= 0) & (got < 1 << 16)).all()
    for b in range(Bt):      # value = sum x_i 2^(16 i): low and high halves as 16-bit digits
        lo, hi = (int.from_bytes(h.astype("<u2").tobytes(), "little")
                  for h in (x[b] & 0xFFFF, x[b] >> 16))
        assert int_from_digits(got[b]) == lo + (hi << 16)
