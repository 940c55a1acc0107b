"""ops/limb.py and ops/butterfly.py of the port against the JAX package, on
the same numpy inputs.  normmod / normmod_div are held bit for bit against
both the reference's plain path and its Pallas row kernel (fused_rows, in
interpret mode).  Exact: all arithmetic is integer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import butterfly as jbf
from mpir_fft_tpu.ops import limb as jl
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu.utils.oracle import ref_div_2expmod, ref_mul_2expmod, ref_norm
from mpir_fft_tpu_torch.ops import butterfly as tbf
from mpir_fft_tpu_torch.ops import limb as tl


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def N(x):
    return np.asarray(x)


def _edge_rows(L):
    e = np.zeros((4, L), np.int32)
    e[0] = 0xFFFF               # +1 ripple through every digit -> -1 form
    e[2, 0] = -1                # the -1 form itself
    e[3, -1] = 1 << 16          # carry out of the top digit
    return e


@pytest.mark.parametrize("L", [1, 5, 64])
def test_carry_pass_matches_reference(rng, L):
    x = rng.integers(-(1 << 30), 1 << 30, (6, L)).astype(np.int32)
    assert np.array_equal(N(tl.carry_pass(T(x))), N(jl.carry_pass(jnp.asarray(x))))


@pytest.mark.parametrize("L", [4, 16])
def test_shift_mod_matches_reference(rng, L):
    W = 16 * L
    x = rng.integers(-(1 << 18), 1 << 18, (5, L)).astype(np.int32)
    for s in [0, 1, 15, 16, 17, W - 1, W, W + 3, 2 * W - 1, 5 * W + 7]:
        got = N(tl.shift_mod(T(x), s, W))
        assert np.array_equal(got, N(jl.shift_mod(jnp.asarray(x), s, W))), s
        assert ref_norm(got[0], W) == ref_mul_2expmod(tl.int_from_digits(x[0]), s, W)
    # per-row tensor exponents: the ladder's twiddle path
    s = rng.integers(0, 2 * W, (5, 1)).astype(np.int32)
    got = N(tl.shift_mod(T(x), T(s), W))
    assert np.array_equal(got, N(jl.shift_mod(jnp.asarray(x), jnp.asarray(s), W)))
    for r in range(5):
        assert ref_norm(got[r], W) == ref_mul_2expmod(tl.int_from_digits(x[r]), int(s[r, 0]), W)
    got = N(tl.div_2expmod(T(x), T(s), W))
    for r in range(5):
        assert ref_norm(got[r], W) == ref_div_2expmod(tl.int_from_digits(x[r]), int(s[r, 0]), W)
    assert np.array_equal(N(tl.mul_2expmod(T(x), 9, W)), N(jl.mul_2expmod(jnp.asarray(x), 9, W)))
    assert np.array_equal(N(tl.div_2expmod(T(x), 9, W)), N(jl.div_2expmod(jnp.asarray(x), 9, W)))


def test_exact_carries_match_reference(rng):
    d = rng.integers(-(1 << 16) - 1, 1 << 17, (4, 33)).astype(np.int32)
    tc, to = tl._exact_carries(T(d))
    jc, jo = jl._exact_carries(jnp.asarray(d))
    assert np.array_equal(N(tc), N(jc)) and np.array_equal(N(to), N(jo))
    d = rng.integers(0, (1 << 16) + 3, (4, 33)).astype(np.int32)
    d[1] = 0xFFFF
    assert np.array_equal(N(tl.exact_carries_nonneg(T(d))),
                          N(jl.exact_carries_nonneg(jnp.asarray(d))))


@pytest.mark.parametrize("L", [3, 128])
def test_normmod_matches_reference(rng, L):
    x = np.concatenate([rng.integers(-(1 << 29), 1 << 29, (6, L)).astype(np.int32),
                        _edge_rows(L)])
    got = N(tl.normmod(T(x)))
    assert np.array_equal(got, N(jl.normmod(jnp.asarray(x))))
    if L == 128:   # the reference's Pallas row kernel serves rows >= 128 digits
        with force_pallas(True):
            assert np.array_equal(got, N(jl.normmod(jnp.asarray(x))))
    for r in range(len(x)):
        assert tl.int_from_digits(got[r]) == ref_norm(x[r], 16 * L)


@pytest.mark.parametrize("L,d", [(8, 0), (8, 5), (128, 9), (128, 37)])
def test_normmod_div_matches_reference(rng, L, d):
    W = 16 * L
    x = np.concatenate([rng.integers(-(1 << 19), 1 << 19, (6, L)).astype(np.int32),
                        _edge_rows(L)])
    got = N(tl.normmod_div(T(x), d, W))
    assert np.array_equal(got, N(jl.normmod_div(jnp.asarray(x), d, W)))
    if L == 128:
        with force_pallas(True):
            assert np.array_equal(got, N(jl.normmod_div(jnp.asarray(x), d, W)))
    for r in range(len(x)):
        assert tl.int_from_digits(got[r]) == ref_div_2expmod(tl.int_from_digits(x[r]), d, W)


def test_butterflies_match_reference(rng):
    """The port's butterflies are the reference's carry-free form."""
    L = 16
    W = 16 * L
    a = rng.integers(-(1 << 17), 1 << 17, (6, L)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (6, L)).astype(np.int32)
    e = rng.integers(0, 2 * W, (6, 1)).astype(np.int32)
    for ee in (37, e):
        te, je = (T(ee), jnp.asarray(ee)) if isinstance(ee, np.ndarray) else (ee, ee)
        ts, tt = tbf.butterfly_fwd(T(a), T(b), te, W)
        js, jt = jbf.butterfly_fwd(jnp.asarray(a), jnp.asarray(b), je, W, carry=False)
        assert np.array_equal(N(ts), N(js)) and np.array_equal(N(tt), N(jt))
        ts, tt = tbf.butterfly_inv(T(a), T(b), te, W)
        js, jt = jbf.butterfly_inv(jnp.asarray(a), jnp.asarray(b), je, W, carry=False)
        assert np.array_equal(N(ts), N(js)) and np.array_equal(N(tt), N(jt))
