"""The normmod rows (ops/limb.py normmod / normmod_div) of the port against
the JAX package's, on the same numpy inputs, at the widths the main path
gives them, and the host predicate that routes each width to its kernel
(ops/fused.py normmod_route).

The inner rings of the recursive pointwise (L 32, 48, 64, 72) are held
against the reference's plain path, the outer rings (L 3072, 5120) against
its Pallas row kernel (fused_rows) in interpret mode, the long rows (L 8193
to 2^18: the mulmod_int rings' final normmod, the chained-scan route)
against its plain path, the one mulmod_int takes, and a Python-int oracle.  Exact: all arithmetic is
integer.  On the CPU the port runs its plain version; the kernels behind the
routes are held against it on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import limb as jl
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu_torch.ops import fused as tf
from mpir_fft_tpu_torch.ops import limb as tl
from mpir_fft_tpu_torch.ops.mulmod import inner_plan, mulmod_plan
from mpir_fft_tpu_torch.utils.params import choose_params


def _rows(rng, n, L, bound):
    """n random rows and the ripple edge rows (limb tests' _edge_rows)."""
    e = np.zeros((4, L), np.int32)
    e[0] = 0xFFFF               # +1 ripple through every digit -> -1 form
    e[2, 0] = -1                # the -1 form itself
    e[3, -1] = 1 << 16          # carry out of the top digit
    return np.concatenate([rng.integers(-bound, bound, (n, L)).astype(np.int32), e])


def _check(x, d, L, pallas):
    W = 16 * L
    got = tl.normmod(torch.from_numpy(x)) if d is None else \
        tl.normmod_div(torch.from_numpy(x), d, W)
    with force_pallas(pallas):
        want = jl.normmod(jnp.asarray(x)) if d is None else jl.normmod_div(jnp.asarray(x), d, W)
    assert np.array_equal(np.asarray(got), np.asarray(want)), (L, d)


@pytest.mark.parametrize("L", [32, 48, 64, 72])
@pytest.mark.parametrize("d", [None, 7, 8, 16 * 64 + 3])
def test_normmod_short_rows_match_reference(rng, L, d):
    """The inner rings' normmod_div by 2^(depth+1) (d 7, 8), a d past W,
    and plain normmod (d None), against the reference's plain path."""
    _check(_rows(rng, 12, L, 1 << 29), d, L, False)


@pytest.mark.parametrize("L", [3072, 5120])
@pytest.mark.parametrize("d", [None, 16])
def test_normmod_block_rows_match_reference_kernel(rng, L, d):
    """The outer rings' normmod and the norm tail's normmod_div by
    2^lg_conv, against the reference's row kernel in interpret mode."""
    _check(_rows(rng, 3, L, 1 << 29), d, L, True)


def _plan_widths():
    """Every normmod width of the planner's plans over 10^5..4x10^9 bits
    (balanced and 3:1 products, with and without sqrt2): the outer L (the
    norm tail, the recursive pointwise's folded outer ring) and each inner
    Lp of the recursion (its normmod_div)."""
    widths = set()
    bits = 100_000
    while bits <= 4_000_000_000:
        for bits_b in (bits, bits // 3):
            for sqrt2 in (True, None):
                plan = choose_params(bits, bits_b, sqrt2=sqrt2)
                widths.add(plan.W // 16)
                N = plan.W
                while (ip := inner_plan(N)) is not None:
                    widths.add(ip.Lp)
                    N = ip.Wp
        bits = bits * 21 // 20 + 1
    return widths


@pytest.mark.parametrize("ntt", [None, "0"])
def test_plan_widths_take_short_or_block_rows(monkeypatch, ntt):
    """No plan's normmod takes the streamed long-row kernel (only the
    mulmod_int rings do); the main path's widths take the routes the
    kernels were shaped for."""
    if ntt is None:
        monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    else:
        monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    widths = _plan_widths()
    assert {48, 64, 5120 if ntt is None else 3072} <= widths
    for L in widths:
        assert tf.normmod_route(L) in ("short", "block"), L
    for L in (32, 48, 64, 72, 512):
        assert tf.normmod_route(L) == "short"
    for L in (513, 3072, 4096, 5120, 6144, 8192):
        assert tf.normmod_route(L) == "block"
    assert tf.normmod_route(8193) == tf.normmod_route(1 << 18) == "long"


def _long_rows(rng, L):
    """_rows' edge rows and a random row, then a +1 ripple that stops after
    5000 digits: leading 0xFFFF and a top digit of -1 (carry out -1)."""
    ripple = rng.integers(0, 1 << 16, (1, L)).astype(np.int32)
    ripple[0, :5000] = 0xFFFF
    ripple[0, 5000] = 5
    ripple[0, -1] = -1
    return np.concatenate([_rows(rng, 1, L, 1 << 29), ripple])


def _oracle(row, d, L):
    """Canonical digits of normmod_div(row, d) (normmod where d is None) by
    Python ints: value * 2^-d mod 2^W+1, the residue 2^W as [-1, 0, ...]."""
    W = 16 * L
    p = (1 << W) + 1
    v = sum(int(c) << (16 * i) for i, c in enumerate(row.tolist())) % p
    v = v * pow(2, 2 * W - (d or 0), p) % p
    if v == 1 << W:
        out = np.zeros(L, np.int32)
        out[0] = -1
        return out
    return np.frombuffer(v.to_bytes(2 * L, "little"), dtype="<u2").astype(np.int32)


@pytest.mark.parametrize("L", [8193, 20000, 1 << 18])
@pytest.mark.parametrize("layout", ["ring", "rows"])
@pytest.mark.parametrize("d", [None, 16, "past W"])
def test_normmod_long_rows_match_reference(rng, L, layout, d):
    """Rows over NORMMOD_ROW_MAX digits (the long route): each row as a 1-D
    ring (mulmod_int's final normmod) or in (3, L) batches, d None, 16 and
    W + 7, against the reference's plain path, the one its mulmod_int
    takes; at L 20000 also against Python ints."""
    assert tf.normmod_route(L) == "long"
    if d == "past W":
        d = 16 * L + 7
    x = _long_rows(rng, L)
    if layout == "ring":
        for row in x:
            _check(row, d, L, False)
    else:
        for k in range(0, len(x), 3):
            _check(x[k:k + 3], d, L, False)
    if L == 20000 and layout == "ring":
        for row in x:
            got = tl.normmod(torch.from_numpy(row)) if d is None else \
                tl.normmod_div(torch.from_numpy(row), d, 16 * L)
            assert np.array_equal(got.numpy(), _oracle(row, d, L)), d


@pytest.mark.parametrize("lg", [22, 24, 29])
def test_mulmod_int_rings_take_the_long_route(lg):
    """mulmod_int's ring of N = 2^lg bits (LN = N/16 digits) takes the long
    route; every inner ring of its recursion (each Lp) short or block rows."""
    N = 1 << lg
    assert tf.normmod_route(N // 16) == "long"
    plan, widths = mulmod_plan(N), []
    while plan is not None:
        widths.append(plan.Lp)
        plan = inner_plan(plan.Wp)
    assert widths
    for Lp in widths:
        assert tf.normmod_route(Lp) in ("short", "block"), (N, Lp)
