"""Pointwise leaf of the port (ops/pointwise.py, ops/pointwise_fused.py,
ops/mulmod.py) against the JAX package under MPIR_FFT_NTT=0 -- the
schoolbook leaf; the NTT leaf is held in tests/test_torch_ntt.py -- and
Python-int oracles.

The conv's plain version is held against the reference's Pallas schoolbook
kernel (mulmod_base_fused, interpret mode) after normmod, at the inner
rings' widths among others, and against Python-int oracles at the extreme
digit magnitudes.  A pin lists the widths the planner's plans send to the
schoolbook.  Exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import pointwise as jpw
from mpir_fft_tpu.ops.limb import normmod as jnormmod
from mpir_fft_tpu.ops.pointwise_fused import mulmod_base_fused as j_mulmod_base_fused
from mpir_fft_tpu_torch.ops import pointwise as tpw
from mpir_fft_tpu_torch.ops.limb import int_from_digits, normmod
from mpir_fft_tpu_torch.ops.mulmod import MULMOD_BASE_MAX_BITS, inner_plan, mulmod
from mpir_fft_tpu_torch.ops.ntt import ntt_supported
from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused
from mpir_fft_tpu_torch.utils.params import choose_params


@pytest.fixture
def ntt_off(monkeypatch):
    monkeypatch.setenv("MPIR_FFT_NTT", "0")


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _rand(rng, shape, bound=1 << 17):
    return rng.integers(-bound, bound, shape).astype(np.int32)


def test_chunk_helpers_match_reference(rng):
    x = _rand(rng, (5, 24))
    x[0, :] = 0
    x[0, 0] = -1                           # the -1 form
    c = tpw.digits_to_chunks(T(x))
    assert np.array_equal(c.numpy(), np.asarray(jpw.digits_to_chunks(jnp.asarray(x))))
    y = _rand(rng, (5, 24))
    cy = tpw.digits_to_chunks(T(y))
    conv = tpw.negacyclic_conv_chunks(c, cy)
    jconv = jpw.negacyclic_conv_chunks(jnp.asarray(c.numpy()), jnp.asarray(cy.numpy()))
    assert np.array_equal(conv.numpy(), np.asarray(jconv))
    assert np.array_equal(tpw.chunks_to_digits(conv).numpy(),
                          np.asarray(jpw.chunks_to_digits(jconv)))


# L 32 / 48 / 72: the inner rings of the MPIR_FFT_NTT=0 10^8 plan, the
# 1.2x10^9 default plan and the NTT=0 10^9 plan
@pytest.mark.parametrize("B,L", [(4, 16), (3, 71), (3, 32), (3, 48), (2, 72)])
def test_conv_plain_matches_reference_kernel(rng, B, L):
    a, b = _rand(rng, (B, L)), _rand(rng, (B, L))
    got = mulmod_base_fused(T(a), T(b))               # CPU: the plain version
    assert torch.equal(got, tpw.conv_base_plain(T(a), T(b)))
    want = j_mulmod_base_fused(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(normmod(got).numpy(), np.asarray(jnormmod(want)))
    W = 16 * L
    p = (1 << W) + 1
    for r in range(B):
        assert int_from_digits(got[r].numpy()) % p == \
            int_from_digits(a[r]) * int_from_digits(b[r]) % p


def _extreme_rows(L):
    """Rows at the transform invariant's extreme magnitudes: all +2^17, all
    -2^17, alternating signs (both phases), and the -1 form."""
    e = 1 << 17
    alt = np.where(np.arange(L) % 2 == 0, e, -e).astype(np.int32)
    minus_one = np.zeros(L, np.int32)
    minus_one[0] = -1
    return np.stack([np.full(L, e, np.int32), np.full(L, -e, np.int32), alt, -alt, minus_one])


@pytest.mark.parametrize("L", [48, 2048])
def test_conv_extreme_rows_match_oracle(L):
    """Every pair of extreme rows (L 48: the 1.2x10^9 plan's inner rings;
    2048: the widest ring the schoolbook serves) against Python's product
    mod 2^(16L)+1.  The Python-int oracle only: the reference's kernel
    would interpret 2L = 4096 chunk steps."""
    x = _extreme_rows(L)
    n = len(x)
    a = np.repeat(x, n, axis=0)
    b = np.tile(x, (n, 1))
    got = mulmod_base_fused(T(a), T(b)).numpy()
    p = (1 << (16 * L)) + 1
    for r in range(n * n):
        assert int_from_digits(got[r]) % p == int_from_digits(a[r]) * int_from_digits(b[r]) % p, r


def _schoolbook_widths():
    """The ring widths the planner's plans over 10^5..4x10^9 bits (balanced
    and 3:1 products, with and without sqrt2) send to the schoolbook: the
    innermost ring of each plan's recursion that the NTT does not take."""
    widths = set()
    bits = 100_000
    while bits <= 4_000_000_000:
        for bits_b in (bits, bits // 3):
            for sqrt2 in (True, None):
                N = choose_params(bits, bits_b, sqrt2=sqrt2).W
                while (ip := inner_plan(N)) is not None:
                    N = ip.Wp
                L = N // 16
                if not (ntt_supported(L) and tpw._use_ntt()):
                    widths.add(L)
        bits = bits * 21 // 20 + 1
    return widths


SCHOOLBOOK_WIDTHS = {40, 48, 56, 72, 80, 88, 96, 112, 136, 138, 144, 146, 160, 192, 194, 200,
                     214, 250, 288}
SCHOOLBOOK_WIDTHS_NTT_OFF = SCHOOLBOOK_WIDTHS | {32, 64, 68, 84, 104, 120, 128, 224, 256, 272,
                                                 320, 384, 512, 1024}


@pytest.mark.parametrize("ntt", [None, "0"])
def test_schoolbook_widths_of_the_plans(monkeypatch, ntt):
    """Every width a plan sends to the schoolbook, pinned: the inner Lp of
    the recursive rings (48: the 1.2x10^9 default plan) and, under
    MPIR_FFT_NTT=0, the outer L of the plans that do not recurse.  Each
    is one the schoolbook serves (2L <= 4096), so the card's tests of
    every width to 130 and of 128-2047 cover the routes a plan takes."""
    if ntt is None:
        monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    else:
        monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    widths = _schoolbook_widths()
    assert widths == (SCHOOLBOOK_WIDTHS if ntt is None else SCHOOLBOOK_WIDTHS_NTT_OFF)
    for L in widths:
        assert 2 * L <= tpw.SCHOOLBOOK_MAX_CHUNKS and tpw.base_serves(L), L


@pytest.mark.parametrize("L", [8, 126])
def test_mulmod_base_matches_reference(ntt_off, rng, L):
    a = _rand(rng, (2, 3, L))
    b = np.broadcast_to(_rand(rng, (3, L)), a.shape)
    got = tpw.mulmod_base(T(a), T(b), canonical=True)
    want = jpw.mulmod_base(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tpw.mulmod_base(T(a), T(b[0]), canonical=True), got)   # broadcast
    red = tpw.mulmod_base(T(a), T(b), canonical=False)
    assert torch.equal(normmod(red), got)
    assert int(red.abs().max()) < 1 << 20


def test_base_serves_matches_reference(monkeypatch):
    """The port's one predicate equals the reference's under both settings
    of MPIR_FFT_NTT."""
    for ntt in ("1", "0"):
        monkeypatch.setenv("MPIR_FFT_NTT", ntt)
        for L in (1, 64, 126, 2047, 2048, 2049, 3072, 4096, 8192, 16384):
            assert tpw.base_serves(L) == jpw.base_serves(L), (ntt, L)
        assert tpw.base_serves(8192) == (ntt == "1")


def test_mulmod_base_branch_and_limits(rng):
    L = 64
    N = 16 * L
    a, b = _rand(rng, (4, L)), _rand(rng, (4, L))
    got = mulmod(T(a), T(b), N, canonical=True).numpy()
    p = (1 << N) + 1
    for r in range(4):
        want = int_from_digits(a[r]) * int_from_digits(b[r]) % p
        assert int_from_digits(got[r]) % p == want
    # 2L > 4096: the base cannot serve the ring, mulmod recurses (mulmod_fft)
    Nw = 16 * 2049
    pw = (1 << Nw) + 1
    wa, wb = _rand(rng, (2, 2049)), _rand(rng, (2, 2049))
    wide = mulmod(T(wa), T(wb), Nw).numpy()
    for r in range(2):
        assert int_from_digits(wide[r]) % pw == int_from_digits(wa[r]) * int_from_digits(wb[r]) % pw
    assert np.array_equal(wide, normmod(T(wide)).numpy())     # canonical
    assert MULMOD_BASE_MAX_BITS == 131072


def test_conv_wrapper_rejects():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mulmod_base_fused(x, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        mulmod_base_fused(x[None], x[None])
    with pytest.raises(ValueError):
        mulmod_base_fused(x[:, ::2], x[:, ::2])              # not contiguous
