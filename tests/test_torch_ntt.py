"""The port's dense NTT-CRT pointwise leaf (ops/ntt.py: host copies, link
wrappers and their plain versions, mulmod_ntt) against the JAX package and
Python ints.

The host copies (primes, roots, plane-block matrices, Garner constants)
must equal the reference's exactly.  The plain versions of input_planes and
mid_planes must equal the reference's Pallas kernels (_input_planes,
_mid_planes, run in interpret mode on the CPU) bit for bit; garner_carry's
raw digits come from another spread than the reference's, so it must equal
_garner_carry after normmod, inside the reference's digit bound
|d| < 2^16 + 2^12.  Everything is integer arithmetic: the tolerance is
exact."""

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.ops import ntt as jntt
from mpir_fft_tpu.ops import pointwise as jpw
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu.ops.limb import normmod as jnormmod
from mpir_fft_tpu.utils.params import choose_params as j_choose_params
from mpir_fft_tpu_torch import mulmod_int
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import mulmod as tmm
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops import pointwise as tpw
from mpir_fft_tpu_torch.ops.limb import digits_from_int, int_from_digits, normmod
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, plan_from_reference, tensor_to_digits

DIGIT_BOUND = (1 << 16) + (1 << 12)     # the reference's redundant-output bound
LINK_SHAPES = [(32, 128), (64, 256)]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _spy_ntt(monkeypatch):
    """Record the operand shape of every mulmod_ntt call mulmod_base makes."""
    calls = []
    real = tpw.mulmod_ntt

    def spy(a, b, **kw):
        calls.append(tuple(a.shape))
        return real(a, b, **kw)

    monkeypatch.setattr(tpw, "mulmod_ntt", spy)
    return calls


def _oracle_rows(got, a, b, M):
    p = (1 << (16 * M)) + 1
    for r in range(a.shape[0]):
        assert int_from_digits(got[r]) % p == int_from_digits(a[r]) * int_from_digits(b[r]) % p, r


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

def test_host_constants_match_reference():
    assert tntt.PRIMES == jntt.PRIMES and tntt.PRIMES_T2 == jntt.PRIMES_T2
    assert (tntt.TIER1_MAX_M, tntt.NTT_MAX_M) == (jntt.TIER1_MAX_M, jntt.NTT_MAX_M)
    for M in (4, 64, 2048, 4096, 8192):
        assert tntt._tier(M) == jntt._tier(M)
        for p in tntt._tier(M)[0]:
            assert tntt._psi(p, M) == jntt._psi(p, M)
    for primes in (tntt.PRIMES, tntt.PRIMES_T2):
        assert tntt._garner_consts(primes) == jntt._garner_consts(primes)
    assert [tntt.ntt_supported(M) for M in range(1, 16385)] == \
        [jntt.ntt_supported(M) for M in range(1, 16385)]


@pytest.mark.parametrize("M", [4, 64, 256, 2048])
def test_matrices_match_reference(M):
    got, want = tntt._matrices(M), jntt._matrices(M)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["p"], g["k"]) == (w["p"], w["k"])
        assert g["F"].dtype == np.int8 and np.array_equal(g["F"], w["F"])
        assert np.array_equal(g["G"], w["G"])
    blocks = tntt._blocks(M, torch.device("cpu"))
    assert [p for p, _, _ in blocks] == list(tntt.PRIMES)
    assert all(torch.equal(F, torch.from_numpy(w["F"])) for (_, F, _), w in zip(blocks, want))


# ---------------------------------------------------------------------------
# the three link kernels' plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M", LINK_SHAPES)
def test_input_planes_plain_matches_reference(B, M):
    rng = np.random.default_rng(B + M)
    x = rng.integers(-(1 << 25), 1 << 25, (B, M)).astype(np.int32)
    x[0] = 0x7FFF                      # balanced-pass edges: carries into every digit
    x[1] = -0x8000
    x[2, -1] = 1 << 25                 # the top carry wraps negated into digit 0
    got = tntt.input_planes(T(x))
    assert torch.equal(got, tntt.input_planes_plain(T(x)))
    assert got.dtype == torch.int8 and got.shape == (3, B, 2 * M)
    want = jntt._input_planes(jnp.asarray(x), jntt._matrices(M))
    for j in range(3):
        assert np.array_equal(got[j].numpy(), np.asarray(want[j])), j


@pytest.mark.parametrize("B,M", LINK_SHAPES)
def test_mid_planes_plain_matches_reference(B, M):
    rng = np.random.default_rng(B * M)
    lim = 2 * M * 128 * 128            # the raw GEMM sums' bound
    sa = rng.integers(-lim, lim + 1, (B, 2 * M)).astype(np.int32)
    sb = rng.integers(-lim, lim + 1, (B, 2 * M)).astype(np.int32)
    sa[0], sb[0] = lim, -lim
    for p in tntt.PRIMES:
        got = tntt.mid_planes(T(sa), T(sb), p)
        assert torch.equal(got, tntt.mid_planes_plain(T(sa), T(sb), p))
        want = jntt._mid_planes(jnp.asarray(sa), jnp.asarray(sb), p, 2)
        assert np.array_equal(got.numpy(), np.asarray(want)), p


@pytest.mark.parametrize("B,M", LINK_SHAPES)
def test_garner_carry_plain_matches_reference(B, M):
    rng = np.random.default_rng(B + 7 * M)
    lim = 2 * M * 128 * 128
    parts = [rng.integers(-lim, lim + 1, (B, 2 * M)).astype(np.int32) for _ in range(3)]
    got = tntt.garner_carry(*map(T, parts))
    assert torch.equal(got, tntt.garner_carry_plain(*map(T, parts)))
    with force_pallas(True):
        want = jntt._garner_carry([jnp.asarray(s) for s in parts], jntt.PRIMES, raw_k=2)
    assert np.array_equal(normmod(got).numpy(), np.asarray(jnormmod(want)))
    assert int(got.abs().max()) < DIGIT_BOUND


def test_garner_recovers_signed_coefficients():
    """_garner inverts the residues of every c in its range [lo, lo + P)
    exactly (lo = -p1 p2 (p3 - 1)/2, so the range holds |c| < 2^43.8), and
    _spread places its pieces at digits i, i+1, i+2 (negacyclic)."""
    rng = np.random.default_rng(9)
    p1, p2, p3 = tntt.PRIMES
    lo = -p1 * p2 * ((p3 - 1) // 2)
    c = [int(v) for v in rng.integers(-(1 << 43), 1 << 43, 64)] + [lo, lo + p1 * p2 * p3 - 1, 0, -1]
    rs = [torch.tensor([v % p for v in c], dtype=torch.int32) for p in tntt.PRIMES]
    assert tntt._garner(*rs).tolist() == c
    M = len(c)
    d = tntt._spread(torch.tensor(c, dtype=torch.int64))
    val = sum(int(x) << (16 * i) for i, x in enumerate(d.tolist()))
    want = sum(v << (16 * i) for i, v in enumerate(c))
    assert (val - want) % ((1 << (16 * M)) + 1) == 0


# ---------------------------------------------------------------------------
# mulmod_ntt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 16, 128, 256, 2048])
def test_mulmod_ntt_matches_reference(M):
    rng = np.random.default_rng(M)
    B = 2 if M == 2048 else 4
    for lo, hi in ((0, 1 << 16), (-(1 << 25), 1 << 25)):      # canonical, redundant
        a = rng.integers(lo, hi, (B, M)).astype(np.int32)
        b = rng.integers(lo, hi, (B, M)).astype(np.int32)
        red = tntt.mulmod_ntt(T(a), T(b))
        assert int(red.abs().max()) < DIGIT_BOUND
        got = tntt.mulmod_ntt(T(a), T(b), canonical=True)
        assert torch.equal(got, normmod(red))
        _oracle_rows(got.numpy(), a, b, M)
        want = jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M", [8, 64])
def test_mulmod_ntt_special_values(M):
    """The -1 form, 0, 1 and 2^(16M) - 1 against each other (tests/test_ntt.py)."""
    minus1 = np.zeros(M, np.int32)
    minus1[0] = -1
    top = np.full(M, 0xFFFF, np.int32)
    cases = [minus1, np.zeros(M, np.int32), np.eye(1, M, dtype=np.int32)[0], top,
             np.ones(M, np.int32)]
    a = np.stack([x for x in cases for _ in cases])
    b = np.stack([y for _ in cases for y in cases])
    got = tntt.mulmod_ntt(T(a), T(b), canonical=True).numpy()
    _oracle_rows(got, a, b, M)
    want = jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(got, np.asarray(want))


def test_mulmod_ntt_square_and_broadcast():
    rng = np.random.default_rng(3)
    a = rng.integers(-(1 << 17), 1 << 17, (2, 3, 32)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (3, 32)).astype(np.int32)
    x = T(a)
    sq = tntt.mulmod_ntt(x, x, canonical=True)
    assert torch.equal(sq, tntt.mulmod_ntt(x, x.clone(), canonical=True))
    got = tntt.mulmod_ntt(x, T(b), canonical=True)
    assert got.shape == (2, 3, 32)
    assert torch.equal(got, tntt.mulmod_ntt(x, T(np.broadcast_to(b, a.shape)), canonical=True))


def test_mulmod_ntt_rejects():
    x = torch.zeros((2, 4096), dtype=torch.int32)
    assert torch.equal(tntt.mulmod_ntt(x, x), x)    # tier 2 (4-step) computes
    with pytest.raises(ValueError):
        tntt.mulmod_ntt(x[:, :48], x[:, :48])       # not a power of two
    wide = torch.zeros((2, 16384), dtype=torch.int32)
    with pytest.raises(ValueError):
        tntt.mulmod_ntt(wide, wide)                 # above NTT_MAX_M
    with pytest.raises(ValueError):
        tntt.mulmod_ntt(x[:, :3072], x[:, :3072])   # in the 4-step range, not a power of two
    with pytest.raises(TypeError):
        tntt.input_planes(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        tntt.mid_planes(torch.zeros((2, 16), dtype=torch.int32),
                          torch.zeros((2, 16), dtype=torch.int32), 65537)


# ---------------------------------------------------------------------------
# dispatch: mulmod_base and mulmod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ntt", ["1", "0"])
def test_mulmod_base_dispatch(monkeypatch, ntt):
    monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    calls = _spy_ntt(monkeypatch)
    rng = np.random.default_rng(11)
    a = rng.integers(-(1 << 17), 1 << 17, (4, 32)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (4, 32)).astype(np.int32)
    got = tpw.mulmod_base(T(a), T(b), canonical=True)
    assert len(calls) == (ntt == "1")
    want = jpw.mulmod_base(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    tpw.mulmod_base(T(a[:, :24]), T(b[:, :24]))      # not a power of two: schoolbook
    assert len(calls) == (ntt == "1")
    for L in (4096, 8192):                            # the 4-step tier's rings
        assert tpw.base_serves(L) == (ntt == "1") == jpw.base_serves(L)
    assert tpw.base_serves(2048) and not tpw.base_serves(16384)


def test_tier2_ring_recurses(monkeypatch):
    """N = 65536 (L 4096): the base serves it with the 4-step tier, as the
    reference's does, to the value of the recursive mulmod_fft and the
    oracle."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    N = 65536
    assert tpw.base_serves(N // 16) and tmm.inner_plan(N) is None
    calls = _spy_ntt(monkeypatch)
    rng = np.random.default_rng(12)
    x = rng.integers(-(1 << 17), 1 << 17, (2, N // 16)).astype(np.int32)
    y = rng.integers(-(1 << 17), 1 << 17, (2, N // 16)).astype(np.int32)
    got = tmm.mulmod(T(x), T(y), N, canonical=True).numpy()
    assert calls == [(2, N // 16)]
    _oracle_rows(got, x, y, N // 16)
    assert np.array_equal(got, tmm.mulmod_fft(T(x), T(y), tmm.mulmod_plan(N)).numpy())


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _operands(bits_a, bits_b):
    rnd = random.Random(bits_a * 3 + bits_b)
    return (rnd.getrandbits(bits_a) | (1 << (bits_a - 1)),
            rnd.getrandbits(bits_b) | (1 << (bits_b - 1)))


@pytest.mark.parametrize("bits,plan", [(120000, (7, 8, 64)), (124000, (9, 1, 32))])
def test_mul_default_ntt_plan_matches_reference(monkeypatch, bits, plan):
    """A default plan whose pointwise is the dense NTT, even w (L 64) and
    odd w (L 32): port mul and sqr, the reference flagship (same plan, the
    variable unset) and Python's product agree."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    a, b = _operands(bits, bits)
    jp = j_choose_params(bits, bits, sqrt2=True)
    tp = tmul.choose_params(bits, bits, sqrt2=True)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.depth, tp.w, tp.W // 16) == plan
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(a, device="cpu") == a * a
    L = -(-bits // 16)
    da, db = digits_from_int(a, L), digits_from_int(b, L)
    want = np.asarray(jax.jit(functools.partial(jmul.mpn_mul_flagship, plan=jp))(
        jnp.asarray(da), jnp.asarray(db)))
    got = tensor_to_digits(tmul.mpn_mul_flagship(
        digits_to_tensor(da, "cpu"), digits_to_tensor(db, "cpu"), plan_from_reference(
            dataclasses.asdict(jp))))
    assert np.array_equal(got, want)


def test_mulmod_int_dense_ntt_ring(monkeypatch):
    """N = 2^15: one L 2048 ring, the dense tier's widest, straight to the NTT."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    N = 1 << 15
    p = (1 << N) + 1
    rnd = random.Random(N + 1)
    calls = _spy_ntt(monkeypatch)
    for x, y in ((rnd.getrandbits(N), rnd.getrandbits(N)), (p - 1, p - 1), (p - 1, 12345)):
        assert mulmod_int(x, y, N, device="cpu") == x * y % p
    assert calls and all(s[-1] == 2048 for s in calls)
