"""The port's 4-step NTT tier (ops/ntt.py, M = 4096 and 8192: host copies,
the link wrappers and their plain versions, Garner's residue form, the fused
path, mulmod_ntt) against the JAX package and Python ints.

The host copies (_ntt4_mats, _ntt4_tables) must equal the reference's.  The
plain links must equal the reference's Pallas kernels (_link3_multi /
_link3 bodies, run in interpret mode on the CPU) at a canonical point: the
input planes bit for bit (after permuting the reference's [B, 3 m1, m2]
layout into the port's (B*m2, 3*m1) rows), each prime's residues in
[0, p).  Garner's raw digits come from another spread than the reference's,
so digits are compared after normmod, inside the reference's bound
|d| < 2^16 + 2^12.  Everything is integer arithmetic: the tolerance is
exact."""

import contextlib
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
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu.ops.limb import normmod as jnormmod
from mpir_fft_tpu.utils.params import plan_for_depth as j_plan_for_depth
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import mulmod as tmm
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops import pointwise as tpw
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, plan_from_reference, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import plan_for_depth

DIGIT_BOUND = (1 << 16) + (1 << 12)     # the reference's redundant-output bound
LINK_B = 32


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _oracle_rows(got, a, b, M):
    p = (1 << (16 * M)) + 1
    for r in range(a.shape[0]):
        assert int_from_digits(got[r]) % p == int_from_digits(a[r]) * int_from_digits(b[r]) % p, r


def _digits(rng, B, M, bound=1 << 25):
    x = rng.integers(-bound, bound, (B, M)).astype(np.int32)
    x[0] = 0x7FFF                      # balanced-pass edges: carries into every digit
    x[1] = -0x8000
    x[2, -1] = bound - 1               # the top carry wraps negated into digit 0
    return x


def _ref_planes(a, b):
    """The reference's input planes of both operands, permuted into the
    port's (B*m2, 3*m1) layout: [(planes of a, planes of b) per prime]."""
    B, M = a.shape
    mats = jntt._ntt4_mats(M)
    m1, m2 = mats[0]["m1"], mats[0]["m2"]
    pairs = jntt._ntt4_input_planes(jnp.asarray(a).reshape(B, m1, m2),
                                    jnp.asarray(b).reshape(B, m1, m2), mats)
    return [tuple(np.swapaxes(np.asarray(x), -1, -2).reshape(B * m2, 3 * m1) for x in pair)
            for pair in pairs]


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_host_tables_match_reference(M):
    got, want = tntt._ntt4_mats(M), jntt._ntt4_mats(M)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("p", "k", "m1", "m2")} == {k: w[k] for k in ("p", "k", "m1", "m2")}
        for key in ("F1", "F2", "G1", "G2", "T", "Ti"):
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    (garrs, gmetas), (warrs, wmetas) = tntt._ntt4_tables(M), jntt._ntt4_tables(M)
    assert gmetas == wmetas
    assert len(garrs) == len(warrs) == 18
    assert all(np.array_equal(g, w) for g, w in zip(garrs, warrs))
    m1, m2 = tntt._ntt4_shape(M)
    assert (m1, m2) == (want[0]["m1"], want[0]["m2"])
    blocks = tntt._ntt4_blocks(M, torch.device("cpu"))
    assert [b.p for b in blocks] == list(tntt.PRIMES_T2)
    for blk, w in zip(blocks, want):
        assert blk.F2.shape == (3 * m2, 3 * m2) and blk.F2.stride() == (1, 3 * m2)   # column-major
        for key in ("F1", "F2", "G1", "G2", "T", "Ti"):
            assert torch.equal(getattr(blk, key), torch.from_numpy(w[key])), key
    # the fused kernel's packed tables, per prime: F1, F2's column tiles, G1,
    # G2's column tiles in the wgmma layout, then T R^2 and Ti R^5 mod p in
    # fragment order -- unpacked here from the layout's formulas and held
    # against the reference's arrays
    packed = tntt._ntt4_fused_tables(M, torch.device("cpu")).numpy()
    assert packed.dtype == np.uint8
    at = 0
    for pi, p in enumerate(tntt.PRIMES_T2):
        F1, F2, G1, G2, Tw, Tiw = warrs[6 * pi:6 * pi + 6]
        for blk in (F1, F2, G1, G2):
            assert at % 16 == 0
            at = _check_fused_block(packed, at, blk)
        for tab, r, on_rows in ((Tw, pow(2, 64, p), True), (Tiw, pow(2, 160, p), False)):
            frag = packed[at:at + 4 * M].view(np.int32).reshape(-1, 8, 128, 4)
            assert np.array_equal(_unfragment(frag, tab.shape, on_rows),
                                  tab.astype(np.int64) * r % p)
            at += 4 * M
    assert at == packed.size


def _check_fused_block(packed, at, blk):
    """The [3m, 3m] block's column tiles from packed[at:]: tile nt's byte
    (q, n) at (q // 16) 3072 + (n // 8) 128 + (n % 8) 16 + q % 16 holds
    blk[q, j m + 64 nt + k], n = 64 j + k.  Returns the offset after it."""
    K = blk.shape[0]
    m = K // 3
    q = np.arange(K)[:, None]
    n = np.arange(192)[None, :]
    for nt in range(m // 64):
        tile = packed[at + (q // 16) * 3072 + (n // 8) * 128 + (n % 8) * 16 + q % 16]
        cols = (n // 64) * m + 64 * nt + n % 64
        assert np.array_equal(tile.view(np.int8), blk[q, cols])
        at += K * 192
    return at


def _unfragment(frag, shape, on_rows):
    """Fragment order (tile, i, thread t, he) -> the [R, C] table: tile row
    16 (t >> 5) + ((t & 31) >> 2) + 8 (he >> 1), tile column 8 i + 2 (t & 3)
    + (he & 1); 64-row tiles (on_rows) or 64-column ones."""
    out = np.full(shape, -1, np.int64)
    for nt in range(frag.shape[0]):
        for i in range(8):
            for t in range(128):
                for he in range(4):
                    r = 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (he >> 1)
                    c = 8 * i + 2 * (t & 3) + (he & 1)
                    at = (64 * nt + r, c) if on_rows else (r, 64 * nt + c)
                    out[at] = frag[nt, i, t, he]
    return out


def _kernel_planes(v):
    """csrc/ntt4_fused.cuh put3: the int8 planes of |v| < 2^23, p0 + 256 p1 + 65536 p2."""
    p0 = ((v + 128) & 255) - 128
    t = (v + 128) >> 8
    p2 = (t + 128) >> 8
    assert np.abs(p2).max() <= 127
    return [p0, ((t + 128) & 255) - 128, p2]


def _emulate_fused(a, b, M):
    """The fused kernel's arithmetic on the packed tables, a block product
    at a time: input planes of the balanced digits (every prime), each fold
    a Montgomery reduction (times R^-1, R = 2^32; any representative in
    [0, 2p) -- here the larger where it exists), the twiddles in fragment
    order carrying R^2 / R^5, the G1 fold brought back by R^2."""
    m1, m2 = tntt._ntt4_shape(M)
    nt2 = m2 // 64
    packed = tntt._ntt4_fused_tables(M, torch.device("cpu")).numpy()
    per = packed.size // 3
    B = a.shape[0]

    def balanced(x):
        c = (x + (1 << 15)) >> 16
        cp = np.roll(c, 1, axis=1)
        cp[:, 0] = -cp[:, 0]
        return x - (c << 16) + cp

    def tile(at, K):
        q, n = np.arange(K)[:, None], np.arange(192)[None, :]
        return packed[at + (q // 16) * 3072 + (n // 8) * 128 + (n % 8) * 16 + q % 16].view(
            np.int8).astype(np.int64)

    res = []
    for pi, p in enumerate(tntt.PRIMES_T2):
        at, K2 = pi * per, 3 * m2
        F1 = tile(at, 192)
        F2 = [tile(at + 192 * 192 + nt * K2 * 192, K2) for nt in range(nt2)]
        at += 192 * 192 + 9 * m2 * m2
        G1 = tile(at, 192)
        G2 = [tile(at + 192 * 192 + nt * K2 * 192, K2) for nt in range(nt2)]
        at += 192 * 192 + 9 * m2 * m2
        frags = packed[at:at + 8 * M].view(np.int32).reshape(2, -1, 8, 128, 4)
        Tm = _unfragment(frags[0], (m2, m1), True)
        Tim = _unfragment(frags[1], (m1, m2), False)
        rinv = pow(1 << 32, -1, p)

        def mont(v):                                    # v R^-1 mod p, the representative < 2p
            r = v % p * rinv % p
            return np.where(r < p, r + p, r)

        def fold(S):
            assert np.abs(S).max() < 2 ** 22.6
            return mont(S[..., :64] + 256 * S[..., 64:128] + 65536 * S[..., 128:])

        def forward(x):
            xb = balanced(x).reshape(B, m1, m2).transpose(0, 2, 1)             # [b, i2, i1]
            X1 = np.concatenate(_kernel_planes(xb), 2)
            u = mont(fold(X1 @ F1) * Tm)                                 # [b, i2, k1]: v T
            X2 = np.concatenate(_kernel_planes(u.transpose(0, 2, 1)), 2)  # [b, k1, (j, i2)]
            return np.concatenate([fold(X2 @ F2[nt]) for nt in range(nt2)], 2)

        fa = forward(a)
        fb = fa if b is a else forward(b)
        X3 = np.concatenate(_kernel_planes(mont(fa * fb)), 2)            # [b, k1, (j, k2)]
        g = mont(np.concatenate([fold(X3 @ G2[nt]) for nt in range(nt2)], 2) * Tim)
        X4 = np.concatenate(_kernel_planes(g.transpose(0, 2, 1)), 2)     # [b, i2, (j, k1)]
        r = mont(fold(X4 @ G1) * pow(1 << 32, 2, p)) % p
        res.append(r.transpose(0, 2, 1).reshape(B, M))
    return np.stack(res)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_fused_kernel_arithmetic(M, square):
    """The fused kernel's design, emulated on the CPU from its packed tables
    (lazy planes, Montgomery folds, fragment-ordered twiddles), gives the
    plain pipeline's residues exactly, extreme digits included."""
    rng = np.random.default_rng(M + square)
    a = _digits(rng, 3, M).astype(np.int64)
    a[1] = 1 << 25
    b = a if square else _digits(rng, 3, M).astype(np.int64)
    got = _emulate_fused(a, b, M)
    ta = torch.from_numpy(a.astype(np.int32))
    tb = ta if square else torch.from_numpy(b.astype(np.int32))
    assert np.array_equal(got, tntt.ntt4_fused_plain(ta, tb).numpy())


def test_tier2_garner_recovers_signed_coefficients():
    """_garner over PRIMES_T2 inverts the residues of every c in its range
    [lo, lo + P) (|c| < 2^49.1), and _spread places the pieces so that one
    carry pass bounds the digits."""
    rng = np.random.default_rng(9)
    p1, p2, p3 = tntt.PRIMES_T2
    lo = -p1 * p2 * ((p3 - 1) // 2)
    c = [int(v) for v in rng.integers(-(1 << 49), 1 << 49, 64)] + [lo, lo + p1 * p2 * p3 - 1, 0, -1]
    rs = [torch.tensor([v % p for v in c], dtype=torch.int32) for p in tntt.PRIMES_T2]
    assert tntt._garner(*rs, tntt.PRIMES_T2).tolist() == c
    M = len(c)
    d = tntt.garner_residues_plain(*(r[None] for r in rs))[0]
    assert int(d.abs().max()) < DIGIT_BOUND
    val = sum(int(x) << (16 * i) for i, x in enumerate(d.tolist()))
    want = sum(v << (16 * i) for i, v in enumerate(c))
    assert (val - want) % ((1 << (16 * M)) + 1) == 0


# ---------------------------------------------------------------------------
# the links' plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_input_planes_plain_matches_reference(M):
    """#15: the all-primes input-planes pass."""
    rng = np.random.default_rng(M)
    a, b = _digits(rng, LINK_B, M), _digits(rng, LINK_B, M)
    got_a, got_b = tntt.ntt4_input_planes(T(a)), tntt.ntt4_input_planes(T(b))
    assert torch.equal(got_a, tntt.ntt4_input_planes_plain(T(a)))
    m1, m2 = tntt._ntt4_shape(M)
    assert got_a.dtype == torch.int8 and got_a.shape == (3, LINK_B * m2, 3 * m1)
    for j, (wa, wb) in enumerate(_ref_planes(a, b)):
        assert np.array_equal(got_a[j].numpy(), wa), j
        assert np.array_equal(got_b[j].numpy(), wb), j


@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_links_match_reference(M):
    """#14: per prime, the residues [B, M] in [0, p) that the linked legs
    (F1, k_mid1, F2, k_pw, G2, k_mid3, G1, k_out) produce equal the
    reference's _ntt4_linked_parts after its own swapaxes; the wrappers'
    results equal the plain versions' at every link."""
    rng = np.random.default_rng(M + 1)
    a, b = _digits(rng, LINK_B, M), _digits(rng, LINK_B, M)
    pa, pb = tntt.ntt4_input_planes(T(a)), tntt.ntt4_input_planes(T(b))
    mats = jntt._ntt4_mats(M)
    m1, m2 = tntt._ntt4_shape(M)
    for i, ((ra, rb), mat, blk) in enumerate(zip(_ref_planes(a, b), mats,
                                                 tntt._ntt4_blocks(M, torch.device("cpu")))):
        p = blk.p
        got = tntt._ntt4_leg(pa[i], pb[i], blk, M)
        assert torch.equal(got, tntt._ntt4_leg(pa[i], pb[i], blk, M, plain=True))
        assert got.shape == (LINK_B, M) and int(got.min()) >= 0 and int(got.max()) < p
        V = jntt._ntt4_linked_parts(jnp.asarray(ra).reshape(LINK_B, m2, 3 * m1).swapaxes(-1, -2),
                                    jnp.asarray(rb).reshape(LINK_B, m2, 3 * m1).swapaxes(-1, -2),
                                    LINK_B, mat)
        want = np.swapaxes(np.asarray(V), -1, -2).reshape(LINK_B, M)
        assert np.array_equal(got.numpy(), want), p
        # each link alone: the wrapper (CPU: the plain version) and the plain version
        S1 = tntt._dot_raw(pa[i], blk.F1)
        pl2 = tntt.ntt4_fwd_twiddle(S1, p, M)
        assert torch.equal(pl2, tntt.ntt4_fwd_twiddle_plain(S1, p, M))
        assert pl2.shape == (LINK_B * m1, 3 * m2) and pl2.dtype == torch.int8
        S2 = tntt._dot_raw(pl2, blk.F2)
        pp = tntt.ntt4_pointwise(S2, S2, p, M)
        assert torch.equal(pp, tntt.ntt4_pointwise_plain(S2, S2, p, M))
        S3 = tntt._dot_raw(pp, blk.G2)
        pl4 = tntt.ntt4_inv_twiddle(S3, p, M)
        assert torch.equal(pl4, tntt.ntt4_inv_twiddle_plain(S3, p, M))
        assert pl4.shape == (LINK_B * m2, 3 * m1)
        S4 = tntt._dot_raw(pl4, blk.G1)
        assert torch.equal(tntt.ntt4_residues(S4, p, M), tntt.ntt4_residues_plain(S4, p, M))


@pytest.mark.parametrize("M", [4096, 8192])
def test_garner_residues_matches_reference(M):
    """#13, residue form: equal to _garner_carry(parts, PRIMES_T2) (raw_k
    None, the reference's Pallas kernel in interpret mode) after normmod."""
    rng = np.random.default_rng(M + 2)
    parts = [rng.integers(0, p, (LINK_B, M)).astype(np.int32) for p in tntt.PRIMES_T2]
    for j, p in enumerate(tntt.PRIMES_T2):
        parts[j][0] = p - 1            # the extremes of the CRT range
        parts[j][1] = 0
    got = tntt.garner_residues(*map(T, parts))
    assert torch.equal(got, tntt.garner_residues_plain(*map(T, parts)))
    assert int(got.abs().max()) < DIGIT_BOUND
    with force_pallas(True):
        want = jntt._garner_carry([jnp.asarray(r) for r in parts], jntt.PRIMES_T2)
    assert np.array_equal(normmod(got).numpy(), np.asarray(jnormmod(want)))


def test_ntt4_wrappers_reject():
    x = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(ValueError):
        tntt.ntt4_input_planes(torch.zeros((2, 2048), dtype=torch.int32))   # a dense-tier ring
    with pytest.raises(TypeError):
        tntt.ntt4_input_planes(x.to(torch.int64))
    with pytest.raises(ValueError):
        tntt.ntt4_input_planes(torch.zeros((2, 8192), dtype=torch.int32)[:, ::2])
    S = torch.zeros((64 * 2, 192), dtype=torch.int32)
    with pytest.raises(ValueError):
        tntt.ntt4_fwd_twiddle(S, 12289, 4096)                 # a tier-1 prime
    with pytest.raises(ValueError):
        tntt.ntt4_fwd_twiddle(S[:100], 65537, 4096)           # not whole rows of B
    with pytest.raises(ValueError):
        tntt.ntt4_inv_twiddle(S, 65537, 8192)                 # (B*m1, 3*m2) at M 8192: 384 columns
    with pytest.raises(ValueError):
        tntt.ntt4_pointwise(S, S[:64], 65537, 4096)
    with pytest.raises(TypeError):
        tntt.ntt4_residues(S.to(torch.int8), 65537, 4096)
    with pytest.raises(ValueError):
        tntt.garner_residues(x, x, x[:1])
    with pytest.raises(ValueError):
        tntt.ntt4_fused(x, torch.zeros((3, 4096), dtype=torch.int32))


# ---------------------------------------------------------------------------
# mulmod_ntt, 4-step tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4096, 8192])
def test_mulmod_ntt4_matches_reference(M):
    """Redundant inputs up to 2^24: equal to jntt.mulmod_ntt (its XLA
    4-step path on the CPU) after normmod and to the Python oracle."""
    rng = np.random.default_rng(M + 3)
    a = rng.integers(-(1 << 24), 1 << 24, (3, M)).astype(np.int32)
    b = rng.integers(-(1 << 24), 1 << 24, (3, M)).astype(np.int32)
    red = tntt.mulmod_ntt(T(a), T(b))
    assert int(red.abs().max()) < DIGIT_BOUND
    got = tntt.mulmod_ntt(T(a), T(b), canonical=True)
    assert torch.equal(got, normmod(red))
    _oracle_rows(got.numpy(), a, b, M)
    want = jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M", [4096, 8192])
def test_mulmod_ntt4_special_values(M):
    """The -1 form, ones, zero and the top digit (tests/test_ntt.py:74-87),
    every pair, against the oracle and the reference's linked path."""
    minus1 = np.zeros(M, np.int32)
    minus1[0] = -1
    top = np.zeros(M, np.int32)
    top[-1] = (1 << 16) - 1
    cases = [minus1, np.ones(M, np.int32), np.zeros(M, np.int32), top]
    a = np.stack([x for x in cases for _ in cases])
    b = np.stack([y for _ in cases for y in cases])
    got = tntt.mulmod_ntt(T(a), T(b), canonical=True).numpy()
    _oracle_rows(got, a, b, M)
    with force_pallas(True):
        want = jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(got, np.asarray(want))


def test_mulmod_ntt4_square_broadcast_and_chunks(monkeypatch):
    """A square transforms once (4 GEMMs per prime, 12 per product, where
    a product takes 18) to the same value; a broadcast operand; a batch the
    chunking splits into three chunks equals the unchunked one."""
    M = 4096
    rng = np.random.default_rng(5)
    a = rng.integers(-(1 << 17), 1 << 17, (2, 3, M)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (3, M)).astype(np.int32)
    x = T(a)
    calls = []
    real = tntt._dot_raw
    monkeypatch.setattr(tntt, "_dot_raw", lambda *args: calls.append(1) or real(*args))
    sq = tntt.mulmod_ntt(x, x, canonical=True)
    assert len(calls) == 12
    assert torch.equal(sq, tntt.mulmod_ntt(x, x.clone(), canonical=True))
    assert len(calls) == 12 + 18
    got = tntt.mulmod_ntt(x, T(b), canonical=True)
    assert got.shape == (2, 3, M)
    assert torch.equal(got, tntt.mulmod_ntt(x, T(np.broadcast_to(b, a.shape)), canonical=True))
    flat = x.reshape(6, M)
    whole = tntt.mulmod_ntt(flat, flat.flip(0))
    monkeypatch.setattr(tntt, "NTT4_CHUNK_BYTES", 2 * 12 * M)     # 2 rows per chunk
    calls.clear()
    assert torch.equal(tntt.mulmod_ntt(flat, flat.flip(0)), whole)
    assert len(calls) == 3 * 18


def test_mulmod_ntt4_fused_matches_reference(monkeypatch):
    """#16: with MPIR_FFT_NTT_FUSED=1 the chunks go through ntt4_fused (its
    plain version on the CPU), equal to the reference's _mulmod_ntt_fused
    (interpret mode) after normmod and to the linked path
    (MPIR_FFT_NTT_FUSED=0)."""
    M = 4096
    rng = np.random.default_rng(6)
    a = rng.integers(-(1 << 24), 1 << 24, (LINK_B, M)).astype(np.int32)
    b = rng.integers(-(1 << 24), 1 << 24, (LINK_B, M)).astype(np.int32)
    monkeypatch.setenv("MPIR_FFT_NTT_FUSED", "0")
    linked = tntt.mulmod_ntt(T(a), T(b))
    monkeypatch.setenv("MPIR_FFT_NTT_FUSED", "1")
    calls = []
    real = tntt.ntt4_fused
    monkeypatch.setattr(tntt, "ntt4_fused", lambda x, y: calls.append(x.shape) or real(x, y))
    got = tntt.mulmod_ntt(T(a), T(b))
    assert calls == [(LINK_B, M)]
    assert torch.equal(got, linked)
    assert torch.equal(tntt.ntt4_fused(T(a), T(b)), tntt.ntt4_fused_plain(T(a), T(b)))
    with force_pallas(True):
        want = jntt._mulmod_ntt_fused(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(normmod(got).numpy(), np.asarray(jnormmod(want)))


def _route_log(monkeypatch):
    """Record the spans mulmod_ntt enters (kernels.span's names) and each
    ntt4_fused call as (rows, square, the spans open around it)."""
    stack, entered, calls = [], [], []

    @contextlib.contextmanager
    def span(name):
        stack.append(name)
        entered.append(name)
        try:
            yield
        finally:
            stack.pop()

    real = tntt.ntt4_fused
    monkeypatch.setattr(tntt.kernels, "span", span)
    monkeypatch.setattr(tntt, "ntt4_fused", lambda x, y: calls.append(
        (x.shape[0], x is y, tuple(stack))) or real(x, y))
    return entered, calls


@pytest.mark.parametrize("digits", ["random", "extreme"])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("M", [4096, 8192])
def test_mulmod_ntt4_default_route_is_fused(monkeypatch, M, square, digits):
    """With MPIR_FFT_NTT_FUSED unset the 4-step tier takes ntt4_fused (its
    plain version on the CPU) once a chunk, inside the span mf.ntt.fused:
    here two chunks (NTT4_CHUNK_BYTES patched: 2 rows and 1), a product or
    a square, digits random or at the redundant extremes (|d| = 2^25).
    Equal digit for digit to the linked route (MPIR_FFT_NTT_FUSED=0, span
    mf.ntt.4step), and after normmod to the reference's default 4-step
    path and to Python's product."""
    monkeypatch.delenv("MPIR_FFT_NTT_FUSED", raising=False)
    rng = np.random.default_rng(M + 2 * square + (digits == "extreme"))
    if digits == "random":
        a = rng.integers(-(1 << 25), (1 << 25) + 1, (3, M)).astype(np.int32)
        b = rng.integers(-(1 << 25), (1 << 25) + 1, (3, M)).astype(np.int32)
    else:
        a = ((rng.integers(0, 2, (3, M)) * 2 - 1) << 25).astype(np.int32)
        b = np.full((3, M), 0xFFFF, np.int32)
    if square:
        b = a
    x = T(a)
    y = x if square else T(b)
    entered, calls = _route_log(monkeypatch)
    monkeypatch.setattr(tntt, "NTT4_CHUNK_BYTES", 2 * 12 * M)
    got = tntt.mulmod_ntt(x, y)
    assert calls == [(2, square, ("ntt.fused",)), (1, square, ("ntt.fused",))]
    assert entered[0] == "ntt.fused" and "ntt.4step" not in entered
    assert int(got.abs().max()) < DIGIT_BOUND
    monkeypatch.setenv("MPIR_FFT_NTT_FUSED", "0")
    entered.clear()
    linked = tntt.mulmod_ntt(x, y)
    assert len(calls) == 2 and entered[0] == "ntt.4step" and "ntt.fused" not in entered
    assert torch.equal(got, linked)
    monkeypatch.delenv("MPIR_FFT_NTT_FUSED")
    canon = normmod(got).numpy()
    _oracle_rows(canon, a, b, M)
    want = jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
    assert np.array_equal(canon, np.asarray(want))


@pytest.mark.parametrize("M", [4096, 8192])
def test_mulmod_ntt4_fused_route_takes_the_garner_post_hook(monkeypatch, M):
    """The staged flagship's garner_post hook on the default (fused) route:
    consumed, the chunks whole K-row blocks (2K rows and K here), each
    through ntt4_fused; the digits equal the leg run after the unhooked
    product (post_plain) and the linked route's under the same hook."""
    monkeypatch.delenv("MPIR_FFT_NTT_FUSED", raising=False)
    W = DIGIT_BITS * M
    kg = tfused.ladder_stages(M)
    K = 1 << kg
    steps = tuple(W >> (kg - j) for j in range(kg))
    rng = np.random.default_rng(M + 5)
    x, y = (T(rng.integers(-(1 << 17), 1 << 17, (3 * K, M))) for _ in range(2))
    _, calls = _route_log(monkeypatch)
    monkeypatch.setattr(tntt, "NTT4_CHUNK_BYTES", (2 * K + 1) * 12 * M)
    with tntt.garner_post(M, K, steps) as cell:
        got = tntt.mulmod_ntt(x, y)
    assert cell["consumed"] is True
    assert [c[0] for c in calls] == [2 * K, K]
    assert torch.equal(got, tntt.post_plain(tntt.mulmod_ntt(x, y), (K, steps)))
    monkeypatch.setenv("MPIR_FFT_NTT_FUSED", "0")
    with tntt.garner_post(M, K, steps) as cell:
        linked = tntt.mulmod_ntt(x, y)
    assert cell["consumed"] is True and len(calls) == 4       # 2 hooked, 2 unhooked
    assert torch.equal(got, linked)


# ---------------------------------------------------------------------------
# the slice end to end: L 4096 and L 8192 flagship plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,L", [(524200, 4096), (1048500, 8192)])
def test_flagship_tier2_matches_reference(monkeypatch, bits, L):
    """plan_for_depth(bits, bits, 3): depth 3, conv 32, L 4096 / 8192.  The
    port's mpn_mul_flagship and mpn_sqr_flagship equal the JAX flagship's
    digits at the same plan and Python's product; the pointwise goes
    through the 4-step tier, never through mulmod_fft."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    monkeypatch.delenv("MPIR_FFT_NTT_FUSED", raising=False)
    rnd = random.Random(bits)
    a = rnd.getrandbits(bits) | (1 << (bits - 1))
    b = rnd.getrandbits(bits) | (1 << (bits - 1))
    jp = j_plan_for_depth(bits, bits, 3, sqrt2=True)
    tp = plan_for_depth(bits, bits, 3, sqrt2=True)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.depth, tp.W // 16, tp.conv_len) == (3, L, 32)
    tier2, recursed = [], []
    real_4step = tntt._mulmod_4step
    monkeypatch.setattr(tntt, "_mulmod_4step",
                        lambda x, y: tier2.append(tuple(x.shape)) or real_4step(x, y))
    monkeypatch.setattr(tmm, "mulmod_fft", lambda *args: recursed.append(1))
    n = -(-bits // 16)
    da, db = digits_from_int(a, n), digits_from_int(b, n)
    got = tensor_to_digits(tmul.mpn_mul_flagship(digits_to_tensor(da, "cpu"),
                                                 digits_to_tensor(db, "cpu"), tp))
    got_sq = tensor_to_digits(tmul.mpn_sqr_flagship(digits_to_tensor(da, "cpu"), tp))
    assert tier2 == [(32, L), (32, L)] and not recursed
    assert int_from_digits(got) == a * b and int_from_digits(got_sq) == a * a
    jflag = jax.jit(functools.partial(jmul.mpn_mul_flagship, plan=jp))
    assert np.array_equal(got, np.asarray(jflag(jnp.asarray(da), jnp.asarray(db))))
    jsq = jax.jit(functools.partial(jmul.mpn_sqr_flagship, plan=jp))
    assert np.array_equal(got_sq, np.asarray(jsq(jnp.asarray(da))))
    assert tpw.base_serves(L) and tmm.inner_plan(16 * L) is None
    assert plan_from_reference(dataclasses.asdict(jp)) == tp
