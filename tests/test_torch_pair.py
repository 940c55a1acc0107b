"""The port's pair tier of the NTT-CRT pointwise (ops/ntt.py: MPIR_FFT_NTT_PAIR=1,
pair_input_planes, garner_pair_carry and their plain versions, _mulmod_pair)
against the JAX package and Python ints, on the CPU.

The host copies (PRIMES_PAIR, PAIR_MAX_M, pair_supported, the pair plane
blocks) must equal the reference's exactly.  The pair tier's raw digits
must equal the reference's _mulmod_ntt_pair digit for digit (the plain
Garner is its byte-chunk method), its canonical products the reference's
mulmod_ntt and the Python-int oracle.  Each plain link is also held against
a Python-int oracle of its own.  Everything is integer arithmetic: the
tolerance is exact."""

import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.ops import ntt as jntt
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops.limb import int_from_digits, normmod
from mpir_fft_tpu_torch.utils import prof_pointwise
from mpir_fft_tpu_torch.utils.params import choose_params
from mpir_fft_tpu_torch.utils.profile import pointwise_gemm_ops

DIGIT_BOUND = (1 << 16) + (1 << 12)     # the transforms' redundant-digit bound
PAIR_DIGITS = (1 << 10)                 # the pair tier's own: (-2^10, 2^16 + 2^10)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@pytest.fixture
def pair(monkeypatch):
    """MPIR_FFT_NTT_PAIR=1 for both packages (each reads it at call time)."""
    monkeypatch.setenv("MPIR_FFT_NTT_PAIR", "1")


def _value(d) -> int:
    return int_from_digits(np.asarray(d))


def _balanced(row: list[int]) -> list[int]:
    """The balanced carry pass of one row, in Python ints."""
    M = len(row)
    m = [(v + (1 << 15)) >> 16 for v in row]
    return [row[i] - (m[i] << 16) + (m[i - 1] if i else -m[M - 1]) for i in range(M)]


def _centered(v: int, p: int) -> int:
    r = v % p
    return r - p if r > p // 2 else r


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

def test_pair_constants_match_reference():
    assert tntt.PRIMES_PAIR == jntt.PRIMES_PAIR and tntt.PAIR_MAX_M == jntt.PAIR_MAX_M
    assert [tntt.pair_supported(M) for M in range(2, 4097)] == \
        [jntt.pair_supported(M) for M in range(2, 4097)]
    assert [M for M in range(2, 4097) if tntt.pair_supported(M)] == [8 << k for k in range(9)]
    P = math.prod(tntt.PRIMES_PAIR)
    assert all((p - 1) % (2 * tntt.PAIR_MAX_M) == 0 for p in tntt.PRIMES_PAIR)
    # the widest coefficient: Mp (balanced pair values)^2 < P / 2
    assert math.log2(P) > 74.8 and tntt.PAIR_MAX_M * ((2**15 + 2**9 + 1) * (2**16 + 1))**2 < P // 2
    assert set(tntt.MID_PLANES_PRIMES) == set(tntt.PRIMES) | set(tntt.PRIMES_PAIR)


@pytest.mark.parametrize("Mp", [4, 64, 1024])
def test_pair_matrices_match_reference(Mp):
    got = tntt._matrices_p(Mp, tntt.PRIMES_PAIR, 2)
    want = jntt._matrices_p(Mp, jntt.PRIMES_PAIR, 2)
    assert [m["p"] for m in got] == [m["p"] for m in want] == list(tntt.PRIMES_PAIR)
    for g, w in zip(got, want):
        assert g["k"] == w["k"] == 2
        assert np.array_equal(g["F"], w["F"]) and np.array_equal(g["G"], w["G"])
    blocks = tntt._pair_blocks(2 * Mp, torch.device("cpu"))
    for (p, F, G), m in zip(blocks, got):
        assert p == m["p"] and torch.equal(F, torch.from_numpy(m["F"]))
        assert F.stride() == (1, 2 * Mp)            # column-major, as _blocks


# ---------------------------------------------------------------------------
# the plain links against Python ints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,bound", [(3, 8, 1 << 17), (2, 64, 1 << 25), (1, 2048, 1 << 25)])
def test_pair_input_planes_plain_oracle(rng, B, M, bound):
    x = rng.integers(-bound, bound, (B, M)).astype(np.int32)
    got = tntt.pair_input_planes(T(x))                 # CPU: the plain version
    assert got.shape == (5, B, M) and got.dtype == torch.int8
    Mp = M // 2
    for r in range(B):
        xb = _balanced([int(v) for v in x[r]])
        for i, p in enumerate(tntt.PRIMES_PAIR):
            lo, hi = got[i, r, :Mp].tolist(), got[i, r, Mp:].tolist()
            want = [_centered(xb[2 * j] + (xb[2 * j + 1] << 16), p) for j in range(Mp)]
            assert [a + 256 * b for a, b in zip(lo, hi)] == want, (r, p)
            assert all(-128 <= a < 128 for a in lo)


def test_mixed_radix_and_chunks_oracle(rng):
    """Garner's digits recombine to the signed CRT value, and the byte
    chunks to the same value, every chunk sum below 2^17.1.  With the last
    digit centered the digits cover [-R (p_4 - 1)/2, R (p_4 + 1)/2), R =
    p_0 .. p_3: every |c| below 2^73.5, the tier's |c| < 2^72.04 among them."""
    primes = tntt.PRIMES_PAIR
    radix = [math.prod(primes[:j]) for j in range(len(primes))]
    R, p4 = radix[-1], primes[-1]
    lo, hi = -R * (p4 - 1) // 2, R * (p4 + 1) // 2 - 1
    assert min(-lo, hi) > 2**73.5
    vals = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, 200)] + \
        [lo, hi, 0, 1, -1, lo + 1, hi - 1, 1 << 72, -(1 << 72)]
    rs = [T([v % p for v in vals]) for p in primes]
    vs = tntt.mixed_radix(rs)
    assert all(0 <= int(v.min()) and int(v.max()) < p for v, p in zip(vs[:-1], primes))
    A = tntt.pair_chunk_sums(vs)
    assert all(a is None for a in A[10:]) and all(a is not None for a in A[:10])
    for k, v in enumerate(vals):
        assert sum(r * int(x[k]) for r, x in zip(radix, vs)) == v
        assert sum(int(a[k]) << (8 * m) for m, a in enumerate(A) if a is not None) == v
    assert max(int(a.abs().max()) for a in A if a is not None) < 2**17.1


@pytest.mark.parametrize("Mp", [4, 32])
def test_garner_pair_carry_plain_oracle(rng, Mp):
    """The five raw inverse sums -> digits whose value is the negacyclic
    sum of the CRT coefficients at 32-bit positions, inside (-2^10, 2^16 +
    2^10)."""
    primes = tntt.PRIMES_PAIR
    P = math.prod(primes)
    B, M = 3, 2 * Mp
    parts = [rng.integers(-(1 << 25), 1 << 25, (B, M)).astype(np.int32) for _ in primes]
    got = tntt.garner_pair_carry(*(T(s) for s in parts))    # CPU: the plain version
    assert got.shape == (B, M)
    assert -PAIR_DIGITS < int(got.min()) and int(got.max()) < (1 << 16) + PAIR_DIGITS
    ring = (1 << (16 * M)) + 1
    for r in range(B):
        c = []
        for j in range(Mp):
            res = [(int(s[r, j]) + 256 * int(s[r, Mp + j])) % p for s, p in zip(parts, primes)]
            v = sum(x * (P // p) * pow(P // p, -1, p) for x, p in zip(res, primes)) % P
            c.append(v - P if v > P // 2 else v)
        want = sum(cj << (32 * j) for j, cj in enumerate(c)) % ring
        assert _value(got[r].numpy()) % ring == want, r


@pytest.mark.parametrize("fill", [0xFFFF, -(1 << 25), (1 << 25) - 1])
def test_garner_pair_carry_extreme_sums(fill):
    """Constant raw sums at the GEMM's extremes: the digits stay inside the
    bound, and equal the reference's Garner on the same residues."""
    Mp = 1024
    parts = [torch.full((2, 2 * Mp), fill, dtype=torch.int32) for _ in tntt.PRIMES_PAIR]
    got = tntt.garner_pair_carry(*parts)
    assert -PAIR_DIGITS < int(got.min()) and int(got.max()) < (1 << 16) + PAIR_DIGITS
    rs = [jntt._fold_S(jnp.asarray(s.numpy()), p, 2, out="nonneg")
          for s, p in zip(parts, tntt.PRIMES_PAIR)]
    want = np.asarray(jntt.carry_pass(jntt._garner_pair_to_digits(rs, jntt.PRIMES_PAIR)))
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# mulmod_ntt under the pair tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bound", [1 << 17, 1 << 25])
@pytest.mark.parametrize("M", [8, 128, 512, 2048])
def test_mulmod_ntt_pair_matches_reference(rng, pair, M, bound):
    """Redundant digits in +-2^17 and +-2^25: raw digits identical to the
    reference's pair tier, canonical digits identical to its mulmod_ntt and
    to the Python-int oracle."""
    a = rng.integers(-bound, bound, (3, M)).astype(np.int32)
    b = rng.integers(-bound, bound, (3, M)).astype(np.int32)
    raw = tntt.mulmod_ntt(T(a), T(b))
    assert np.array_equal(raw.numpy(), np.asarray(jntt._mulmod_ntt_pair(jnp.asarray(a),
                                                                         jnp.asarray(b))))
    assert int(raw.abs().max()) < DIGIT_BOUND
    got = tntt.mulmod_ntt(T(a), T(b), canonical=True)
    assert torch.equal(got, normmod(raw))
    assert np.array_equal(got.numpy(), np.asarray(jntt.mulmod_ntt(jnp.asarray(a), jnp.asarray(b),
                                                                  canonical=True)))
    p = (1 << (16 * M)) + 1
    for r in range(3):
        assert _value(got[r].numpy()) == _value(a[r]) * _value(b[r]) % p, r


@pytest.mark.parametrize("M", [8, 2048])
def test_pair_output_bound_at_extreme_inputs(pair, M):
    """All-0xFFFF rows, the -1 residue's digits and +-2^25 rows: the
    output stays below the transforms' bound 2^16 + 2^12, and exact."""
    p = (1 << (16 * M)) + 1
    rows = [np.full(M, 0xFFFF), np.full(M, -(1 << 25)), np.full(M, (1 << 25) - 1),
            np.array([-1] + [0] * (M - 1)), np.tile([(1 << 25) - 1, -(1 << 25)], M // 2)]
    a = np.stack(rows).astype(np.int32)
    b = np.roll(a, 1, axis=0)
    got = tntt.mulmod_ntt(T(a), T(b))
    assert int(got.abs().max()) < DIGIT_BOUND
    sq = tntt.mulmod_ntt(T(a), T(a))
    for r in range(len(rows)):
        assert _value(got[r].numpy()) % p == _value(a[r]) * _value(b[r]) % p, r
        assert _value(sq[r].numpy()) % p == _value(a[r]) ** 2 % p, r


def test_pair_routing(monkeypatch):
    """With the variable unset every ring takes its tier as before; set, the
    pair tier takes exactly the pair_supported rings, and a square
    transforms once (one pair_input_planes call)."""
    calls = []
    for name in ("_mulmod_dense", "_mulmod_pair", "_mulmod_4step"):
        real = getattr(tntt, name)
        monkeypatch.setattr(tntt, name, lambda x, y, real=real, name=name:
                            calls.append(name) or real(x, y))
    planes = []
    real_planes = tntt.pair_input_planes
    monkeypatch.setattr(tntt, "pair_input_planes", lambda x: planes.append(1) or real_planes(x))
    x = torch.ones((2, 8), dtype=torch.int32)
    for env in (None, "0", "1"):
        if env is None:
            monkeypatch.delenv("MPIR_FFT_NTT_PAIR", raising=False)
        else:
            monkeypatch.setenv("MPIR_FFT_NTT_PAIR", env)
        calls.clear()
        for M in (4, 8, 2048):
            tntt.mulmod_ntt(torch.ones((2, M), dtype=torch.int32),
                            torch.ones((2, M), dtype=torch.int32))
        tier = "_mulmod_pair" if env == "1" else "_mulmod_dense"
        assert calls == ["_mulmod_dense", tier, tier], env
    planes.clear()
    tntt.mulmod_ntt(x, x)
    assert planes == [1]
    calls.clear()
    tntt.mulmod_ntt(torch.ones((1, 4096), dtype=torch.int32),
                    torch.ones((1, 4096), dtype=torch.int32))
    assert calls == ["_mulmod_4step"]


def test_pair_wrappers_reject():
    with pytest.raises(ValueError):
        tntt.pair_input_planes(torch.zeros((2, 4), dtype=torch.int32))       # Mp 2
    with pytest.raises(ValueError):
        tntt.pair_input_planes(torch.zeros((2, 4096), dtype=torch.int32))    # Mp 2048
    with pytest.raises(TypeError):
        tntt.pair_input_planes(torch.zeros((2, 16), dtype=torch.int64))
    s = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        tntt.garner_pair_carry(s, s, s)
    with pytest.raises(ValueError):
        tntt.garner_pair_carry(s, s, s, s, s[:1])
    with pytest.raises(ValueError):
        tntt.garner_pair_carry(*[torch.zeros((2, 4096), dtype=torch.int32)] * 5)
    for p in (65537, 12345):
        with pytest.raises(ValueError):
            tntt.mid_planes(s, s, p)


def test_gemm_ops_under_the_pair_tier(monkeypatch):
    """gemm_ops and the stage profile's pointwise_gemm_ops count five primes
    of three [B, M] @ [M, M] GEMMs under the tier: 2.4x fewer than dense."""
    B, M = 32768, 2048
    monkeypatch.delenv("MPIR_FFT_NTT_PAIR", raising=False)
    dense, four = tntt.gemm_ops(B, M), tntt.gemm_ops(B, 4096)
    plan = choose_params(10**9, 10**9, sqrt2=True)
    assert plan.W // 16 == M
    dense_pw = pointwise_gemm_ops(B, plan.W, True)
    monkeypatch.setenv("MPIR_FFT_NTT_PAIR", "1")
    assert tntt.gemm_ops(B, M) == 5 * 3 * 2 * B * M * M
    assert dense == 2.4 * tntt.gemm_ops(B, M)
    assert pointwise_gemm_ops(B, plan.W, True) * 2.4 == dense_pw
    assert tntt.gemm_ops(B, 4096) == four               # the 4-step tier's, unchanged


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

def _operands(bits):
    rnd = random.Random(bits)
    return rnd.getrandbits(bits) | (1 << (bits - 1)), rnd.getrandbits(bits) | 1


@pytest.mark.parametrize("bits,plan", [(27523, (8, 1, 16)), (28330, (6, 8, 32))],
                         ids=["odd-w", "even-w"])
def test_mul_under_pair_tier(monkeypatch, pair, bits, plan):
    """mul and sqr on the CPU with the variable set: the pair tier serves
    the pointwise (L 16 / 32) and the products equal Python's and the
    reference's mul."""
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    p = choose_params(bits, bits, sqrt2=True)
    assert (p.depth, p.w, p.W // 16) == plan and tntt.pair_supported(p.W // 16)
    seen = []
    real = tntt.garner_pair_carry
    monkeypatch.setattr(tntt, "garner_pair_carry", lambda *s: seen.append(1) or real(*s))
    a, b = _operands(bits)
    got = tmul.mul(a, b, device="cpu")
    assert seen and got == a * b == jmul.mul(a, b)
    assert tmul.sqr(a, device="cpu") == a * a


def test_staged_pair_leaves_the_hook(monkeypatch):
    """The staged flagship at a small plan: under the pair tier the
    garner_post hook is never consumed (the flagship runs its own inverse
    leg) and the product is exact; unset, the dense tier consumes it."""
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", 0)
    cells = []
    real = tmul.garner_post

    def spy(*args):
        ctx = real(*args)

        class Rec:
            def __enter__(self):
                cell = ctx.__enter__()
                cells.append(cell)
                return cell

            def __exit__(self, *exc):
                return ctx.__exit__(*exc)

        return Rec()

    monkeypatch.setattr(tmul, "garner_post", spy)
    bits = 28330
    plan = choose_params(bits, bits, sqrt2=True)
    assert tmul.flagship_is_staged(plan) and tntt.pair_supported(plan.W // 16)
    a, b = _operands(bits)
    monkeypatch.setenv("MPIR_FFT_NTT_PAIR", "1")
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(a, device="cpu") == a * a
    assert cells and not any(c["consumed"] for c in cells)
    cells.clear()
    monkeypatch.delenv("MPIR_FFT_NTT_PAIR")
    assert tmul.mul(a, b, device="cpu") == a * b
    assert cells and all(c["consumed"] for c in cells)


# ---------------------------------------------------------------------------
# utils/prof_pointwise.py on the CPU
# ---------------------------------------------------------------------------

def test_prof_pointwise_rows_on_cpu(monkeypatch):
    """The profiler's rows at a small shape, the pair split and the --ab4
    A/B at M 2048 among them; it leaves the variables and TIER1_MAX_M as it
    found them."""
    monkeypatch.delenv("MPIR_FFT_NTT_PAIR", raising=False)
    monkeypatch.delenv("MPIR_FFT_NTT_FUSED", raising=False)
    out = prof_pointwise.profile_pointwise(4, 16, 1, pair=True, device="cpu")
    for key in ("mulmod_ntt_full", "input_planes_x2", "fwd_gemms_x6", "mid_planes_x3",
                "inv_gemms_x3", "garner", "sum_parts_ms", "pair_full", "pair_input_planes_x2",
                "pair_fwd_gemms_x10", "pair_mid_planes_x5", "pair_inv_gemms_x5", "pair_garner",
                "pair_sum_parts_ms", "ab_pair_ms", "ab_dense_ms", "garner_bytes_share",
                "pair_fwd_gemms_x10_int8_ops_per_s"):
        assert out[key] > 0, key
    assert out["pair_garner_bytes"] == 24 * 4 * 16
    out = prof_pointwise.profile_pointwise(2, 2048, 1, ab4=True, device="cpu")
    assert out["mulmod_ntt_4step"] > 0
    env = __import__("os").environ
    assert tntt.TIER1_MAX_M == 2048 and "MPIR_FFT_NTT_PAIR" not in env
    assert "MPIR_FFT_NTT_FUSED" not in env
    with pytest.raises(ValueError):
        prof_pointwise.profile_pointwise(2, 4, 1, pair=True, device="cpu")
