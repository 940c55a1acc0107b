"""The recursive Fermat mulmod of the port (ops/mulmod.py, ops/negacyclic.py)
against the JAX package under MPIR_FFT_NTT=0 (the schoolbook leaf the port
serves) and Python-int oracles.

Plans are pinned field for field; mulmod_fft digit for digit on canonical
outputs, for an aligned-b and an unaligned-b plan and the edge residues 0,
2^N - 1 and 2^N (the -1 form).  Exact: integer arithmetic."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import mulmod as jmm
from mpir_fft_tpu.ops import negacyclic as jneg
from mpir_fft_tpu_torch import mulmod_int
from mpir_fft_tpu_torch.ops import mulmod as tmm
from mpir_fft_tpu_torch.ops import negacyclic as tneg
from mpir_fft_tpu_torch.ops.limb import digits_from_int, int_from_digits, normmod


@pytest.fixture
def ntt_off(monkeypatch):
    monkeypatch.setenv("MPIR_FFT_NTT", "0")


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    return normmod(T(np.asarray(x))).numpy()


@pytest.mark.parametrize("N", [1024, 4096, 37504, 40960, 49152, 65536, 1 << 22])
def test_mulmod_plan_matches_reference(ntt_off, N):
    assert dataclasses.asdict(tmm.mulmod_plan(N)) == dataclasses.asdict(jmm.mulmod_plan(N))
    for depth in (2, 4):
        got, want = tmm.mulmod_plan(N, depth), jmm.mulmod_plan(N, depth)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tmm.MULMOD_BASE_MAX_BITS == jmm.MULMOD_BASE_MAX_BITS


@pytest.mark.parametrize("m,L,w", [(8, 4, 16), (16, 5, 5), (16, 12, 24), (32, 20, 20), (16, 13, 13)])
def test_negacyclic_matches_reference(rng, m, L, w):
    """On the whole route (the (2, m, L) batch): the weights ride the
    whole-row transform (pre_half / post_half); (16, 13, 13) is an
    L % 4 != 0 row with odd half-bit exponents."""
    W = 16 * L
    x = rng.integers(-(1 << 17), 1 << 17, (2, m, L)).astype(np.int32)
    f = tneg.fft_negacyclic(T(x), w, W)
    assert np.array_equal(canon(f), canon(jneg.fft_negacyclic(jnp.asarray(x), w, W)))
    v = tneg.ifft_negacyclic(f, w, W)
    jv = jneg.ifft_negacyclic(jnp.asarray(f.numpy()), w, W)
    assert np.array_equal(canon(v), canon(jv))
    s = tneg.negacyclic_scale(v, m.bit_length() - 1, W)
    assert np.array_equal(canon(s), canon(jneg.negacyclic_scale(jv, m.bit_length() - 1, W)))
    assert torch.equal(normmod(s), normmod(T(x)))          # ifft(fft(x)) / m == x


def _edge_operands(N, rows, seed):
    p = (1 << N) + 1
    rnd = random.Random(seed)
    vals = [0, (1 << N) - 1, 1 << N] + [rnd.randrange(p) for _ in range(rows - 3)]
    other = [rnd.randrange(p) for _ in range(rows - 1)] + [1 << N]
    return vals, other


def _digits(vals, N):
    L = N // 16
    return np.stack([digits_from_int(v if v < (1 << N) else -1, L) for v in vals])


@pytest.mark.parametrize("N,depth", [(4096, 3), (1040, None)])
def test_mulmod_fft_matches_reference(ntt_off, N, depth):
    """N 4096: b = 256 (aligned); N 1040: b = 65 (unaligned: normalized
    inputs, -1-form corrections, bit-offset flags)."""
    plan = tmm.mulmod_plan(N, depth)
    aligned = plan.b % 16 == 0
    assert aligned == (N == 4096)
    xs, ys = _edge_operands(N, 6, N)
    x, y = _digits(xs, N), _digits(ys, N)
    got = tmm.mulmod_fft(T(x), T(y), plan).numpy()
    want = np.asarray(jmm.mulmod_fft(jnp.asarray(x), jnp.asarray(y), jmm.mulmod_plan(N, depth)))
    assert np.array_equal(got, want)
    p = (1 << N) + 1
    for r, (a, b) in enumerate(zip(xs, ys)):
        assert int_from_digits(got[r]) % p == a * b % p


def test_mulmod_fft_takes_redundant_inputs(rng):
    """The flagship hands the aligned branch its redundant spectra."""
    N = 4096
    plan = tmm.mulmod_plan(N)
    x = rng.integers(-(1 << 17), 1 << 17, (3, N // 16)).astype(np.int32)
    y = rng.integers(-(1 << 17), 1 << 17, (3, N // 16)).astype(np.int32)
    got = tmm.mulmod_fft(T(x), T(y), plan).numpy()
    p = (1 << N) + 1
    for r in range(3):
        assert int_from_digits(got[r]) % p == int_from_digits(x[r]) * int_from_digits(y[r]) % p
    assert np.array_equal(got, canon(got))


@pytest.mark.parametrize("N", [1 << 15, 37504, 40960])
def test_mulmod_int_matches_python(N):
    p = (1 << N) + 1
    rnd = random.Random(N)
    a, b = rnd.getrandbits(N), rnd.getrandbits(N)
    assert mulmod_int(a, b, N, device="cpu") == a * b % p
    for x, y in ((p - 1, p - 1), (p - 1, b), ((1 << N) - 1, a), (-a, b), (a + 5 * p, b)):
        assert mulmod_int(x, y, N, device="cpu") == x * y % p


def test_mulmod_int_host_paths():
    for N in (100, 1 << 14, (1 << 15) + 3):          # small, or not a multiple of 16
        p = (1 << N) + 1
        assert mulmod_int(3 << (N - 3), 7, N, device="cpu") == (21 << (N - 3)) % p
    assert mulmod_int(0, 5, 1 << 15, device="cpu") == 0
    with pytest.raises(ValueError):
        mulmod_int(1, 1, 0, device="cpu")


def test_mulmod_int_refuses_rows_past_the_kernel(monkeypatch):
    """On the card the final normmod is one row of N/16 digits: an N whose
    row passes the long-row kernel's limit (2^30 digits) raises at call
    time, naming the limit, before any operand is reduced or converted; the
    limit is at least 2^28 digits (ring products up to N = 2^32)."""
    from mpir_fft_tpu_torch.ops.fused import NORMMOD_LONG_MAX

    assert NORMMOD_LONG_MAX >= 1 << 28

    def converted(*args, **kwargs):
        raise AssertionError("an operand was converted before the refusal")

    monkeypatch.setattr(tmm, "digits_from_int", converted)
    N = 16 * (NORMMOD_LONG_MAX + 1)
    with pytest.raises(ValueError, match=str(NORMMOD_LONG_MAX)):
        mulmod_int(3, 5, N, device="cuda")
    with pytest.raises(ValueError, match="long-row kernel"):
        mulmod_int(3, 5, N)
