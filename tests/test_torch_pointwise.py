"""Pointwise leaf of the port (ops/pointwise.py, ops/pointwise_fused.py,
ops/mulmod.py) against the JAX package under MPIR_FFT_NTT=0 -- the
schoolbook leaf the port serves -- and Python-int oracles.

The conv's plain version is held against the reference's Pallas schoolbook
kernel (mulmod_base_fused, interpret mode) after normmod.  Exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import pointwise as jpw
from mpir_fft_tpu.ops.limb import normmod as jnormmod
from mpir_fft_tpu.ops.pointwise_fused import mulmod_base_fused as j_mulmod_base_fused
from mpir_fft_tpu_torch.ops import pointwise as tpw
from mpir_fft_tpu_torch.ops.limb import int_from_digits, normmod
from mpir_fft_tpu_torch.ops.mulmod import MULMOD_BASE_MAX_BITS, mulmod
from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused


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


@pytest.mark.parametrize("B,L", [(4, 16), (3, 71)])
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


def test_base_serves_matches_reference(ntt_off):
    for L in (1, 64, 126, 2047, 2048, 2049, 4096):
        assert tpw.base_serves(L) == jpw.base_serves(L)


def test_mulmod_base_branch_and_limits(rng):
    L = 64
    N = 16 * L
    a, b = _rand(rng, (4, L)), _rand(rng, (4, L))
    got = mulmod(T(a), T(b), N, canonical=True).numpy()
    p = (1 << N) + 1
    for r in range(4):
        want = int_from_digits(a[r]) * int_from_digits(b[r]) % p
        assert int_from_digits(got[r]) % p == want
    wide = torch.zeros((1, 2049), dtype=torch.int32)           # 2L > 4096
    with pytest.raises(NotImplementedError, match="recursive"):
        mulmod(wide, wide, 16 * 2049)
    assert MULMOD_BASE_MAX_BITS == 131072


def test_conv_wrapper_rejects():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mulmod_base_fused(x, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        mulmod_base_fused(x[None], x[None])
    with pytest.raises(ValueError):
        mulmod_base_fused(x[:, ::2], x[:, ::2])              # not contiguous
