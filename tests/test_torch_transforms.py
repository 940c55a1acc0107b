"""Transforms of the port (ops/fused.py ladder, ops/transforms.py,
ops/sqrt2.py) against the JAX package on the same numpy inputs.

The ladder's plain version is held against the reference's Pallas ladder
kernel (fused_butterfly_ladder, interpret mode), fwd and inv; whole
transforms against the reference's transforms and a Python-int DFT.
Redundant digits are compared after normmod; exact (integer arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import fused as jfused
from mpir_fft_tpu.ops import sqrt2 as jsqrt2
from mpir_fft_tpu.ops import transforms as jtr
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops.limb import int_from_digits, normmod


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    """Canonical digits of torch or jax redundant digits (the port's normmod,
    held bit for bit to the reference's in test_torch_limb.py)."""
    return normmod(T(np.asarray(x))).numpy()


def _rand(rng, shape):
    return rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("shape,steps", [((2, 4, 8, 16), (4, 8)),
                                         ((1, 8, 2, 32), (3, 6, 12))])
def test_ladder_plain_matches_reference_kernel(rng, kind, shape, steps):
    W = 16 * shape[-1]
    x = _rand(rng, shape)
    got = tfused.fused_butterfly_ladder(kind, T(x), steps, W)   # CPU: plain version
    assert torch.equal(got, tfused.ladder_plain(kind, T(x), steps, W))
    want = jfused.fused_butterfly_ladder(kind, jnp.asarray(x), steps, W)
    assert np.array_equal(canon(got), canon(want))


def test_ladder_wrapper_rejects():
    x = torch.zeros((1, 4, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfused.fused_butterfly_ladder("fwd", x, (1,), 128)          # K != 2^len(steps)
    with pytest.raises(TypeError):
        tfused.fused_butterfly_ladder("fwd", x.long(), (1, 2), 128)
    with pytest.raises(ValueError):
        tfused.fused_butterfly_ladder("sideways", x, (1, 2), 128)


@pytest.mark.parametrize("C,L", [(8, 4), (64, 16), (256, 8), (32, 71)])
def test_fft_matches_reference(rng, C, L):
    W = 16 * L
    w = 2 * W // C if (2 * W) % C == 0 else 3
    x = _rand(rng, (2, C, L))
    f = ttr.fft_radix2(T(x), w, W)
    assert np.array_equal(canon(f), canon(jtr.fft_radix2(jnp.asarray(x), w, W)))
    i = ttr.ifft_radix2(f, w, W)
    assert np.array_equal(canon(i), canon(jtr.ifft_radix2(jnp.asarray(np.asarray(f)), w, W)))


@pytest.mark.parametrize("C,L", [(16, 4), (128, 8)])
def test_fft_roundtrip(rng, C, L):
    W = 16 * L
    w = 2 * W // C
    x = _rand(rng, (3, C, L))
    back = normmod(ttr.ifft_radix2(ttr.fft_radix2(T(x), w, W), w, W)).numpy()
    p = (1 << W) + 1
    for r in range(3):
        for j in range(C):
            assert int_from_digits(back[r, j]) % p == (C * int_from_digits(x[r, j])) % p


def test_fft_dft_oracle(rng):
    C, L = 8, 4
    W = 16 * L
    w = 2 * W // C
    p = (1 << W) + 1
    x = _rand(rng, (C, L))
    out = normmod(ttr.fft_radix2(T(x), w, W)).numpy()
    xv = [int_from_digits(x[i]) for i in range(C)]
    rev = ttr.revbin_vec(C)
    for j in range(C):
        want = sum(xv[i] * pow(2, w * i * int(rev[j]), p) for i in range(C)) % p
        assert int_from_digits(out[j]) % p == want


def test_ladder_groups_cover_every_stage():
    for C, L in [(16384, 512), (4096, 128), (8, 2048), (2, 16)]:
        D = C.bit_length() - 1
        fwd = ttr.ladder_groups(C, L, "fwd")
        inv = ttr.ladder_groups(C, L, "inv")
        assert [l for l, _ in fwd] == [sum(k for _, k in fwd[:i]) for i in range(len(fwd))]
        assert sum(k for _, k in fwd) == sum(k for _, k in inv) == D
        assert all(k <= tfused.ladder_stages(L) for _, k in fwd + inv)
        assert inv[0][0] + inv[0][1] == D and inv[-1][0] == 0
    assert tfused.ladder_stages(512) == 4 and tfused.ladder_stages(2048) == 3


@pytest.mark.parametrize("n,w", [(32, 4), (16, 16), (8, 142)])
def test_sqrt2_even_w_matches_reference_and_roundtrips(rng, n, w):
    W = n * w
    L = W // 16
    C4 = 4 * n
    x = _rand(rng, (2, C4, L))
    f = tsqrt2.fft_sqrt2(T(x), w, W)
    assert np.array_equal(canon(f), canon(jsqrt2.fft_sqrt2(jnp.asarray(x), w, W)))
    lg = C4.bit_length() - 1
    back = tsqrt2.ifft_sqrt2(f, w, W, norm_div=lg)
    assert torch.equal(back, normmod(T(x)))
    jback = jsqrt2.ifft_sqrt2(jnp.asarray(np.asarray(f)), w, W, norm_div=lg)
    assert np.array_equal(back.numpy(), np.asarray(jback))


def test_sqrt2_odd_w_not_ported():
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="fused_sqrt2_top"):
        tsqrt2.fft_sqrt2(x, 3, 64)
    with pytest.raises(NotImplementedError, match="fused_sqrt2_top"):
        tsqrt2.ifft_sqrt2(x, 3, 64, norm_div=3)
