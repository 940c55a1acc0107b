"""The odd-w sqrt2 slice of the port (ops/fused.py twiddle_half and sqrt2 top
plain versions, ops/sqrt2.py, the whole-transform dispatch of
ops/transforms.py) against the JAX package on the same numpy inputs.

The plain versions are held against the reference's Pallas kernels
(fused_twiddle_half, fused_sqrt2_top_fwd, fused_sqrt2_top_inv; interpret
mode on the CPU); the whole-transform dispatch against jtr.fft_radix2 under
force_pallas(True), which sends a 3-D input through fused_batched.
Redundant digits are compared after normmod, canonical ones as they are;
all arithmetic is integer, so the tolerance is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import fused as jfused
from mpir_fft_tpu.ops import sqrt2 as jsqrt2
from mpir_fft_tpu.ops import transforms as jtr
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops.limb import int_from_digits, normmod


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    return normmod(T(np.asarray(x))).numpy()


def _rand(rng, shape):
    return rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32)


@pytest.mark.parametrize("L,e0,step", [(16, 0, 3), (16, 5, 4), (71, 1, 7), (71, 0, 2),
                                       (64, 3, -5)])
def test_twiddle_half_plain_matches_reference_kernel(rng, L, e0, step):
    W = 16 * L
    h = 6
    x = _rand(rng, (2, h, L))
    got = tfused.fused_twiddle_half(T(x), e0, step, W)      # CPU: the plain version
    want = jfused.fused_twiddle_half(jnp.asarray(x), e0, step, W, h)
    assert np.array_equal(canon(got), canon(want))
    p = (1 << W) + 1
    for r in range(h):
        e2 = (e0 + r * step) % (4 * W)
        root = pow(2, e2 // 2, p) * (pow(2, 3 * W // 4, p) - pow(2, W // 4, p)) ** (e2 % 2)
        assert int_from_digits(got[1, r].numpy()) % p == int_from_digits(x[1, r]) * root % p


@pytest.mark.parametrize("L", [16, 70])
@pytest.mark.parametrize("table", ["alternating", "all_odd", "mixed"])
def test_twiddle_half_tables_match_reference(rng, L, table):
    """Non-affine tables: the plain row body on the CPU."""
    W = 16 * L
    C = 8
    e2 = {"alternating": np.array([0, 5, 8, 3, 2, 9, 4, 1]) * 3,
          "all_odd": np.array([1, 7, 3, 5, 9, 11, 13, 31]),
          "mixed": np.array([1, 2, 2, 7, 0, 3, 4, 4])}[table]
    x = _rand(rng, (3, C, L))
    got = tsqrt2.twiddle_half(T(x), e2, W)
    want = jsqrt2.twiddle_half(jnp.asarray(x), e2, W)
    assert np.array_equal(canon(got), canon(want))


def test_twiddle_half_non_affine_table_off_cpu_raises():
    """The kernel takes e0 + j*step only: off the CPU another table raises
    rather than running the plain torch ops."""
    x = torch.zeros((2, 4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="affine"):
        tsqrt2.twiddle_half(x, np.array([1, 2, 2, 7]), 256)
    with pytest.raises(ValueError):
        tsqrt2.twiddle_half(torch.zeros((2, 4, 16), dtype=torch.int32), np.arange(3), 256)


@pytest.mark.parametrize("h,L,w", [(4, 16, 1), (8, 71, 3), (2, 64, 157)])
def test_sqrt2_top_plain_matches_reference_kernels(rng, h, L, w):
    W = 16 * L
    x = _rand(rng, (2, 2 * h, L))
    got = tfused.fused_sqrt2_top_fwd(T(x), w, W)
    s, t = jfused.fused_sqrt2_top_fwd(jnp.asarray(x[:, :h]), jnp.asarray(x[:, h:]), w, W)
    assert np.array_equal(canon(got), canon(np.concatenate([s, t], axis=1)))
    for nd in (0, 5):
        got = tfused.fused_sqrt2_top_inv(T(x), w, W, norm_div=nd)
        xa, xb = jfused.fused_sqrt2_top_inv(jnp.asarray(x[:, :h]), jnp.asarray(x[:, h:]), h, w, W,
                                            norm_div=nd)
        want = np.concatenate([xa, xb], axis=1)
        if nd:
            assert np.array_equal(got.numpy(), want)       # canonical: bit for bit
        else:
            assert np.array_equal(canon(got), canon(want))


@pytest.mark.parametrize("n,w", [(16, 3), (32, 7), (16, 157), (64, 1)])
def test_sqrt2_odd_w_matches_reference_and_roundtrips(rng, n, w):
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
    raw = tsqrt2.ifft_sqrt2(f, w, W)
    assert np.array_equal(canon(raw), canon(jsqrt2.ifft_sqrt2(jnp.asarray(np.asarray(f)), w, W)))


@pytest.mark.parametrize("B,C,L,w", [(3, 32, 16, 1), (2, 16, 71, 3)])
def test_whole_transform_dispatch_matches_reference_kernel(rng, monkeypatch, B, C, L, w):
    W = 16 * L
    calls = []
    orig = ttr.fused_transform

    def spy(kind, x, w_, W_, pre_half=None, post_half=None):
        calls.append((kind, tuple(x.shape)))
        return orig(kind, x, w_, W_, pre_half, post_half)

    monkeypatch.setattr(ttr, "fused_transform", spy)
    x = _rand(rng, (B, C, L))
    f = ttr.fft_radix2(T(x), w, W)
    with force_pallas(True):
        jf = jtr.fft_radix2(jnp.asarray(x), w, W)
        ji = jtr.ifft_radix2(jnp.asarray(np.asarray(f)), w, W)
    assert np.array_equal(canon(f), canon(jf))
    i = ttr.ifft_radix2(f, w, W)
    assert np.array_equal(canon(i), canon(ji))
    assert calls == [("fwd", (B, C, L)), ("inv", (B, C, L))]
    assert torch.equal(f, tfused.transform_plain("fwd", T(x), w, W))


def test_whole_transform_limits():
    assert tfused.whole_fits(128, 72) and tfused.whole_fits(256, 32) and tfused.whole_fits(64, 84)
    assert not tfused.whole_fits(8192, 128)           # outer flagship rows stay on the ladder
    with pytest.raises(ValueError):
        tfused.fused_transform("fwd", torch.zeros((2, 3, 4), dtype=torch.int32), 1, 64)
    with pytest.raises(ValueError):
        tfused.fused_sqrt2_top_fwd(torch.zeros((2, 3, 4), dtype=torch.int32), 1, 64)
    with pytest.raises(ValueError):
        tfused.fused_twiddle_half(torch.zeros((4,), dtype=torch.int32), 0, 1, 64)
