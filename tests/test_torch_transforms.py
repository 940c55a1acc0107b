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


def _ladder_widths(plan):
    """(transform length, digit width) of every ladder route a plan can
    take: the flat transforms (conv_len, its sqrt2 halves), the MFA's rows
    and columns, and the recursive pointwise's inner transforms where they
    do not run whole."""
    from mpir_fft_tpu_torch.ops.mulmod import inner_plan

    L = plan.W // 16
    out = [(plan.conv_len, L), (plan.conv_len // 2, L), (plan.n1, L), (plan.n2, L)]
    inner = inner_plan(plan.W)
    while inner is not None:
        if not tfused.whole_fits(inner.m, inner.Lp):
            out.append((inner.m, inner.Lp))
        inner = inner_plan(inner.Wp)
    return out


@pytest.mark.parametrize("ntt", [None, "0"])
def test_ladder_blocks_fit_every_planned_plan(ntt, monkeypatch):
    """For every plan the planner picks from 10^5 to 4x10^9 bits (balanced
    and 3:1, MPIR_FFT_NTT unset and 0), every ladder group and the Garner
    post leg pass the wrappers' rule (ladder_fits) and their blocks
    (ladder_smem_bytes, the wrappers' host-side size) fit a Hopper block's
    227 KB, and inner_group is the first inverse ladder group, so the
    staged flagship's skipped stages line up."""
    from mpir_fft_tpu_torch.utils.params import choose_params

    if ntt is None:
        monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    else:
        monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    limit = 227 * 1024
    seen = set()
    for bits in sorted({int(b) for b in np.logspace(5, np.log10(4e9), 60)}):
        for bits_b in (bits, bits // 3):
            plan = choose_params(bits, bits_b, sqrt2=True)
            for C, L in _ladder_widths(plan):
                for _, kg in ttr.ladder_groups(C, L, "fwd") + ttr.ladder_groups(C, L, "inv"):
                    seen.add((1 << kg, L))
            L = plan.W // 16
            h = plan.conv_len // 2
            kg = ttr.inner_group(h, L)
            assert kg == ttr.ladder_groups(h, L, "inv")[0][1]
            seen.add((1 << kg, L))
    assert seen
    for K, L in seen:
        assert tfused.ladder_fits(K, L), (K, L)
        assert tfused.ladder_smem_bytes(K, L) <= limit


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


def test_sqrt2_odd_w_not_ported(rng):
    """Odd w, once refused, now runs the sqrt2 top layer: equal to the
    reference, and the inverse with its norm tail undoes the forward."""
    x = _rand(rng, (8, 4))
    f = tsqrt2.fft_sqrt2(T(x), 3, 64)
    assert np.array_equal(canon(f), canon(jsqrt2.fft_sqrt2(jnp.asarray(x), 3, 64)))
    back = tsqrt2.ifft_sqrt2(f, 3, 64, norm_div=3)
    assert torch.equal(back, normmod(T(x)))


@pytest.mark.parametrize("C,L,ws,c", [(8, 4, 16, 3), (64, 16, 8, 5), (16, 71, 3, 7),
                                      (2, 8, 5, 1), (256, 8, 1, 2)])
def test_fft_radix2_twiddle_matches_reference(rng, C, L, ws, c):
    """fft_radix2_twiddle / ifft_radix2_twiddle (the table on the ladder's
    pe option) equal the reference's after normmod, position j twiddled by
    2^(ws revbin(j) c) against a Python-int oracle, and the inverse undoes
    the forward times C."""
    W = 16 * L
    w = 2 * W // C if (2 * W) % C == 0 else 3
    x = _rand(rng, (2, C, L))
    f = ttr.fft_radix2_twiddle(T(x), w, W, ws, c)
    jf = jtr.fft_radix2_twiddle(jnp.asarray(x), w, W, ws, c)
    assert np.array_equal(canon(f), canon(jf))
    p = (1 << W) + 1
    base = canon(ttr.fft_radix2(T(x), w, W))
    rb = ttr.revbin_iota(C)
    assert torch.equal(rb, torch.from_numpy(np.array(jtr.revbin_iota(C))).long())
    got = canon(f)
    for r in range(2):
        for j in range(C):
            e = ws * int(rb[j]) * c % (2 * W)
            assert int_from_digits(got[r, j]) == int_from_digits(base[r, j]) * pow(2, e, p) % p
    i = ttr.ifft_radix2_twiddle(f, w, W, ws, c)
    assert np.array_equal(canon(i), canon(jtr.ifft_radix2_twiddle(jnp.asarray(np.asarray(f)),
                                                                  w, W, ws, c)))
    back = canon(i)
    for r in range(2):
        for j in range(C):
            assert int_from_digits(back[r, j]) == C * int_from_digits(x[r, j]) % p


@pytest.mark.parametrize("L", [4, 33])
def test_neg_digits(rng, L):
    """Ring negation equals the reference's and -x mod 2^W + 1."""
    from mpir_fft_tpu.ops.limb import neg_digits as jneg
    from mpir_fft_tpu_torch.ops.limb import neg_digits

    x = _rand(rng, (3, L))
    x[0] = 0
    got = neg_digits(T(x))
    assert np.array_equal(got.numpy(), np.asarray(jneg(jnp.asarray(x))))
    p = (1 << (16 * L)) + 1
    for r in range(3):
        assert int_from_digits(canon(got)[r]) == -int_from_digits(x[r]) % p
