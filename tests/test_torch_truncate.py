"""The port's truncated transforms (ops/truncate.py, the truncated sqrt2 pair
of ops/sqrt2.py) and the ladder's last-stage table against the JAX package
on the same numpy inputs.

Values are compared mod p after normmod, at positions < trunc only (the
reference leaves positions >= trunc unspecified, and the port's glue folds
its shifts differently there); all arithmetic is integer, so the tolerance
is exact.  The ladder table is held against the reference's Pallas kernel
in interpret mode (force_pallas).  The reference runs under jax.jit: one
compile per case costs less than its eager per-op dispatch."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.ops import fused as jfused
from mpir_fft_tpu.ops import sqrt2 as jsqrt2
from mpir_fft_tpu.ops import truncate as jtrunc
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu.ops.transforms import revbin_vec
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops import truncate as ttrunc
from mpir_fft_tpu_torch.ops.limb import normmod

# (n, w) of tests/test_truncate.py's rings: C = 2n, W = n w
RINGS = [(4, 4), (8, 16), (16, 13)]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    return normmod(T(np.asarray(x))).numpy()


def _rand(rng, shape):
    return rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32)


def _truncs(C):
    """trunc == 1, < h, h, h + 1 (> h), C - 1 and C."""
    return sorted({1, C // 2 - 1, C // 2, C // 2 + 1, C - 1, C} - {0})


def jref(fn, x, **static):
    """The reference function fn(x, **static) jitted, on a numpy input."""
    return np.asarray(jax.jit(functools.partial(fn, **static))(jnp.asarray(x)))


def _same_head(got, want, trunc):
    assert np.array_equal(canon(got)[..., :trunc, :], canon(want)[..., :trunc, :])


@pytest.mark.parametrize("kind", ["fft_trunc", "fft_trunc1", "ifft_trunc", "ifft_trunc1"])
@pytest.mark.parametrize("n,w", RINGS)
def test_truncated_match_reference(rng, kind, n, w):
    """Each function, with and without a post / pre exponent table, at every
    trunc class, on a stacked (2, C, L) input."""
    C, W = 2 * n, n * w
    L = W // 16
    pe = (revbin_vec(C) * 3 * w + np.arange(C) * 5) % (2 * W)
    for trunc in _truncs(C):
        x = _rand(rng, (2, C, L))
        if kind == "fft_trunc":
            x[:, trunc:] = 0
        for table in (None, pe):
            got = getattr(ttrunc, kind)(T(x), w, W, trunc,
                                        None if table is None else torch.from_numpy(table))
            want = jref(getattr(jtrunc, kind), x, w=w, W=W, trunc=trunc,
                        **({} if table is None else {"post_exps" if kind[0] == "f" else "pre_exps": table}))
            _same_head(got, want, trunc)
            if kind == "ifft_trunc1":
                assert torch.equal(got[..., trunc:, :], T(x[..., trunc:, :]))   # tail unchanged


@pytest.mark.parametrize("n,w", RINGS[:3])
def test_truncated_roundtrip(rng, n, w):
    """ifft_trunc(fft_trunc(x)) == C x on positions < trunc (zero tail), and
    with a table fused into both sides."""
    C, W = 2 * n, n * w
    L = W // 16
    pe = torch.from_numpy((revbin_vec(C) * 7 * w) % (2 * W))
    for trunc in _truncs(C):
        x = _rand(rng, (C, L))
        x[trunc:] = 0
        for table in (None, pe):
            y = ttrunc.fft_trunc(T(x), w, W, trunc, table)
            o = ttrunc.ifft_trunc(y, w, W, trunc, table)
            want = tfused.normmod_rows_plain(T(x), (C.bit_length() - 1), W)
            assert torch.equal(normmod(o)[:trunc], want[:trunc])


@pytest.mark.parametrize("n,w", [(16, 5), (16, 2), (32, 1)])
def test_trunc_sqrt2_match_reference(rng, n, w):
    """fft_trunc_sqrt2 / ifft_trunc_sqrt2 (odd w through the top layer in its
    k-row forms, even w through truncate.py) at trunc <= h, > h and == C."""
    C, W = 4 * n, n * w
    L = W // 16
    for trunc in sorted({3, C // 2, C // 2 + 3, C - 2, C}):
        x = _rand(rng, (2, C, L))
        x[:, trunc:] = 0
        f = tsqrt2.fft_trunc_sqrt2(T(x), w, W, trunc)
        _same_head(f, jref(jsqrt2.fft_trunc_sqrt2, x, w=w, W=W, trunc=trunc), trunc)
        v = _rand(rng, (2, C, L))
        o = tsqrt2.ifft_trunc_sqrt2(T(v), w, W, trunc)
        _same_head(o, jref(jsqrt2.ifft_trunc_sqrt2, v, w=w, W=W, trunc=trunc), trunc)
        back = tsqrt2.ifft_trunc_sqrt2(f, w, W, trunc)
        want = tfused.normmod_rows_plain(T(x), C.bit_length() - 1, W)
        assert torch.equal(normmod(back)[..., :trunc, :], want[..., :trunc, :])


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("N,K,L,step", [(6, 8, 16, 3), (4, 4, 71, 12), (3, 16, 32, 1), (2, 2, 64, 40)])
def test_ladder_pe_matches_reference_kernel(rng, kind, N, K, L, step):
    """ladder_plain with a last-stage table (h == 1) against the reference's
    fused_butterfly_ladder(..., pe) in interpret mode."""
    W = 16 * L
    k = K.bit_length() - 1
    steps = tuple(step << j for j in range(k))
    x = _rand(rng, (N, K, 1, L))
    pe = rng.integers(0, 2 * W, (N, K // 2, 2)).astype(np.int32)
    got = tfused.fused_butterfly_ladder(kind, T(x), steps, W, T(pe))
    with force_pallas(True):
        want = jfused.fused_butterfly_ladder(kind, jnp.asarray(x), steps, W, jnp.asarray(pe))
    assert np.array_equal(canon(got), canon(want))
    assert not torch.equal(got, tfused.ladder_plain(kind, T(x), steps, W))


@pytest.mark.parametrize("C,L,w", [(16, 16, 3), (8, 71, 5)])
def test_transform_tables_match_reference(rng, C, L, w):
    """fft_radix2(post_exps) / ifft_radix2(pre_exps): the table rides the
    ladder's last (first) group, broadcast over leading axes."""
    W = 16 * L
    x = _rand(rng, (2, 3, C, L))
    pe = rng.integers(0, 2 * W, (3, C)).astype(np.int64)
    got = ttr.fft_radix2(T(x), w, W, post_exps=torch.from_numpy(pe))
    assert np.array_equal(canon(got), canon(jref(jtrunc.fft_radix2, x, w=w, W=W, post_exps=pe)))
    back = ttr.ifft_radix2(got, w, W, pre_exps=torch.from_numpy(pe))
    want = jref(jtrunc.ifft_radix2, got.numpy(), w=w, W=W, pre_exps=pe)
    assert np.array_equal(canon(back), canon(want))
    assert torch.equal(normmod(back), tfused.normmod_rows_plain(T(x), C.bit_length() - 1, W))


def test_ladder_pe_rejects():
    x = torch.zeros((2, 4, 2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):       # a table needs h == 1
        tfused.fused_butterfly_ladder("fwd", x, (1, 2), 256, torch.zeros((2, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):       # wrong table shape
        tfused.fused_butterfly_ladder("fwd", x[:, :, :1].contiguous(), (1, 2), 256,
                                      torch.zeros((2, 3, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        tfused.fused_butterfly_ladder("fwd", x[:, :, :1].contiguous(), (1, 2), 256,
                                      torch.zeros((2, 2, 2), dtype=torch.int64))
