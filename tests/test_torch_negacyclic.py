"""The negacyclic weights riding the port's transforms (ops/negacyclic.py,
ops/transforms.py pre_half / post_half, ops/fused.py fused_transform's
options) on the CPU, where each wrapper takes its plain version.

Raw digits of the weighted whole-row transform against the two-launch plain
sequence it replaces, at the main path's inner-ring rows; the negacyclic
transforms against the old weighting (a twiddle_half pass beside the
transform); which wrappers each route calls; and whole_fits' admitted rows
over the planner's plans against the reference's rule.  Exact: integer
arithmetic."""

import numpy as np
import pytest
import torch

from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import negacyclic as tneg
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops.mulmod import inner_plan
from mpir_fft_tpu_torch.utils.params import choose_params


def _rand(rng, shape):
    return torch.from_numpy(rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32))


def _twiddle(x, e0, step, W):
    """x[..., j, :] * 2^((e0 + j*step)/2) through the plain row body."""
    L, h = x.shape[-1], x.shape[-2]
    e2 = torch.remainder(e0 + (torch.arange(x.numel() // L) % h) * step, 4 * W)[:, None]
    return tfused.twiddle_half_rows_plain(x.reshape(-1, L), e2, W).reshape(x.shape)


@pytest.mark.parametrize("e0,mult", [(0, 1), (5, -3)])
@pytest.mark.parametrize("B,C,L,w", [(3, 256, 48, 6), (3, 256, 64, 8)])
def test_weighted_transform_is_the_two_launch_sequence(rng, B, C, L, w, e0, mult):
    """fused_transform with pre_half (forward) / post_half (inverse): raw
    digits equal to twiddle_half_rows_plain then transform_plain, and
    transform_plain then twiddle_half_rows_plain, at the inner rows of the
    default plans at 1.2 and 1.5x10^9 bits (wp 6, 8); odd exponents at e0
    5."""
    W = 16 * L
    x = _rand(rng, (B, C, L))
    opt = (e0, mult * w)
    got = tfused.fused_transform("fwd", x, w, W, pre_half=opt)
    assert torch.equal(got, tfused.transform_plain("fwd", _twiddle(x, *opt, W), w, W))
    got = tfused.fused_transform("inv", x, w, W, post_half=opt)
    assert torch.equal(got, _twiddle(tfused.transform_plain("inv", x, w, W), *opt, W))
    with pytest.raises(ValueError):
        tfused.fused_transform("inv", x, w, W, pre_half=opt)
    with pytest.raises(ValueError):
        tfused.fused_transform("fwd", x, w, W, post_half=opt)


@pytest.mark.parametrize("shape,w", [((3, 256, 48), 6), ((2, 16, 13), 13), ((16, 12), 24)])
def test_negacyclic_equals_the_separate_weighting(rng, shape, w):
    """fft_negacyclic / ifft_negacyclic through the options: raw digits
    equal to the twiddle_half pass beside fft_radix2 / ifft_radix2 that they
    replace, on the whole route ((3, 256, 48), an L % 4 != 0 row) and on
    the ladder route (one ring, (16, 12))."""
    m, L = shape[-2], shape[-1]
    W = 16 * L
    x = _rand(rng, shape)
    e2 = np.arange(m, dtype=np.int64) * w
    f = tneg.fft_negacyclic(x, w, W)
    assert torch.equal(f, ttr.fft_radix2(tsqrt2.twiddle_half(x, e2, W), w, W))
    v = tneg.ifft_negacyclic(f, w, W)
    assert torch.equal(v, tsqrt2.twiddle_half(ttr.ifft_radix2(f, w, W), -e2, W))


def _spies(monkeypatch):
    """Record (wrapper, its half-bit exponents) for every kernel wrapper
    call the transforms make: fused_transform's pre_half / post_half, the
    ladder's pre_half, the twiddle's (e0, step)."""
    calls = []
    halves = {"fused_transform": lambda a, k: a[4] if a[4] is not None else a[5],
              "fused_butterfly_ladder": lambda a, k: k.get("pre_half"),
              "fused_twiddle_half": lambda a, k: tuple(a[1:3])}
    for name, half in halves.items():
        real = getattr(ttr, name)

        def spy(*a, _real=real, _name=name, _half=half, **k):
            calls.append((_name, _half(a, k)))
            return _real(*a, **k)

        monkeypatch.setattr(ttr, name, spy)
    return calls


def test_negacyclic_routes(rng, monkeypatch):
    """On the whole route a negacyclic transform is one fused_transform
    call carrying the weights and no fused_twiddle_half; on the ladder route
    (one ring: x.ndim == 2) the forward weights ride the first ladder group
    and the inverse unweights with one fused_twiddle_half after the
    ladder."""
    calls = _spies(monkeypatch)
    w, L = 24, 12
    W = 16 * L
    x = _rand(rng, (2, 16, L))
    f = tneg.fft_negacyclic(x, w, W)
    v = tneg.ifft_negacyclic(f, w, W)
    assert calls == [("fused_transform", (0, w)), ("fused_transform", (0, -w))]
    calls.clear()
    f = tneg.fft_negacyclic(x[0], w, W)
    groups = len(tfused.ladder_groups(16, L, "fwd"))
    assert calls == [("fused_butterfly_ladder", (0, w))] + [("fused_butterfly_ladder", None)] * (
        groups - 1)
    calls.clear()
    assert torch.equal(tneg.ifft_negacyclic(f, w, W), v[0])
    assert calls == [("fused_butterfly_ladder", None)] * groups + [("fused_twiddle_half", (0, -w))]


@pytest.mark.parametrize("ntt", [None, "0"])
def test_whole_fits_admits_the_reference_rows(ntt, monkeypatch):
    """whole_fits admits every (C, L) row the reference's whole-transform
    rule admits (mpir_fft_tpu/ops/fused.py whole_row_ok and MAX_FUSED_L, as
    ops/transforms.py _auto_fusable applies them) -- every candidate row of
    every plan the planner picks from 10^5 to 2x10^9 bits (balanced and
    3:1): the recursive pointwise's inner rings, the MFA rows and columns,
    the flat transforms -- and every row of at most 64 KB; a cluster of at
    most 8 CTAs holds each admitted row at any batch; (8192, 128) stays out."""
    from mpir_fft_tpu.ops import fused as jfused

    if ntt is None:
        monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    else:
        monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    rows = set()
    for bits in sorted({int(b) for b in np.logspace(5, np.log10(2e9), 40)}):
        for bits_b in (bits, bits // 3):
            plan = choose_params(bits, bits_b, sqrt2=True)
            L = plan.W // 16
            rows |= {(plan.conv_len, L), (plan.conv_len // 2, L), (plan.n1, L), (plan.n2, L)}
            inner = inner_plan(plan.W)
            while inner is not None:
                rows.add((inner.m, inner.Lp))
                inner = inner_plan(inner.Wp)
    rows |= {(256, 32), (128, 72), (256, 48), (256, 64), (64, 256), (8192, 128), (512, 80),
             (1024, 64), (1024, 128), (1024, 96), (128, 512), (128, 1024), (1024, 129)}
    for C, L in rows:
        ref = jfused.whole_row_ok(C, L) and L <= jfused.MAX_FUSED_L
        fits = tfused.whole_fits(C, L)
        assert fits == (ref or C * L * 4 <= tfused.WHOLE_BUF_BYTES), (C, L)
        if fits and C > 1:
            for B in (1, 2, 12, 4096):
                R = tfused.whole_cluster(B, C, L, 132)
                assert R in tfused.WHOLE_CLUSTERS and C % R == 0, (C, L, B, R)
                assert tfused.whole_smem_bytes(C, R, L) <= tfused.WHOLE_CTA_SMEM or R == 1
    for C, L in ((256, 32), (128, 72), (256, 48), (256, 64), (64, 256), (512, 80), (1024, 128),
                 (128, 1024)):
        assert tfused.whole_fits(C, L), (C, L)
    assert not tfused.whole_fits(8192, 128) and not tfused.whole_fits(1024, 129)
    assert not tfused.whole_fits(2048, 72) and not tfused.whole_fits(128, 2048)
