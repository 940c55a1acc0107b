"""Length-4n transforms using sqrt(2) as the extra root (counterpart of
mpir_fft_tpu/ops/sqrt2.py; ref FFT_radix2_sqrt2 mul_fft.c:839-885,
IFFT_radix2_sqrt2 mul_fft.c:1488-1536).

With p = 2^W + 1, sqrt2 := 2^(3W/4) - 2^(W/4) satisfies sqrt2^2 == 2, so
q = sqrt2^w is a 4n-th root of unity (q^2 = z = 2^w).  Exponents of q are
half-integers, carried in HALF-BIT units (e2; the twiddle is 2^(e2/2)),
mod 4W; an odd half-exponent costs two shifts and a subtract,
x * 2^(k + 1/2) = x * 2^(k + 3W/4) - x * 2^(k + W/4) (mul_fft.c:591-634).

With w even the length-4n transform is the plain radix-2 transform with root
2^(w/2) (mul_fft.c:850-855).  With w odd only the top stage sees odd
half-exponents: the top layer (the reference's `_top_exps`,
`_sqrt2_top_fwd`, `_sqrt2_top_inv`, sqrt2.py:106-150) is one kernel pass
each way (ops/fused.py fused_sqrt2_top_fwd / fused_sqrt2_top_inv, which
build the q^j table j*w themselves), and the two half transforms at root
2^w run as ONE transform over the [..., 2, h, L] view, so the halves are
never copied apart or concatenated.

Spans (kernels.span) of the truncated pair, the flat and the MFA drivers
alike: mf.trunc.top around the odd-w top layer each way, mf.mfa.trunc
around each truncated inner transform (trunc_fn), and mf.trunc.rebuild
around the inverse's rebuild past trunc (the right inputs' twiddle_half
pass and their concatenation, then the left half's doubled rows with
their norm tail)."""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import span, spanned
from .fused import (fused_sqrt2_top_fwd, fused_sqrt2_top_inv, fused_twiddle_half,
                    twiddle_half_rows_plain)
from .limb import carry_pass, normmod_div
from .transforms import fft_radix2, ifft_radix2
from .truncate import _cat, truncated


def twiddle_half(x: torch.Tensor, e2, W: int) -> torch.Tensor:
    """x[..., j, :] * 2^(e2[j] / 2) mod p for a static half-bit exponent
    vector e2 (mod 4W).  An affine table (every table this package builds)
    runs as one twiddle_half kernel pass (fused_twiddle_half).  On a CPU
    tensor any other table takes the plain row body; on the card it raises,
    since the kernel takes only e0 + j*step."""
    e2 = np.asarray(e2, np.int64)
    if x.ndim < 2 or e2.ndim != 1 or e2.size != x.shape[-2] or e2.size == 0:
        raise ValueError((tuple(x.shape), e2.shape))
    step = int(e2[1] - e2[0]) if e2.size > 1 else 0
    if np.all(np.diff(e2) == step):
        return fused_twiddle_half(x.contiguous(), int(e2[0] % (4 * W)), step, W)
    if x.device.type != "cpu":
        raise ValueError("twiddle_half: the kernel takes affine tables only")
    return twiddle_half_rows_plain(x, torch.as_tensor(np.mod(e2, 4 * W))[:, None], W)


def fft_sqrt2(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] = 4n over the 4n-th root
    q = sqrt2^w.  Odd w: the top layer, then both halves as one radix-2
    transform at root 2^w (ref mul_fft.c:839-885)."""
    if w % 2 == 0:
        return fft_radix2(x, w // 2, W)
    C, L = x.shape[-2], x.shape[-1]
    top = fused_sqrt2_top_fwd(x.contiguous(), w, W)
    return fft_radix2(top.reshape(x.shape[:-2] + (2, C // 2, L)), w, W).reshape(x.shape)


def ifft_sqrt2(x: torch.Tensor, w: int, W: int, norm_div: int = 0,
               skip_inner: int = 0) -> torch.Tensor:
    """Inverse of fft_sqrt2 (times C).  norm_div > 0: divide the outputs by
    2^norm_div and canonicalize (the drivers' scale + normalize tail,
    mul_fft.c:3658-3662) -- fused into the top merge for odd w, one
    normmod_div pass for even w.  skip_inner: the innermost stages already
    ran chunk-locally (transforms.ifft_innermost at length C/2, root 2^w):
    the same stages in both w parities, since the even-w length-C
    transform's innermost stages at root 2^(w/2) equal the odd-w halves'
    (ref sqrt2.py:172-200)."""
    if w % 2 == 0:
        out = ifft_radix2(x, w // 2, W, skip_inner=skip_inner)
        return normmod_div(out, norm_div, W) if norm_div else out
    C, L = x.shape[-2], x.shape[-1]
    halves = ifft_radix2(x.reshape(x.shape[:-2] + (2, C // 2, L)), w, W, skip_inner=skip_inner)
    return fused_sqrt2_top_inv(halves.reshape(x.shape), w, W, norm_div=norm_div)


def _sqrt2_top_fwd(x: torch.Tensor, w: int, W: int):
    """Forward top layer on x [..., C, L] as its halves (s, t): s_j =
    carry(a_j + b_j), t_j = (a_j - b_j) q^j (ref sqrt2.py:119-131; with b
    zero past k, s_j = carry(a_j) there, equal mod p to the reference's
    a_j).  Sharded (ops/mfa.py), it runs on the whole halves on every
    rank: the inputs are there, and a rank's columns are not affine in
    the flat position j that q^j takes."""
    h = x.shape[-2] // 2
    top = fused_sqrt2_top_fwd(x.contiguous(), w, W)
    return top[..., :h, :], top[..., h:, :]


def _sqrt2_top_inv(sl: torch.Tensor, orr: torch.Tensor, w: int, W: int, norm_div: int = 0):
    """Inverse top merge on the first k positions (ref sqrt2.py:134-150):
    u = oR q^-j, xa = post(sL + u), xb = post(sL - u) for j < k = sl's rows,
    post = carry_pass or the norm_div tail; one kernel pass.  Sharded
    (ops/mfa.py), on the whole halves on every rank, after the gather."""
    k = sl.shape[-2]
    out = fused_sqrt2_top_inv(_cat(sl, orr), w, W, norm_div=norm_div)
    return out[..., :k, :], out[..., k:, :]


def _fft_trunc_sqrt2(x: torch.Tensor, w: int, W: int, trunc: int, full, trunc_fn) -> torch.Tensor:
    """Truncated length-4n forward transform over root sqrt2^w, zero input
    tail past trunc (ref FFT_radix2_truncate_sqrt2, mul_fft.c:1230-1288), on
    given inner transforms of a [..., m, L] array at root 2^v: full(y, v)
    the whole transform, trunc_fn(y, v, t, one) its truncation at t
    (fft_trunc, or fft_trunc1 with one).  The flat pair below and the MFA
    pair (ops/mfa.py) differ only in these.  Sharded, ops/mfa.py runs the
    same cases itself (_segments), so that both halves' rows cross in one
    all-to-all."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return fft_sqrt2(x, w, W)
    trunc_fn = spanned("mfa.trunc")(trunc_fn)
    if w % 2 == 0:
        return trunc_fn(x, w // 2, trunc, False)
    h = C // 2
    if trunc <= h:
        return _cat(trunc_fn(x[..., :h, :], w, trunc, False), x[..., h:, :])
    with span("trunc.top"):
        s, t = _sqrt2_top_fwd(x, w, W)
    return _cat(full(s, w), trunc_fn(t, w, trunc - h, True))


def _ifft_trunc_sqrt2(v: torch.Tensor, w: int, W: int, trunc: int, norm_div: int, full,
                      trunc_fn) -> torch.Tensor:
    """Inverse of _fft_trunc_sqrt2 (ref IFFT_radix2_truncate_sqrt2,
    mul_fft.c:1792-1859), zero coefficient tail: C * x on positions < trunc,
    the rest unspecified; full / trunc_fn the inverse inner transforms.
    norm_div > 0 folds the drivers' divide-by-2^norm_div + normmod tail into
    the last pass over each position (the top merge kernel for odd w, one
    normmod_div pass otherwise)."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return ifft_sqrt2(v, w, W, norm_div=norm_div)
    trunc_fn = spanned("mfa.trunc")(trunc_fn)

    def nd(x):
        return normmod_div(x, norm_div, W) if norm_div else x

    if w % 2 == 0:
        return nd(trunc_fn(v, w // 2, trunc, False))
    h = C // 2
    if trunc <= h:
        left = trunc_fn(v[..., :h, :], w, trunc, False)
        return _cat(nd(carry_pass(left + left)), v[..., h:, :])
    k = trunc - h
    sL = full(v[..., :h, :], w)
    # the missing right inputs t_j = s_j q^j, unscaled (ref mul_fft.c:2680-
    # 2691): the division by 2^lg(h) folds into the half-bit exponent, so the
    # reconstruction is one twiddle pass
    with span("trunc.rebuild"):
        tail = twiddle_half(sL[..., k:, :], np.arange(k, h, dtype=np.int64) * w
                            - 2 * (h.bit_length() - 1), W)
        vr = _cat(v[..., h:trunc, :], tail)
        del tail
    oR = trunc_fn(vr, w, k, True)
    del vr
    with span("trunc.top"):
        xa, xb = _sqrt2_top_inv(sL[..., :k, :], oR[..., :k, :], w, W, norm_div=norm_div)
    del oR
    with span("trunc.rebuild"):
        mid = nd(carry_pass(sL[..., k:, :] + sL[..., k:, :]))
    return _cat(xa, mid, xb, v[..., trunc:, :])


def fft_trunc_sqrt2(x: torch.Tensor, w: int, W: int, trunc: int) -> torch.Tensor:
    """Truncated length-4n forward transform, zero input tail past trunc,
    on flat radix-2 inner transforms."""
    return _fft_trunc_sqrt2(x, w, W, trunc, lambda y, v: fft_radix2(y, v, W),
                            lambda y, v, t, one: truncated("fwd", one)(y, v, W, t))


def ifft_trunc_sqrt2(v: torch.Tensor, w: int, W: int, trunc: int) -> torch.Tensor:
    """Inverse of fft_trunc_sqrt2: C * x on positions < trunc."""
    return _ifft_trunc_sqrt2(v, w, W, trunc, 0, lambda y, u: ifft_radix2(y, u, W),
                             lambda y, u, t, one: truncated("inv", one)(y, u, W, t))
