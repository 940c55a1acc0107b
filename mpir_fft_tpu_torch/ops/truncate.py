"""Truncated transforms (counterpart of mpir_fft_tpu/ops/truncate.py; ref
FFT_radix2_truncate / _truncate1 mul_fft.c:1028-1177, IFFT_radix2_truncate /
_truncate1 mul_fft.c:1538-1731, and their *_twiddle variants).

Contracts (m = transform length C; positions are the DIF output order):

  fft_trunc(x, trunc):    x[j] == 0 for j >= trunc.  y[j] == FFT(x)[j] for
                          j < trunc; y[j >= trunc] unspecified.
  fft_trunc1(x, trunc):   the same outputs, any input tail.
  ifft_trunc(v, trunc):   v[j] == FFT(x)[j] for j < trunc, x zero past trunc.
                          o[j] == m * x[j] for j < trunc; tail unspecified.
  ifft_trunc1(v, trunc):  v[j] == FFT(x)[j] for j < trunc, v[j] == x[j]
                          (unscaled) past it.  o[j] == m * x[j] for j < trunc,
                          the tail unchanged.

Each case is the reference's static slice / concat over [..., C, L]: every
full sub-transform goes through fft_radix2 / ifft_radix2 (a kernel launch on
the card), and the glue between them is torch ops (carry_pass, shift_mod,
the butterflies), as it is XLA ops in the reference.  The glue differs from
the reference's in one respect: every twiddle is ONE tensor-path shift_mod
(a power of two times another folds into one exponent, e.g. the tail's
div by 2^lg(h) and its z^j), so that the column kernel (csrc/mfa_cols.cu),
which runs this recursion on a shared-memory column, repeats it with one
shift routine and gets the same digits.

`post_exps` / `pre_exps` are per-position exponent tables [..., C] (leading
axes broadcast against x's) sliced along the recursion, as in the reference;
they apply only at transform-value positions."""

from __future__ import annotations

import torch

from ..kernels import count_copy
from .butterfly import butterfly_fwd, butterfly_inv
from .limb import carry_pass, shift_mod
from .transforms import fft_radix2, ifft_radix2


def _cat(*parts: torch.Tensor) -> torch.Tensor:
    """Concat along axis -2, dropping zero-length parts (none reaches a
    kernel: a CUDA grid of 0 is an invalid launch); a copy is counted."""
    parts = [p for p in parts if p.shape[-2] > 0]
    if len(parts) == 1:
        return parts[0]
    return count_copy(torch.cat(parts, dim=-2))


def _shift(x: torch.Tensor, e, W: int) -> torch.Tensor:
    """x[..., j, :] * 2^e[j] (e an int tensor over axis -2, or a scalar
    tensor): the tensor path of shift_mod, whatever the exponent."""
    return shift_mod(x, torch.remainder(torch.as_tensor(e, device=x.device), 2 * W)[..., None], W)


def _exps(lo: int, hi: int, w: int, device) -> torch.Tensor:
    """i * w for i in [lo, hi) (int64)."""
    return torch.arange(lo, hi, dtype=torch.int64, device=device) * w


def _slice_pe(pe, lo: int, hi: int):
    return None if pe is None else pe[..., lo:hi]


def _apply_pe(x: torch.Tensor, pe, W: int, inverse: bool = False) -> torch.Tensor:
    """Multiply (or divide) position j by 2^pe[j] (a recursion leaf's table)."""
    if pe is None:
        return x
    pe = torch.as_tensor(pe, device=x.device)
    return _shift(x, -pe if inverse else pe, W)


def _lg(n: int) -> int:
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def fft_trunc(x: torch.Tensor, w: int, W: int, trunc: int, post_exps=None) -> torch.Tensor:
    """Truncated forward FFT, zero input tail (ref truncate.py:92-114)."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return fft_radix2(x, w, W, post_exps=post_exps)
    h = C // 2
    if trunc <= h:
        # the top layer vanishes (b == 0): recurse on the left half
        left = fft_trunc(x[..., :h, :], 2 * w, W, trunc, _slice_pe(post_exps, 0, h))
        return _cat(left, x[..., h:, :])
    k = trunc - h
    a, b = x[..., :h, :], x[..., h:, :]
    # b[j] == 0 for j >= k: butterfly the first k pairs, twiddle the rest
    s = _cat(carry_pass(a[..., :k, :] + b[..., :k, :]), a[..., k:, :])
    d = _cat(a[..., :k, :] - b[..., :k, :], a[..., k:, :])
    t = _shift(d, _exps(0, h, w, x.device), W)
    left = fft_radix2(s, 2 * w, W, post_exps=_slice_pe(post_exps, 0, h))
    right = fft_trunc1(t, 2 * w, W, k, _slice_pe(post_exps, h, C))
    return _cat(left, right)


def fft_trunc1(x: torch.Tensor, w: int, W: int, trunc: int, post_exps=None) -> torch.Tensor:
    """Truncated forward FFT, any input tail (ref truncate.py:117-137)."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return fft_radix2(x, w, W, post_exps=post_exps)
    h = C // 2
    a, b = x[..., :h, :], x[..., h:, :]
    if trunc <= h:
        # only left outputs wanted: fold the halves and recurse
        left = fft_trunc1(carry_pass(a + b), 2 * w, W, trunc, _slice_pe(post_exps, 0, h))
        return _cat(left, b)
    s, t = butterfly_fwd(a, b, _exps(0, h, w, x.device)[..., None], W)
    left = fft_radix2(carry_pass(s), 2 * w, W, post_exps=_slice_pe(post_exps, 0, h))
    right = fft_trunc1(t, 2 * w, W, trunc - h, _slice_pe(post_exps, h, C))
    return _cat(left, right)


# ---------------------------------------------------------------------------
# Inverse
# ---------------------------------------------------------------------------

def ifft_trunc(v: torch.Tensor, w: int, W: int, trunc: int, pre_exps=None) -> torch.Tensor:
    """Truncated inverse FFT, zero coefficient tail (ref truncate.py:144-171)."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return ifft_radix2(v, w, W, pre_exps=pre_exps)
    h = C // 2
    if trunc <= h:
        # all x beyond h are zero, so s == x: recurse left, then double
        left = ifft_trunc(v[..., :h, :], 2 * w, W, trunc, _slice_pe(pre_exps, 0, h))
        return _cat(carry_pass(left + left), v[..., h:, :])
    k = trunc - h
    sL = ifft_radix2(v[..., :h, :], 2 * w, W, pre_exps=_slice_pe(pre_exps, 0, h))
    # the missing right inputs: for j >= k x_{j+h} == 0, so t_j = s_j z^j,
    # unscaled from h * s_j (one shift: z^j / 2^lg(h))
    tail = _shift(sL[..., k:, :], _exps(k, h, w, v.device) - _lg(h), W)
    vr = _cat(_apply_pe(v[..., h:trunc, :], _slice_pe(pre_exps, h, trunc), W, inverse=True), tail)
    oR = ifft_trunc1(vr, 2 * w, W, k)
    # cross inverse butterflies on the first k pairs; double the left tail
    xa, xb = butterfly_inv(sL[..., :k, :], oR[..., :k, :], _exps(0, k, w, v.device)[..., None], W)
    mid = carry_pass(sL[..., k:, :] + sL[..., k:, :])
    return _cat(carry_pass(xa), mid, carry_pass(xb), v[..., trunc:, :])


def ifft_trunc1(v: torch.Tensor, w: int, W: int, trunc: int, pre_exps=None) -> torch.Tensor:
    """Truncated inverse FFT, known unscaled coefficient tail (ref
    truncate.py:174-213)."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return ifft_radix2(v, w, W, pre_exps=pre_exps)
    h = C // 2
    lgC = _lg(C)
    if trunc <= h:
        # the tails of both halves are known: s_j = x_j + x_{j+h} for j in
        # [trunc, h); recurse left; m x_j = 2 (h s_j) - m x_{j+h}
        head = _apply_pe(v[..., :trunc, :], _slice_pe(pre_exps, 0, trunc), W, inverse=True)
        if trunc < h:
            s_tail = carry_pass(v[..., trunc:h, :] + v[..., h + trunc:, :])
            head = _cat(head, s_tail)
        oL = ifft_trunc1(head, 2 * w, W, trunc)
        two_hs = carry_pass(oL[..., :trunc, :] + oL[..., :trunc, :])
        mxh = _shift(v[..., h:h + trunc, :], torch.tensor(lgC), W)
        return _cat(carry_pass(two_hs - mxh), v[..., trunc:, :])
    k = trunc - h
    sL = ifft_radix2(v[..., :h, :], 2 * w, W, pre_exps=_slice_pe(pre_exps, 0, h))
    # the missing right inputs for j >= k: t_j = (s_j - 2 x_{j+h}) z^j with
    # x_{j+h} = v[j+h] known unscaled
    vt = v[..., trunc:, :]
    s_tail = _shift(sL[..., k:, :], torch.tensor(-_lg(h)), W)
    t_tail = _shift(carry_pass(s_tail - carry_pass(vt + vt)), _exps(k, h, w, v.device), W)
    vr = _cat(_apply_pe(v[..., h:trunc, :], _slice_pe(pre_exps, h, trunc), W, inverse=True), t_tail)
    oR = ifft_trunc1(vr, 2 * w, W, k)
    xa, xb = butterfly_inv(sL[..., :k, :], oR[..., :k, :], _exps(0, k, w, v.device)[..., None], W)
    # left tail j in [k, h): m x_j = 2 (h s_j) - m x_{j+h}
    two_hs = carry_pass(sL[..., k:, :] + sL[..., k:, :])
    mid = carry_pass(two_hs - _shift(vt, torch.tensor(lgC), W))
    return _cat(carry_pass(xa), mid, carry_pass(xb), vt)


def truncated(kind: str, no_zero_tail: bool):
    """The truncated transform of a kind ('fwd' / 'inv') and flavour: zero
    tail (fft_trunc / ifft_trunc) or known tail (fft_trunc1 / ifft_trunc1)."""
    return {("fwd", False): fft_trunc, ("fwd", True): fft_trunc1,
            ("inv", False): ifft_trunc, ("inv", True): ifft_trunc1}[(kind, no_zero_tail)]
