"""Multiplication mod p = 2^N + 1 with algorithm choice and recursion
(counterpart of mpir_fft_tpu/ops/mulmod.py; ref FFT_mulmod_2expp1
mul_fft.c:2998-3117, selector fft_mulmod_2expp1 mul_fft.c:3125-3167).

An N-bit Fermat-ring product splits each operand into m = 2^(depth+1)
coefficients of b = N/m bits; the product mod 2^N+1 is the NEGACYCLIC
convolution of the coefficient sequences (2^(mb) == 2^N == -1), computed by
weighted FFTs over an inner ring W' >= 2b + depth + 6 (ops/negacyclic.py).
The pointwise products mod 2^W'+1 recurse through mulmod(), so the
flagship's pointwise on rings the base leaf does not serve (inner_plan:
N > MULMOD_BASE_MAX_BITS, or not pointwise.base_serves(L)) runs this path
once over the whole coefficient batch.

Signs: negacyclic coefficients are signed.  The inner ring keeps headroom
(|c_j| < 2^(2b+depth+5) < p'/2), so a residue v_j lifts directly:
c_j = v_j - p' * [v_j > 2^(2b+depth+5)] (the reference's design note,
mpir_fft_tpu/ops/mulmod.py:14-24).

`mulmod_int` is the integer-level entry point, on "cuda" by default."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..kernels import span, spanned
from .fused import NORMMOD_LONG_MAX
from .limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod, normmod_div, shift_mod
from .negacyclic import fft_negacyclic, ifft_negacyclic
from .ntt import ntt_supported
from .pointwise import base_serves, mulmod_base
from .split import fft_combine_bits, fft_split_bits

# crossover in ring bits below which the direct base multiply beats a
# recursion level (the reference package's value; its role matches the
# reference's limbs < 250 delegation, mul_fft.c:3135-3139)
MULMOD_BASE_MAX_BITS = 131072

@dataclasses.dataclass(frozen=True)
class MulmodPlan:
    N: int          # outer ring bits
    depth: int      # m = 2^(depth+1) coefficients
    b: int          # bits per coefficient (m * b == N)
    Wp: int         # inner ring bits
    wp: int         # inner root exponent (Wp = 2^depth * wp)

    @property
    def m(self) -> int:
        return 1 << (self.depth + 1)

    @property
    def Lp(self) -> int:
        return self.Wp // DIGIT_BITS


def mulmod_plan(N: int, depth: int | None = None) -> MulmodPlan | None:
    """Derive (depth, b, W') for an N-bit Fermat product, scanning near the
    square-ish optimum (copied from mpir_fft_tpu/ops/mulmod.py:54-121, its
    pricing verbatim; ref mul_fft.c:3141-3162)."""
    assert N % DIGIT_BITS == 0
    v2 = (N & -N).bit_length() - 1
    d0 = depth if depth is not None else max(1, N.bit_length() // 2 - 3)
    best, best_cost = None, None
    for d in range(max(1, d0 - 3), d0 + 5):
        if d + 1 > v2:
            continue
        m = 1 << (d + 1)
        b = N // m
        if b < 1:
            continue
        npp = 1 << d
        g = (npp * DIGIT_BITS) // math.gcd(npp, DIGIT_BITS)
        # +6 bits of headroom: coefficients may come from redundant digit
        # vectors (|digit| <= ~2^17), whose values reach 2^(b+2)
        need = 2 * b + d + 6
        Wp = -(-need // g) * g
        # prefer an even inner root (negacyclic weights are then pure
        # shifts) when it costs <= one extra granule
        g2 = (2 * npp * DIGIT_BITS) // math.gcd(2 * npp, DIGIT_BITS)
        Wp_even = -(-need // g2) * g2
        if (Wp_even // npp) % 2 == 0 and Wp_even <= Wp + g:
            Wp = Wp_even
        plan = MulmodPlan(N, d, b, Wp, Wp // npp)
        Lp = plan.Lp
        fft_cost = 3 * m * Lp * (d + 1) * 3
        if Wp <= MULMOD_BASE_MAX_BITS and base_serves(Lp):
            pw_cost = m * (2 * Lp) ** 2 // 8
            if ntt_supported(Lp):
                pw_cost //= 10
        else:
            # another recursion level: a whole extra pipeline
            pw_cost = 64 * m * Lp * max(1, Wp.bit_length())
        cost = fft_cost + pw_cost
        if best_cost is None or cost < best_cost:
            best, best_cost = plan, cost
    return best


def _strip_minus1(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split off the canonical -1 form ([-1, 0, ...]): returns (x0, mask)
    with x == x0 - mask (as ring values), x0 canonical nonnegative."""
    mask = x[..., 0] < 0
    return torch.where(mask[..., None], 0, x), mask


@functools.lru_cache(maxsize=None)
def _bit_onehot(m: int, b: int, LN: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's (m, LN) one-hot matrix (row j: 2^(j*b mod 16) at digit
    (j*b)//16, for digits < LN) as its nonzeros: (rows j, digits, values)."""
    j = np.arange(m, dtype=np.int64)
    q, r = np.divmod(j * b, DIGIT_BITS)
    keep = q < LN
    return j[keep], q[keep], (1 << r[keep]).astype(np.int32)


def _flags_at_bits(flags: torch.Tensor, m: int, b: int, LN: int) -> torch.Tensor:
    """Digit vector [..., LN] of sum_j flags_j * 2^(j*b) (the reference's
    `gt @ onehot`, mulmod.py:196-197): digits of several j may coincide, so
    they add."""
    j, q, v = (torch.as_tensor(a, device=flags.device) for a in _bit_onehot(m, b, LN))
    out = torch.zeros(flags.shape[:-1] + (LN,), dtype=torch.int32, device=flags.device)
    return out.index_add_(flags.ndim - 1, q, flags[..., j].to(torch.int32) * v)


def _spread(flags: torch.Tensor, d: int) -> torch.Tensor:
    """Aligned coefficients (b = 16 d): flag j lands at digit j*d."""
    z = torch.zeros(flags.shape + (d - 1,), dtype=torch.int32, device=flags.device)
    out = torch.cat([flags[..., None].to(torch.int32), z], dim=-1)
    return out.reshape(flags.shape[:-1] + (flags.shape[-1] * d,))


def _greater_than_pow2(v: torch.Tensor, tbits: int) -> torch.Tensor:
    """Mask: canonical digit vector v (value in [-1, 2^W]) is > 2^tbits.
    The -1 form compares False (its lifted value is already -1)."""
    q, r = divmod(tbits, DIGIT_BITS)
    hi_any = (v[..., q + 1 :] > 0).any(dim=-1)
    lo_any = (v[..., :q] > 0).any(dim=-1)
    vq = v[..., q]
    return (vq > (1 << r)) | hi_any | ((vq == (1 << r)) & lo_any)


def mulmod_fft(x: torch.Tensor, y: torch.Tensor, plan: MulmodPlan) -> torch.Tensor:
    """(x * y) mod 2^N+1 by negacyclic FFT over the inner ring (ref
    FFT_mulmod_2expp1, mul_fft.c:2998-3117; mpir_fft_tpu/ops/mulmod.py:124-217).
    x, y: [..., LN] digit vectors, redundant (|digit| <= ~2^17) or canonical
    (the -1 residue as [-1, 0, ...]); returns canonical digits.  Its
    stages run inside the spans mf.split, mf.fwd (one of each an operand),
    mf.pw, mf.inv and mf.norm (kernels.span)."""
    N, m, b, Wp, wp = plan.N, plan.m, plan.b, plan.Wp, plan.wp
    LN = N // DIGIT_BITS
    if b % DIGIT_BITS == 0:
        # digit-aligned coefficients: splitting is a pure regrouping, valid
        # for any integer representative (redundant digits included), so no
        # input normalization and no -1-form strip
        x0, mx = x, None
        y0, my = y, None
    else:
        with span("split"):
            x0, mx = _strip_minus1(normmod(x))
            y0, my = _strip_minus1(normmod(y))

    def forward(v):
        with span("split"):
            rows = fft_split_bits(v, b, m, plan.Lp)
        with span("fwd"):
            return fft_negacyclic(rows, wp, Wp)

    fa = forward(x0)
    fb = forward(y0)
    with span("pw"):
        prod = mulmod(fa, fb, Wp)
    with span("inv"):
        c = ifft_negacyclic(prod, wp, Wp)
    del prod
    with span("norm"):
        # negacyclic_scale (divide by 2^(depth+1)) and normmod in one pass
        v = normmod_div(c, plan.depth + 1, Wp)

        # sign lift: c_j = v_j - p' * [v_j > T], T = 2^(2b + depth + 5)
        gt = _greater_than_pow2(v, 2 * b + plan.depth + 5)
        v0, mneg = _strip_minus1(v)   # -1 forms contribute -2^(jb) directly

        K = -(-(Wp + plan.depth + 4) // DIGIT_BITS)
        comb = fft_combine_bits(v0, b, LN + K)
        # ring fold: value == lo + hi * 2^N == lo - hi (mod p)
        lo, hi = comb[..., :LN], comb[..., LN:]
        folded = lo - torch.cat([hi, torch.zeros_like(lo[..., : LN - K])], dim=-1)

        if b % DIGIT_BITS == 0 and m * (b // DIGIT_BITS) == LN:
            corr_p = _spread(gt, b // DIGIT_BITS)
            corr_m = _spread(mneg, b // DIGIT_BITS)
        else:
            corr_p = _flags_at_bits(gt, m, b, LN)
            corr_m = _flags_at_bits(mneg, m, b, LN)
        folded = folded - corr_p - corr_m - shift_mod(corr_p, Wp, N)

        if mx is not None:
            # (x0 - mx)(y0 - my) = x0 y0 - mx y0 - my x0 + mx my
            folded = (folded - torch.where(mx[..., None], y0, 0)
                      - torch.where(my[..., None], x0, 0))
            folded[..., 0] += (mx & my).to(torch.int32)
        return normmod(folded)


def inner_plan(N: int, depth: int | None = None) -> MulmodPlan | None:
    """The recursion plan mulmod() takes for an N-bit ring, or None where
    the base leaf serves it: N <= MULMOD_BASE_MAX_BITS and
    pointwise.base_serves(N / 16) (the reference's selector,
    mpir_fft_tpu/ops/mulmod.py:232)."""
    if N <= MULMOD_BASE_MAX_BITS and base_serves(N // DIGIT_BITS):
        return None
    return mulmod_plan(N, depth)


@spanned("mulmod")
def mulmod(x: torch.Tensor, y: torch.Tensor, N: int, depth: int | None = None,
           canonical: bool = False) -> torch.Tensor:
    """(x * y) mod 2^N+1 with automatic algorithm choice (ref
    fft_mulmod_2expp1, mul_fft.c:3125-3167): the base leaf (NTT-CRT or
    schoolbook, ops/pointwise.py) where inner_plan is None, the recursive
    negacyclic FFT above.  Batched over leading dims of the [..., N/16]
    digit vectors.

    Inputs may be redundant (|digit| <= ~2^17) or canonical; with
    canonical=False the base path returns bounded redundant digits (the
    recursive path always returns canonical digits).  Each call runs inside
    the span mf.mulmod (kernels.span)."""
    L = N // DIGIT_BITS
    assert x.shape[-1] == y.shape[-1] == L
    plan = inner_plan(N, depth)
    if plan is None:
        return mulmod_base(x, y, canonical=canonical)
    return mulmod_fft(x, y, plan)


# below this ring width the host big-int product beats a device dispatch
# (the reference's _MULMOD_INT_SMALL_BITS, mulmod.py:246)
_MULMOD_INT_SMALL_BITS = 1 << 14


@spanned("mulmod_int")
def mulmod_int(a: int, b: int, N: int, depth: int | None = None, device="cuda") -> int:
    """(a * b) mod (2^N + 1) for Python ints on `device`: the user-level
    Fermat-ring product (ref fft_mulmod_2expp1, mul_fft.c:3125-3167;
    mpir_fft_tpu/ops/mulmod.py:251-283).

    Any integers (negative included) are reduced mod p first; the result is
    the canonical residue in [0, 2^N].  N at or below 2^14 bits, or not a
    multiple of 16, computes on the host.  On the card the final normmod is
    one row of N/16 digits, so N/16 may not pass NORMMOD_LONG_MAX (2^30
    digits: N = 2^34 bits, 4 GiB a row); such an N raises ValueError before
    any operand is converted.  Each call runs inside the span mf.mulmod_int,
    its steps inside mf.digits_from_int, mf.h2d (one of each an operand),
    mf.mulmod, mf.d2h and mf.int_from_digits (kernels.span)."""
    if N < 1:
        raise ValueError("N must be positive")
    if N // DIGIT_BITS > NORMMOD_LONG_MAX and torch.device(device).type != "cpu":
        raise ValueError(
            f"mulmod_int: N = {N} needs a normmod row of {N // DIGIT_BITS} digits; the card's "
            f"long-row kernel takes at most {NORMMOD_LONG_MAX} (its digit indices are C ints)")
    p = (1 << N) + 1
    a %= p
    b %= p
    if a == 0 or b == 0:
        return 0
    if N % DIGIT_BITS or N <= _MULMOD_INT_SMALL_BITS:
        return (a * b) % p
    L = N // DIGIT_BITS

    def digits(v):
        with span("digits_from_int"):
            d = torch.from_numpy(digits_from_int(v if v < (1 << N) else -1, L))
        with span("h2d"):
            return d.to(device)

    prod = mulmod(digits(a), digits(b), N, depth, canonical=True)
    with span("d2h"):
        host = prod.cpu().numpy()
    del prod
    with span("int_from_digits"):
        out = int_from_digits(host)
    return out if out >= 0 else out + p     # the -1 form is the residue 2^N
