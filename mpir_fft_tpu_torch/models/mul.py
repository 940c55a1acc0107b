"""Integer multiplication drivers (counterpart of mpir_fft_tpu/models/mul.py;
ref new_mpn_mul* mul_fft.c:3190-3668).

Every driver splits both operands into ring coefficients, forward-
transforms, pointwise-multiplies, inverse-transforms, scales by
2^-lg_conv and normalizes, and combines with carries.  They differ in the
transform pair (`DRIVERS`, the reference's six generations plus the
flagship):

  driver        transform pair                      ref
  radix2        fft_radix2 / ifft_radix2            (baseline)
  sqrt2         fft_sqrt2 / ifft_sqrt2              new_mpn_mul2, mul_fft.c:3267
  mfa           fft_radix2_mfa / ifft_radix2_mfa    new_mpn_mul3, mul_fft.c:3339
  trunc_sqrt2   fft_trunc_sqrt2 / ifft_trunc_sqrt2  new_mpn_mul4, mul_fft.c:3415
  trunc         fft_trunc / ifft_trunc              new_mpn_mul5, mul_fft.c:3494
  mfa_trunc     mfa_fft_trunc / mfa_ifft_trunc      new_mpn_mul,  mul_fft.c:3190
  flagship      mfa_fft_trunc_sqrt2 / mfa_ifft_trunc_sqrt2 with the recursive
                pointwise                           new_mpn_mul6, mul_fft.c:3573

The flagship truncates at plan.trunc_mfa: where it is below conv_len (an
unbalanced product: the reference's 9/16 rule rounds every balanced plan up
to the full length), the forward is the truncated MFA pair, the pointwise
runs on the first trunc_mfa rows only, and the inverse folds the divide +
normalize tail in; at the full length both transforms are the flat sqrt2
pair (odd w through the top layer kernels).  The pointwise (ops/mulmod.py
mulmod) takes the small-prime NTT-CRT for power-of-two rings L <= 8192, the
schoolbook for other L <= 2048 (and for all of them under MPIR_FFT_NTT=0),
and the recursive Fermat mulmod for the rest; the other drivers take the
leaf (`mulmod_base`) wherever it serves, as the reference's recursive=False.

Staging (`_staged_flagship`, the reference's models/mul.py:401-515): `mul`
and `sqr` send every flagship plan with conv_len * L > 2^24 elements
(`flagship_is_staged`: 10^8 bits and up) through the same math in stages,
as the reference does -- one operand's forward at a time (on balanced
full-length plans a zero-top forward: split only conv/2 rows, the s-leg a
plain transform, the t-leg's half-bit twiddle riding its first ladder
group), the pointwise on row chunks (`_pw_chunk_rows`) each followed by
its chunk-local first inverse leg (inside the Garner kernel where the NTT
serves the ring: ops/ntt.py garner_post), then the inverse without that
leg and with the norm tail folded in, and the combine.  The thresholds are
the reference's; `mpn_mul_flagship` / `mpn_sqr_flagship` stay the
unstaged drivers.

Out of core and in pieces (the reference's :257-273, :588-719): past 2^29
coefficient elements (`_HUGE_THRESHOLD_ELEMS`, the reference's) a flagship
plan that `huge_serves` runs in models/huge.py (`mul_huge` / `sqr_huge`:
packed 16-bit stores, chunked column and row passes); an extreme-uneven
one runs as balanced pieces (`_mul_piecewise`, b shipped once); the rest
raises ValueError at plan time.  `mul_many` runs a batch of pairs as one
driver call on (Bt, L) digit tensors at one shared plan.

Device data model: integers are canonical base-2^16 digit vectors (int32
tensors) on an explicit device; `mul` / `sqr` default to "cuda" and never
move work to the CPU unless asked to."""

from __future__ import annotations

import numpy as np
import torch

from mpir_fft_tpu_torch.models.huge import huge_serves, mul_huge, sqr_huge
from mpir_fft_tpu_torch.ops.limb import (DIGIT_BITS, Ring, digits_from_int, int_from_digits,
                                         normmod_div)
from mpir_fft_tpu_torch.ops.mfa import (fft_radix2_mfa, ifft_mfa_rows, ifft_radix2_mfa,
                                        mfa_fft_trunc, mfa_fft_trunc_sqrt2, mfa_ifft_trunc,
                                        mfa_ifft_trunc_sqrt2)
from mpir_fft_tpu_torch.ops.mulmod import mulmod
from mpir_fft_tpu_torch.ops.ntt import garner_post
from mpir_fft_tpu_torch.ops.pointwise import base_serves, mulmod_base
from mpir_fft_tpu_torch.ops.split import fft_combine_bits, fft_split_bits
from mpir_fft_tpu_torch.ops.sqrt2 import fft_sqrt2, fft_trunc_sqrt2, ifft_sqrt2, ifft_trunc_sqrt2
from mpir_fft_tpu_torch.ops.transforms import (fft_radix2, ifft_innermost, ifft_radix2,
                                               inner_group, inner_steps)
from mpir_fft_tpu_torch.ops.truncate import fft_trunc, ifft_trunc
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params

# below this many product bits the host big-int product wins (the reference
# likewise delegates below-crossover sizes to mpn_mul, mul_fft.c:3135-3139)
_SMALL_THRESHOLD_BITS = 1 << 14


def out_len_digits(plan: MulPlan) -> int:
    return cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2


def _pointwise(fa: torch.Tensor, fb: torch.Tensor, W: int, recursive: bool) -> torch.Tensor:
    """Pointwise product mod 2^W+1 over the whole coefficient batch (ref
    pointwise loop, mul_fft.c:3626-3654): redundant digits in, bounded
    redundant digits out.  recursive=True is mulmod's choice (the
    flagship); False takes the leaf wherever base_serves(L), as the
    reference's other drivers do (models/mul.py:61-74)."""
    if recursive or not base_serves(W // DIGIT_BITS):
        return mulmod(fa, fb, W)
    return mulmod_base(fa, fb, canonical=False)


def _finish(c: torch.Tensor, plan: MulPlan, valid: int, norm_done: bool = False) -> torch.Tensor:
    """Scale by 2^-lg_conv and canonicalize (unless the inverse already
    folded that tail in), then combine the first `valid` coefficients into
    the product's digits (ref FFT_combine_bits, mul_fft.c:3658-3665)."""
    if not norm_done:
        c = normmod_div(c, plan.lg_conv, plan.W)
    return fft_combine_bits(c[..., :valid, :], plan.bits1, out_len_digits(plan))


def _pad_rows(prod: torch.Tensor, C: int, axis: int = -2) -> torch.Tensor:
    """prod with zero rows appended along `axis` up to length C."""
    n = prod.shape[axis]
    if n == C:
        return prod
    shape = list(prod.shape)
    shape[axis] = C - n
    return torch.cat([prod, prod.new_zeros(shape)], dim=axis)


def _split2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan):
    L = Ring(plan.n, plan.w).L
    C = plan.conv_len
    return (
        fft_split_bits(a, plan.bits1, C, L),
        fft_split_bits(b, plan.bits1, C, L),
    )


def mpn_mul_radix2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Plain full-length cyclic FFT multiply."""
    assert not plan.sqrt2
    W = plan.W
    ia, ib = _split2(a, b, plan)
    prod = _pointwise(fft_radix2(ia, plan.w, W), fft_radix2(ib, plan.w, W), W, False)
    return _finish(ifft_radix2(prod, plan.w, W), plan, plan.conv_len)


def mpn_mul_sqrt2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Length-4n multiply through the sqrt2 transforms, no truncation."""
    assert plan.sqrt2
    W = plan.W
    ia, ib = _split2(a, b, plan)
    prod = _pointwise(fft_sqrt2(ia, plan.w, W), fft_sqrt2(ib, plan.w, W), W, False)
    return _finish(ifft_sqrt2(prod, plan.w, W), plan, plan.conv_len)


def mpn_mul_trunc(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Truncated 1-D multiply at plan.trunc."""
    assert not plan.sqrt2
    W, t = plan.W, plan.trunc
    ia, ib = _split2(a, b, plan)
    fa = fft_trunc(ia, plan.w, W, t)
    fb = fft_trunc(ib, plan.w, W, t)
    prod = _pad_rows(_pointwise(fa[..., :t, :], fb[..., :t, :], W, False), plan.conv_len)
    return _finish(ifft_trunc(prod, plan.w, W, t), plan, t)


def mpn_mul_trunc_sqrt2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Truncated length-4n multiply at plan.trunc."""
    assert plan.sqrt2
    W, t = plan.W, plan.trunc
    ia, ib = _split2(a, b, plan)
    fa = fft_trunc_sqrt2(ia, plan.w, W, t)
    fb = fft_trunc_sqrt2(ib, plan.w, W, t)
    prod = _pad_rows(_pointwise(fa[..., :t, :], fb[..., :t, :], W, False), plan.conv_len)
    return _finish(ifft_trunc_sqrt2(prod, plan.w, W, t), plan, t)


def _as_cells(c: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    return c.reshape(c.shape[:-2] + (plan.n2, plan.n1, c.shape[-1]))


def mpn_mul_mfa(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Cyclic multiply through the 2-D MFA transforms (n1 columns of n2)."""
    assert not plan.sqrt2
    C, W, n1, n2 = plan.conv_len, plan.W, plan.n1, plan.n2
    ia, ib = _split2(a, b, plan)
    fa = fft_radix2_mfa(_as_cells(ia, plan), plan.w, W, n1, n2)
    fb = fft_radix2_mfa(_as_cells(ib, plan), plan.w, W, n1, n2)
    c = ifft_radix2_mfa(_pointwise(fa, fb, W, False), plan.w, W, n1, n2)
    return _finish(c.reshape(c.shape[:-3] + (C, c.shape[-1])), plan, C)


def mpn_mul_mfa_trunc(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Truncated MFA multiply: trunc_mfa // n1 kept rows."""
    assert not plan.sqrt2
    C, W, n1, n2 = plan.conv_len, plan.W, plan.n1, plan.n2
    t = plan.trunc_mfa
    t2 = t // n1
    ia, ib = _split2(a, b, plan)
    fa = mfa_fft_trunc(_as_cells(ia, plan), plan.w, W, n1, n2, t2)
    fb = mfa_fft_trunc(_as_cells(ib, plan), plan.w, W, n1, n2, t2)
    prod = _pad_rows(_pointwise(fa[..., :t2, :, :], fb[..., :t2, :, :], W, False), n2, -3)
    c = mfa_ifft_trunc(prod, plan.w, W, n1, n2, t2)
    return _finish(c.reshape(c.shape[:-3] + (C, c.shape[-1])), plan, t)


def mpn_mul_flagship(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """The production multiply on digit tensors a [..., La], b [..., Lb]:
    truncated sqrt2 MFA transforms at t = plan.trunc_mfa (the flat sqrt2
    pair at t == conv_len), the pointwise on the first t rows.  Returns the
    canonical product digits [..., out_len_digits(plan)].  Coefficients past
    j1 + j2 - 1 are zero, so the combine takes only plan.trunc."""
    assert plan.sqrt2
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    ia, ib = _split2(a, b, plan)
    if ia.shape == ib.shape:
        # one transform over both stacked operands: double the batch per launch
        fab = mfa_fft_trunc_sqrt2(torch.stack([ia, ib]), plan.w, W, n1, t)
        fa, fb = fab[0], fab[1]
    else:
        fa = mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t)
        fb = mfa_fft_trunc_sqrt2(ib, plan.w, W, n1, t)
    prod = _pointwise(fa[..., :t, :], fb[..., :t, :], W, True)
    del fa, fb
    c = mfa_ifft_trunc_sqrt2(_pad_rows(prod, plan.conv_len), plan.w, W, n1, t,
                             norm_div=plan.lg_conv)
    return _finish(c, plan, plan.trunc, norm_done=True)


def mpn_sqr_flagship(a: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Squaring through the flagship pipeline: one forward transform,
    pointwise fa*fa."""
    assert plan.sqrt2
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    ia = fft_split_bits(a, plan.bits1, plan.conv_len, Ring(plan.n, plan.w).L)
    fh = mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t)[..., :t, :]
    c = mfa_ifft_trunc_sqrt2(_pad_rows(_pointwise(fh, fh, W, True), plan.conv_len),
                             plan.w, W, n1, t, norm_div=plan.lg_conv)
    return _finish(c, plan, plan.trunc, norm_done=True)


# ---------------------------------------------------------------------------
# Staged execution (the reference's models/mul.py:255-296, :401-515; its
# thresholds unchanged, so the same plans take the same path)
# ---------------------------------------------------------------------------

# above this many coefficient int32 elements, the flagship runs staged
_STAGED_THRESHOLD_ELEMS = 1 << 24

# bytes of spectrum rows per pointwise chunk (twice this where the leaf
# serves the ring): bounds the pointwise's working set
_PW_CHUNK_BYTES = 128 << 20


def flagship_is_staged(plan: MulPlan) -> bool:
    return plan.conv_len * (plan.W // DIGIT_BITS) > _STAGED_THRESHOLD_ELEMS


# ---------------------------------------------------------------------------
# Out-of-core and piecewise routing (the reference's models/mul.py:257-273,
# :557-612, :650-719 and models/huge.py:717-749): above 2^29 coefficient
# elements a flagship plan runs out of core (models/huge.py mul_huge /
# sqr_huge) or, for extreme imbalance, as balanced pieces
# (_mul_piecewise); the rest is refused before any work.  The threshold is
# the reference's, so every plan takes the same route in both packages.
# ---------------------------------------------------------------------------

# above this many coefficient int32 elements the staged pipeline's
# whole-spectrum buffers outgrow the reference's device memory
_HUGE_THRESHOLD_ELEMS = 1 << 29


def flagship_is_huge(plan: MulPlan) -> bool:
    return plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS and huge_serves(plan)


def _require_huge_servable(plan: MulPlan) -> None:
    """Raise ValueError, naming the violated constraints, for a plan past the
    out-of-core threshold that the out-of-core engine cannot serve."""
    if plan.conv_len * (plan.W // DIGIT_BITS) <= _HUGE_THRESHOLD_ELEMS or huge_serves(plan):
        return
    h = plan.conv_len // 2
    why = []
    if plan.j1 > h or plan.j2 > h:
        why.append(
            f"unbalanced operands: j1={plan.j1}, j2={plan.j2} must both be "
            f"<= conv_len/2 = {h} (pick a deeper plan or balance the inputs)")
    if plan.bits1 % DIGIT_BITS:
        why.append(f"bits1={plan.bits1} not digit-aligned")
    if plan.trunc_mfa % plan.n1:
        why.append(f"trunc_mfa={plan.trunc_mfa} not a multiple of n1={plan.n1}")
    raise ValueError(
        "plan exceeds the in-HBM staged pipeline's capacity "
        f"({plan.conv_len}x{plan.W // DIGIT_BITS} int32 elems > "
        f"{_HUGE_THRESHOLD_ELEMS}) but the out-of-core engine cannot serve "
        "it: " + "; ".join(why))


def _piecewise_serves(plan: MulPlan) -> bool:
    """Does the reference take this plan as balanced pieces: past the
    threshold, not out-of-core servable, and the cause is imbalance?"""
    h = plan.conv_len // 2
    return (plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS
            and not huge_serves(plan) and (plan.j1 > h or plan.j2 > h))


def _pw_chunk_rows(plan: MulPlan) -> int:
    """Rows per pointwise chunk (the reference's :493-503): max(256,
    bytes / 4L), at most trunc_mfa, rounded down to whole n1 groups (the
    row-IFFT leg's), at least n1."""
    L = plan.W // DIGIT_BITS
    pw_bytes = _PW_CHUNK_BYTES * (2 if base_serves(L) else 1)
    rows = min(max(256, pw_bytes // (4 * L)), plan.trunc_mfa)
    return max(plan.n1, (rows // plan.n1) * plan.n1)


def _inner_leg(plan: MulPlan):
    """The chunk-local first inverse leg run after each pointwise chunk (ref
    :282-296): at the full length the flat inverse's innermost ladder group
    (ifft_innermost at length conv/2), below it the MFA's row IFFTs;
    identical in both w parities."""
    W, n1 = plan.W, plan.n1
    if plan.trunc_mfa == plan.conv_len:
        return lambda v: ifft_innermost(v, plan.w, W, plan.conv_len // 2)
    row_w = plan.w * ((plan.conv_len // 2) // n1)
    return lambda v: ifft_mfa_rows(v, row_w, W, n1)


def _staged_flagship(plan: MulPlan):
    """The staged flagship of a plan as run(da, db=None) on digit tensors
    [La], [Lb] (db None: the square of da) -> the canonical product digits
    [out_len_digits(plan)] -- the reference's _staged_flagship (models/
    mul.py:401-515), unsharded."""
    assert plan.sqrt2
    L = plan.W // DIGIT_BITS
    C, W, n1, t = plan.conv_len, plan.W, plan.n1, plan.trunc_mfa
    h = C // 2
    inner = _inner_leg(plan)
    # balanced full-length plans split each operand into <= conv/2
    # coefficients, so the top half of the coefficient array is zero and the
    # sqrt2 top layer degenerates to s = a, t = a q^j (in both w parities:
    # the even-w flat DIF's first stage splits the same way)
    zerotop = t == C and max(plan.j1, plan.j2) <= h
    # the innermost inverse group at the full length, for the Garner kernel
    kg = inner_group(h, L)
    post_steps = inner_steps(plan.w, h, kg)
    rows = _pw_chunk_rows(plan)

    def fwd(d):
        if zerotop:
            ia = fft_split_bits(d, plan.bits1, h, L)
            # the t-leg's half-bit twiddle t_j = a_j q^j rides its first ladder group
            return torch.cat([fft_radix2(ia, plan.w, W),
                              fft_radix2(ia, plan.w, W, pre_half=(0, plan.w))], dim=-2)
        ia = fft_split_bits(d, plan.bits1, C, L)
        return mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t)

    def pw_inner(fa, fb):
        # the pointwise, then its chunk-local first inverse leg; at the full
        # length the leg rides inside the Garner kernel where the NTT serves
        # the ring, and runs here only if the hook was not consumed
        if t == C:
            with garner_post(L, 1 << kg, post_steps) as cell:
                prod = _pointwise(fa, fb, W, True)
            return prod if cell["consumed"] else inner(prod)
        return inner(_pointwise(fa, fb, W, True))

    def run(da, db=None):
        # one operand's forward at a time; the chunk products overwrite the
        # first spectrum's rows in place (the reference donates it); the
        # forwards hold conv_len rows, the chunks cover the first t
        fa = fwd(da)
        fb = fa if db is None else fwd(db)
        for i in range(0, t, rows):
            j = min(i + rows, t)
            ca = fa[i:j]
            fa[i:j] = pw_inner(ca, ca if db is None else fb[i:j])
        del fb
        if t < C:
            fa[t:] = 0
        c = mfa_ifft_trunc_sqrt2(fa, plan.w, W, n1, t, norm_div=plan.lg_conv, rows_done=True)
        del fa
        return fft_combine_bits(c[:t], plan.bits1, out_len_digits(plan))

    return run


DRIVERS = {
    "radix2": (mpn_mul_radix2, False),
    "sqrt2": (mpn_mul_sqrt2, True),
    "trunc": (mpn_mul_trunc, False),
    "trunc_sqrt2": (mpn_mul_trunc_sqrt2, True),
    "mfa": (mpn_mul_mfa, False),
    "mfa_trunc": (mpn_mul_mfa_trunc, False),
    "flagship": (mpn_mul_flagship, True),
}


def _select_plan(bits_a: int, bits_b: int, driver: str = "flagship") -> MulPlan:
    """The analytic plan of a driver.  (The reference's tune cache holds TPU
    measurements only, so the port does not read it.)"""
    return choose_params(bits_a, bits_b, sqrt2=DRIVERS[driver][1])


def _driver(kind: str, plan: MulPlan):
    """run(da, db) -> product digits: the driver of kind at plan, where a
    flagship plan takes mul()'s route -- out of core (flagship_is_huge),
    staged (flagship_is_staged) or whole -- and a plan the reference refuses
    raises ValueError here, before any operand is converted (the
    reference's _jitted_driver, models/mul.py:588-599)."""
    fn, needs_sqrt2 = DRIVERS[kind]
    assert plan.sqrt2 == needs_sqrt2, (kind, plan)
    if kind == "flagship":
        _require_huge_servable(plan)
        if flagship_is_huge(plan):
            return lambda da, db: mul_huge(da, db, plan)
        if flagship_is_staged(plan):
            return _staged_flagship(plan)
    return lambda da, db: fn(da, db, plan)


def _sqr_driver(plan: MulPlan):
    """run(da) -> the square's digits on sqr()'s route (the reference's
    _jitted_sqr, models/mul.py:603-612)."""
    _require_huge_servable(plan)
    if flagship_is_huge(plan):
        return lambda da: sqr_huge(da, plan)
    if flagship_is_staged(plan):
        return _staged_flagship(plan)
    return lambda da: mpn_sqr_flagship(da, plan)


def _mul_piecewise(a: int, b: int, driver: str, device) -> int:
    """Extreme-uneven products past the out-of-core threshold as balanced
    pieces (the reference's models/mul.py:665-702): the larger operand
    splits into pieces the size of the smaller, each piece's product runs
    through the driver's route, and the products accumulate in an int64
    base-2^16 digit window at their digit offsets (O(n) in all), followed
    by one vectorised carry.  Unlike the reference, `b` is converted and
    shipped to the device once, not once a piece, and each product's
    digits land in the accumulator shifted, without a round trip through a
    Python int."""
    ba, bb = a.bit_length(), b.bit_length()
    if ba < bb:
        a, b, ba, bb = b, a, bb, ba
    step = bb
    mask = (1 << step) - 1
    Lout = cdiv(ba + bb, DIGIT_BITS) + 2
    acc = np.zeros(Lout + 4, np.int64)
    db = digits_to_tensor(digits_from_int(b, cdiv(bb, DIGIT_BITS)), device)
    for lo in range(0, ba, step):
        piece = (a >> lo) & mask
        if not piece:
            continue
        bp = piece.bit_length()
        if bp + bb <= _SMALL_THRESHOLD_BITS:
            pd = digits_from_int(piece * b, cdiv(bp + bb, DIGIT_BITS))
        else:
            plan = _select_plan(bp, bb, driver)
            if driver == "flagship" and _piecewise_serves(plan):
                pv = mul(piece, b, driver, device)
                pd = digits_from_int(pv, cdiv(max(pv.bit_length(), 1), DIGIT_BITS))
            else:
                dp = digits_to_tensor(digits_from_int(piece, cdiv(bp, DIGIT_BITS)), device)
                pd = tensor_to_digits(_driver(driver, plan)(dp, db))
        q = lo // DIGIT_BITS
        acc[q:q + pd.shape[0]] += pd.astype(np.int64) << (lo % DIGIT_BITS)
    # every digit is a sum of shifted canonical digits (< 2^33): each
    # vectorised carry pass shrinks the largest, and the loop ends
    while True:
        c = acc >> DIGIT_BITS
        if not c.any():
            break
        acc = (acc - (c << DIGIT_BITS)) + np.concatenate([[0], c[:-1]])
    assert acc[Lout:].max(initial=0) == 0
    return int.from_bytes(acc[:Lout].astype("<u2").tobytes(), "little")


def mul(a: int, b: int, driver: str = "flagship", device="cuda") -> int:
    """Multiply two nonnegative Python ints through a driver of DRIVERS on
    `device`.  Small products are computed on the host.  A flagship plan
    past 2^29 elements runs out of core or, for extreme imbalance, as
    balanced pieces; one the reference refuses (`_require_huge_servable`)
    raises ValueError before any work."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {sorted(DRIVERS)}")
    if a < 0 or b < 0:
        raise ValueError("nonnegative operands only (mpn semantics)")
    if a == 0 or b == 0:
        return 0
    ba, bb = a.bit_length(), b.bit_length()
    if ba + bb <= _SMALL_THRESHOLD_BITS:
        return a * b
    plan = _select_plan(ba, bb, driver)
    if driver == "flagship" and _piecewise_serves(plan):
        return _mul_piecewise(a, b, driver, device)
    run = _driver(driver, plan)
    da = digits_to_tensor(digits_from_int(a, cdiv(ba, DIGIT_BITS)), device)
    db = digits_to_tensor(digits_from_int(b, cdiv(bb, DIGIT_BITS)), device)
    return int_from_digits(tensor_to_digits(run(da, db)))


def sqr(a: int, device="cuda") -> int:
    """Square a nonnegative Python int with one forward transform (out of
    core past 2^29 elements); a plan the reference refuses raises
    ValueError before any work."""
    if a < 0:
        raise ValueError("nonnegative operand only (mpn semantics)")
    if a == 0:
        return 0
    ba = a.bit_length()
    if 2 * ba <= _SMALL_THRESHOLD_BITS:
        return a * a
    run = _sqr_driver(_select_plan(ba, ba))
    da = digits_to_tensor(digits_from_int(a, cdiv(ba, DIGIT_BITS)), device)
    return int_from_digits(tensor_to_digits(run(da)))


def mul_many(pairs, driver: str = "flagship", device="cuda") -> list[int]:
    """Multiply many (a, b) pairs of nonnegative ints in ONE batched driver
    call (the reference's models/mul.py:615-647): every op of the pipeline
    takes leading dims, so k products share one chain of launches.

    All pairs share one plan sized for the largest operands; smaller
    operands are zero-padded (exact: padding only widens the ring).  Plans
    that run staged or out of core loop over `mul` instead: there one
    product already fills the card.  A batch of one, or products below the
    host threshold, compute on the host, as in the reference."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {sorted(DRIVERS)}")
    pairs = list(pairs)
    for a, b in pairs:
        if a < 0 or b < 0:
            raise ValueError("nonnegative operands only (mpn semantics)")
    if not pairs:
        return []
    ba = max(a.bit_length() for a, _ in pairs)
    bb = max(b.bit_length() for _, b in pairs)
    if ba == 0 or bb == 0 or ba + bb <= _SMALL_THRESHOLD_BITS or len(pairs) == 1:
        return [a * b for a, b in pairs]
    plan = _select_plan(ba, bb, driver)
    if driver == "flagship" and (flagship_is_huge(plan) or flagship_is_staged(plan)):
        return [mul(a, b, driver, device) for a, b in pairs]
    La, Lb = cdiv(ba, DIGIT_BITS), cdiv(bb, DIGIT_BITS)
    da = digits_to_tensor(np.stack([digits_from_int(a, La) for a, _ in pairs]), device)
    db = digits_to_tensor(np.stack([digits_from_int(b, Lb) for _, b in pairs]), device)
    out = tensor_to_digits(_driver(driver, plan)(da, db))
    return [int_from_digits(row) for row in out]
