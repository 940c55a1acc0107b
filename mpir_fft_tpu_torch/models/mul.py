"""Integer multiplication drivers (counterpart of mpir_fft_tpu/models/mul.py;
ref new_mpn_mul6, mul_fft.c:3573-3668).

The flagship skeleton: split both operands into ring coefficients,
forward-transform (both stacked in one transform), pointwise-multiply,
inverse-transform with the divide-by-2^lg_conv + normalize tail, combine
with carries.

Every plan runs the full-length flat transform pair, odd w through the
sqrt2 top layer.  The pointwise (ops/mulmod.py mulmod) takes the
small-prime NTT-CRT for power-of-two rings L <= 8192 (the dense tier up to
2048, where the reference's default plans put every size from ~7.6x10^5
to ~10^9 bits; the 4-step tier above, e.g. L 4096 at 2x10^9 bits), the
schoolbook for other L <= 2048 (and for all of them under
MPIR_FFT_NTT=0), and the recursive Fermat mulmod for the rest.  A full
convolution is exact for every valid plan (`validate` requires
j1 + j2 - 1 <= conv_len), so truncation and the MFA only save work; they
are not ported yet.  The staged driver (`_staged_flagship`,
mpir_fft_tpu/models/mul.py:402) is not needed here: 80 GB of device memory
holds the 10^9-bit spectra unstaged (16.6 GiB peak on an NVIDIA H100 80GB
HBM3 at 700 W, chip_smoke.py).

Device data model: integers are canonical base-2^16 digit vectors (int32
tensors) on an explicit device; `mul` / `sqr` default to "cuda" and never
move work to the CPU unless asked to."""

from __future__ import annotations

import torch

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, Ring, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.ops.mulmod import mulmod
from mpir_fft_tpu_torch.ops.split import fft_combine_bits, fft_split_bits
from mpir_fft_tpu_torch.ops.sqrt2 import fft_sqrt2, ifft_sqrt2
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params

# below this many product bits the host big-int product wins (the reference
# likewise delegates below-crossover sizes to mpn_mul, mul_fft.c:3135-3139)
_SMALL_THRESHOLD_BITS = 1 << 14


def out_len_digits(plan: MulPlan) -> int:
    return cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2


def _pointwise(fa: torch.Tensor, fb: torch.Tensor, W: int) -> torch.Tensor:
    """Pointwise product mod 2^W+1 over the whole coefficient batch (ref
    pointwise loop, mul_fft.c:3626-3654): redundant digits in, bounded
    redundant digits out, no normalization."""
    return mulmod(fa, fb, W)


def _finish(c: torch.Tensor, plan: MulPlan, valid: int) -> torch.Tensor:
    """Combine the first `valid` coefficients (canonical: the inverse
    already ran the scale + normalize tail) into the product's digits
    (ref FFT_combine_bits, mul_fft.c:3658-3665)."""
    return fft_combine_bits(c[..., :valid, :], plan.bits1, out_len_digits(plan))


def _split2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan):
    L = Ring(plan.n, plan.w).L
    C = plan.conv_len
    return (
        fft_split_bits(a, plan.bits1, C, L),
        fft_split_bits(b, plan.bits1, C, L),
    )


def mpn_mul_flagship(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """The production multiply on digit tensors a [..., La], b [..., Lb]:
    full-length sqrt2 transforms, pointwise through mulmod.  Returns the
    canonical product digits [..., out_len_digits(plan)].  Coefficients
    past j1 + j2 - 1 are zero, so the combine takes only plan.trunc."""
    assert plan.sqrt2
    W = plan.W
    ia, ib = _split2(a, b, plan)
    if ia.shape == ib.shape:
        # one transform over both stacked operands: double the batch per launch
        fab = fft_sqrt2(torch.stack([ia, ib]), plan.w, W)
        fa, fb = fab[0], fab[1]
    else:
        fa = fft_sqrt2(ia, plan.w, W)
        fb = fft_sqrt2(ib, plan.w, W)
    prod = _pointwise(fa, fb, W)
    c = ifft_sqrt2(prod, plan.w, W, norm_div=plan.lg_conv)
    return _finish(c, plan, plan.trunc)


def mpn_sqr_flagship(a: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Squaring through the flagship pipeline: one forward transform,
    pointwise fa*fa."""
    assert plan.sqrt2
    W = plan.W
    ia = fft_split_bits(a, plan.bits1, plan.conv_len, Ring(plan.n, plan.w).L)
    fh = fft_sqrt2(ia, plan.w, W)
    c = ifft_sqrt2(_pointwise(fh, fh, W), plan.w, W, norm_div=plan.lg_conv)
    return _finish(c, plan, plan.trunc)


def _select_plan(bits_a: int, bits_b: int) -> MulPlan:
    """The analytic flagship plan.  (The reference's tune cache holds TPU
    measurements only, so the port does not read it.)"""
    return choose_params(bits_a, bits_b, sqrt2=True)


def mul(a: int, b: int, device="cuda") -> int:
    """Multiply two nonnegative Python ints through the flagship pipeline
    on `device`.  Small products are computed on the host."""
    if a < 0 or b < 0:
        raise ValueError("nonnegative operands only (mpn semantics)")
    if a == 0 or b == 0:
        return 0
    ba, bb = a.bit_length(), b.bit_length()
    if ba + bb <= _SMALL_THRESHOLD_BITS:
        return a * b
    plan = _select_plan(ba, bb)
    da = digits_to_tensor(digits_from_int(a, cdiv(ba, DIGIT_BITS)), device)
    db = digits_to_tensor(digits_from_int(b, cdiv(bb, DIGIT_BITS)), device)
    return int_from_digits(tensor_to_digits(mpn_mul_flagship(da, db, plan)))


def sqr(a: int, device="cuda") -> int:
    """Square a nonnegative Python int with one forward transform."""
    if a < 0:
        raise ValueError("nonnegative operand only (mpn semantics)")
    if a == 0:
        return 0
    ba = a.bit_length()
    if 2 * ba <= _SMALL_THRESHOLD_BITS:
        return a * a
    plan = _select_plan(ba, ba)
    da = digits_to_tensor(digits_from_int(a, cdiv(ba, DIGIT_BITS)), device)
    return int_from_digits(tensor_to_digits(mpn_sqr_flagship(da, plan)))
