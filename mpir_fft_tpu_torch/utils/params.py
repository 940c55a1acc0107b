"""Transform parameter selection (copied from mpir_fft_tpu/utils/params.py;
tests/test_torch_params.py pins the copy to its original).

Sizing rule (ref mul_fft.c:3194, 3271): with convolution length m and ring
width W = n*w bits, each input coefficient may hold
    bits1 = (W - log2(m)) // 2
bits so that accumulated pointwise sums never overflow mod p.  Plain plans
use m = 2n; sqrt2 plans use m = 4n (the sqrt2 trick).

The one difference from the reference: `plan_cost` prices the pointwise as
the schoolbook leaf, because the NTT leaf is not ported
(ops/pointwise.NTT_AVAILABLE).  That is the reference's own pricing under
MPIR_FFT_NTT=0, so the plans are the reference's plans there."""

from __future__ import annotations

import dataclasses
import math

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS
from mpir_fft_tpu_torch.ops.mulmod import MULMOD_BASE_MAX_BITS
from mpir_fft_tpu_torch.ops.pointwise import base_serves


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MulPlan:
    depth: int          # n = 2^depth
    w: int              # ring W = n*w bits, p = 2^W + 1
    bits1: int          # input coefficient size in bits
    j1: int             # number of coefficients of operand 1
    j2: int             # number of coefficients of operand 2
    bits_a: int
    bits_b: int
    sqrt2: bool = False  # convolution length 4n (root sqrt2^w) vs 2n

    @property
    def n(self) -> int:
        return 1 << self.depth

    @property
    def W(self) -> int:
        return self.n * self.w

    @property
    def conv_len(self) -> int:
        return (4 if self.sqrt2 else 2) * self.n

    @property
    def lg_conv(self) -> int:
        return self.depth + (2 if self.sqrt2 else 1)

    @property
    def trunc(self) -> int:
        """Kept outputs: j1 + j2 - 1, rounded to >= 2 even positions."""
        return max(2, 2 * cdiv(self.j1 + self.j2 - 1, 2))


def validate(plan: MulPlan):
    W = plan.W
    assert W % DIGIT_BITS == 0
    assert plan.bits1 >= 1, "empty coefficients"
    assert 2 * plan.bits1 + plan.lg_conv <= W, "coefficient overflow mod p"
    assert plan.j1 + plan.j2 - 1 <= plan.conv_len, "convolution wraps"
    assert plan.j1 == cdiv(plan.bits_a, plan.bits1)
    assert plan.j2 == cdiv(plan.bits_b, plan.bits1)
    return plan


def plan_for_depth(bits_a: int, bits_b: int, depth: int, sqrt2: bool = False) -> MulPlan:
    """Smallest valid w for a given depth (mirrors how reference callers pick
    w after fixing depth, e.g. mul_fft.c:3576-3613)."""
    n = 1 << depth
    m = (4 if sqrt2 else 2) * n
    lg = depth + (2 if sqrt2 else 1)
    total = bits_a + bits_b
    lcm = n * DIGIT_BITS // math.gcd(n, DIGIT_BITS)
    for extra in range(0, 1 << 30):
        bits1 = cdiv(total, m) + extra
        W = cdiv(2 * bits1 + lg, lcm) * lcm
        w = W // n
        bits1_max = (W - lg) // 2
        # digit-align the coefficient stride (8 digits, falling back to 2,
        # then 1) so split/combine are reshapes
        d_max = bits1_max // DIGIT_BITS
        for align in (8, 2, 1):
            d = (d_max // align) * align
            if d < 1:
                continue
            bits1 = d * DIGIT_BITS
            j1, j2 = cdiv(bits_a, bits1), cdiv(bits_b, bits1)
            if j1 + j2 - 1 <= m:
                return validate(
                    MulPlan(depth, w, bits1, j1, j2, bits_a, bits_b, sqrt2)
                )
        j1, j2 = cdiv(bits_a, bits1_max), cdiv(bits_b, bits1_max)
        if j1 + j2 - 1 <= m:
            return validate(
                MulPlan(depth, w, bits1_max, j1, j2, bits_a, bits_b, sqrt2)
            )
    raise AssertionError("unreachable")


def plan_cost(plan: MulPlan) -> float:
    """Rough work model: transform passes + pointwise.  The pointwise is
    priced as the schoolbook where the base serves the ring, else as the
    recursive Fermat mulmod (the reference's constants)."""
    L = plan.W // DIGIT_BITS
    t = plan.trunc
    fft_cost = 3 * t * L * plan.lg_conv * 3
    pw_unit = t * (2 * L) ** 2 // 8
    if plan.W <= MULMOD_BASE_MAX_BITS and base_serves(L):
        pw_cost = pw_unit * 1.0          # schoolbook
    else:
        pw_cost = pw_unit * 0.3          # recursive Fermat mulmod
    return 3 * fft_cost + pw_cost


def choose_params(bits_a: int, bits_b: int, sqrt2: bool | None = None) -> MulPlan:
    """Pick (depth, w, sqrt2) by scanning near the square-ish optimum
    (the fft_mulmod_2expp1 rule, mul_fft.c:3141-3162) with plan_cost.
    sqrt2=None considers both convolution families."""
    total = bits_a + bits_b
    d0 = max(2, (total.bit_length() // 2) - 2)
    best, best_cost = None, None
    variants = [False, True] if sqrt2 is None else [sqrt2]
    for s2 in variants:
        for depth in range(max(2, d0 - 2), d0 + 3):
            try:
                plan = plan_for_depth(bits_a, bits_b, depth, s2)
            except AssertionError:
                continue
            cost = plan_cost(plan)
            if (plan.bits1 // DIGIT_BITS) % 2 == 1:
                # odd coefficient stride: only pick such a plan when no
                # even-stride depth fits (the reference's TPU relayout
                # penalty, kept so the plans match)
                cost *= 50.0
            if best_cost is None or cost < best_cost:
                best, best_cost = plan, cost
    assert best is not None, "no valid plan found"
    return best
