"""The port refuses at plan time exactly the flagship plans the reference
refuses: above 2^29 coefficient elements a plan the reference's
out-of-core engine cannot serve raises ValueError from `mul` (unless the
reference takes it as balanced pieces) and from `sqr`, before any operand
is converted.  The plans come from both packages' planners, balanced and
not, and as variants that break digit alignment or shorten the operands;
no large int is built."""

import dataclasses

import pytest

from mpir_fft_tpu.models import huge as jhuge
from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.utils import params as jparams
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.utils import params as tparams

# (bits_a, bits_b): balanced and unbalanced products around and past the
# 2^29-element threshold (2x10^9 bits is exactly 2^29 elements at its
# default plan)
SIZES = [
    (2_000_000_000, 2_000_000_000), (2_100_000_000, 2_100_000_000),
    (3_000_000_017, 2_999_999_999), (4_000_000_000, 4_000_000_000),
    (8_000_000_000, 100_000_000), (8_000_000_000, 8_000_000_000),
    (16_000_000_000, 1_000_000), (30_000_000_000, 30_000_000_000),
]
DEPTHS = [None, 14, 16, 17, 19]     # None: the planner's own choice


def _verdict(require, piecewise, plan) -> tuple:
    """(mul's plan-time error or None, sqr's) under one package's rules."""
    def err():
        try:
            require(plan)
        except ValueError as e:
            return str(e)
        return None

    e = err()
    return (None if piecewise(plan) else e), e


def _plans(bits_a, bits_b, depth):
    if depth is None:
        return (jparams.choose_params(bits_a, bits_b, sqrt2=True),
                tparams.choose_params(bits_a, bits_b, sqrt2=True))
    return (jparams.plan_for_depth(bits_a, bits_b, depth, sqrt2=True),
            tparams.plan_for_depth(bits_a, bits_b, depth, sqrt2=True))


def _same(jplan, tplan):
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert jhuge.huge_serves(jplan) == tmul.huge_serves(tplan)
    assert jmul._piecewise_serves(jplan) == tmul._piecewise_serves(tplan)
    want = _verdict(jmul._require_huge_servable, jmul._piecewise_serves, jplan)
    got = _verdict(tmul._require_huge_servable, tmul._piecewise_serves, tplan)
    assert got == want
    return want


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("bits_a,bits_b", SIZES)
def test_refusal_matches_reference(monkeypatch, bits_a, bits_b, depth):
    """The planners' plans, and the same plans with bits1 one bit off a digit
    boundary and with one coefficient fewer in each operand."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    jplan, tplan = _plans(bits_a, bits_b, depth)
    _same(jplan, tplan)
    for change in (dict(bits1=jplan.bits1 - 1), dict(j1=jplan.j1 - 1, j2=jplan.j2 - 1)):
        _same(dataclasses.replace(jplan, **change), dataclasses.replace(tplan, **change))


def test_refusals_cover_every_cause(monkeypatch):
    """The sizes above reach each outcome: served below the threshold,
    served out of core, taken as pieces by mul (refused by sqr), refused
    for alignment.  (The MFA blocking rule cannot fail: trunc_mfa is a
    multiple of n1 by construction.)"""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    seen = set()
    for bits_a, bits_b in SIZES:
        for depth in DEPTHS:
            jplan, tplan = _plans(bits_a, bits_b, depth)
            for plan in (tplan, dataclasses.replace(tplan, bits1=tplan.bits1 - 1),
                         dataclasses.replace(tplan, j1=tplan.j1 - 1, j2=tplan.j2 - 1)):
                big = plan.conv_len * (plan.W // 16) > tmul._HUGE_THRESHOLD_ELEMS
                mul_err, sqr_err = _verdict(tmul._require_huge_servable, tmul._piecewise_serves,
                                            plan)
                seen.add("below" if not big else "huge" if sqr_err is None
                         else "pieces" if mul_err is None else
                         "aligned" if "digit-aligned" in mul_err else "refused")
    assert {"below", "huge", "pieces", "aligned"} <= seen, seen


def test_mul_and_sqr_refuse_before_converting(monkeypatch):
    """mul / sqr raise the reference's error from the plan alone: the
    refused plan is handed to small operands, and converting them fails the
    test."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    plan = tparams.choose_params(30_000_000_000, 30_000_000_000, sqrt2=True)
    plan = dataclasses.replace(plan, bits1=plan.bits1 - 1)
    jplan = dataclasses.replace(jparams.choose_params(30_000_000_000, 30_000_000_000, sqrt2=True),
                                bits1=plan.bits1)
    with pytest.raises(ValueError) as want:
        jmul._require_huge_servable(jplan)

    def converted(*args, **kwargs):
        raise AssertionError("an operand was converted before the plan was refused")

    monkeypatch.setattr(tmul, "_select_plan", lambda *args, **kwargs: plan)
    monkeypatch.setattr(tmul, "digits_to_tensor", converted)
    a, b = 3 ** 12000, 5 ** 11000
    with pytest.raises(ValueError) as got:
        tmul.mul(a, b, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        tmul.sqr(a, device="cpu")
    assert str(got.value) == str(want.value)
