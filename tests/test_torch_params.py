"""The port's host-side copies (planner, digit conversion, oracles) and its
interop helpers, pinned to their originals in the JAX package.

The port has no NTT leaf (ops/pointwise.NTT_AVAILABLE is False), so its
planner must give exactly the reference's plans under MPIR_FFT_NTT=0."""

import dataclasses

import numpy as np
import pytest
import torch

from mpir_fft_tpu.ops import limb as jlimb
from mpir_fft_tpu.utils import oracle as joracle
from mpir_fft_tpu.utils import params as jparams
from mpir_fft_tpu_torch.ops import limb as tlimb
from mpir_fft_tpu_torch.ops.pointwise import NTT_AVAILABLE
from mpir_fft_tpu_torch.utils import oracle as toracle
from mpir_fft_tpu_torch.utils import params as tparams
from mpir_fft_tpu_torch.utils.interop import (
    digits_to_tensor,
    plan_from_reference,
    tensor_to_digits,
)

SIZES = [
    (9000, 9000), (12000, 12000), (12000, 5000), (16000, 16000), (24000, 24000),
    (40000, 40000), (48000, 48000), (100000, 30000), (300000, 300000),
    (2_000_000, 2_000_000), (5_000_000, 5_000_000), (20_000_000, 20_000_000),
]


@pytest.fixture
def ref_pricing(monkeypatch):
    """The reference planner priced as the port's pointwise leaf."""
    monkeypatch.setenv("MPIR_FFT_NTT", "1" if NTT_AVAILABLE else "0")


def _same_plan(tp, jp):
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for prop in ("n", "W", "conv_len", "lg_conv", "trunc"):
        assert getattr(tp, prop) == getattr(jp, prop), prop


@pytest.mark.parametrize("bits_a,bits_b", SIZES)
def test_choose_params_matches_reference(ref_pricing, bits_a, bits_b):
    for sqrt2 in (True, False, None):
        jp = jparams.choose_params(bits_a, bits_b, sqrt2=sqrt2)
        tp = tparams.choose_params(bits_a, bits_b, sqrt2=sqrt2)
        _same_plan(tp, jp)
        assert tparams.plan_cost(tp) == jparams.plan_cost(jp)


def test_slice_plans(ref_pricing):
    """The plans chip_smoke.py drives: even w, schoolbook-served, full length."""
    for bits, (depth, w, L, conv) in {2_000_000: (10, 2, 128, 4096),
                                      20_000_000: (12, 2, 512, 16384)}.items():
        p = tparams.choose_params(bits, bits, sqrt2=True)
        assert (p.depth, p.w, p.W // 16, p.conv_len) == (depth, w, L, conv)
        assert p.j1 + p.j2 - 1 <= p.conv_len


@pytest.mark.parametrize("depth", [3, 5, 8])
@pytest.mark.parametrize("sqrt2", [False, True])
def test_plan_for_depth_matches_reference(depth, sqrt2):
    for bits_a, bits_b in [(5000, 5000), (33333, 1234), (100000, 99999)]:
        _same_plan(tparams.plan_for_depth(bits_a, bits_b, depth, sqrt2),
                   jparams.plan_for_depth(bits_a, bits_b, depth, sqrt2))


def test_validate_and_cdiv_match_reference():
    assert [tparams.cdiv(a, b) for a in range(-9, 40) for b in (1, 3, 16)] == \
        [jparams.cdiv(a, b) for a in range(-9, 40) for b in (1, 3, 16)]
    bad = dict(depth=3, w=16, bits1=62, j1=4, j2=4, bits_a=240, bits_b=240, sqrt2=True)
    with pytest.raises(AssertionError):
        jparams.validate(jparams.MulPlan(**bad))
    with pytest.raises(AssertionError):
        tparams.validate(tparams.MulPlan(**bad))


def test_digit_conversion_copies(rng):
    for L in (1, 7, 64):
        for _ in range(20):
            x = int.from_bytes(rng.bytes(2 * L), "little")
            assert np.array_equal(tlimb.digits_from_int(x, L), jlimb.digits_from_int(x, L))
        assert np.array_equal(tlimb.digits_from_int(-1, L), jlimb.digits_from_int(-1, L))
        d = rng.integers(-(1 << 20), 1 << 20, L).astype(np.int32)
        assert tlimb.int_from_digits(d) == jlimb.int_from_digits(d)
    r = tlimb.Ring(32, 8)
    j = jlimb.Ring(32, 8)
    assert (r.n, r.w, r.bits, r.L, r.p) == (j.n, j.w, j.bits, j.L, j.p)


def test_oracle_copies(rng):
    W = 16 * 8
    for _ in range(30):
        v = int(rng.integers(-(1 << 62), 1 << 62)) << int(rng.integers(0, 80))
        s = int(rng.integers(0, 4 * W))
        assert toracle.canon(v, W) == joracle.canon(v, W)
        assert toracle.ref_mul_2expmod(v, s, W) == joracle.ref_mul_2expmod(v, s, W)
        assert toracle.ref_div_2expmod(v, s, W) == joracle.ref_div_2expmod(v, s, W)
        assert toracle.ref_sumdiff(v, s, W) == joracle.ref_sumdiff(v, s, W)
    d = joracle.rand_digits(np.random.default_rng(5), (3, 8))
    assert np.array_equal(toracle.rand_digits(np.random.default_rng(5), (3, 8)), d)
    assert toracle.ref_norm(d[0], W) == joracle.ref_norm(d[0], W)
    assert np.array_equal(toracle.rand_canonical(np.random.default_rng(6), (4,)),
                          joracle.rand_canonical(np.random.default_rng(6), (4,)))


def test_interop(ref_pricing, rng):
    jp = jparams.choose_params(16000, 16000, sqrt2=True)
    _same_plan(plan_from_reference(dataclasses.asdict(jp)), jp)
    d = rng.integers(-(1 << 20), 1 << 20, (3, 17)).astype(np.int32)
    t = digits_to_tensor(d, "cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert np.array_equal(tensor_to_digits(t), d)
