"""The port's seven multiplication drivers (models/mul.py DRIVERS) against the
JAX package's and Python's products, on the same operands.

Every case compares the product digits of the port's driver with the
reference's jitted driver (_jitted_driver) and with Python's a * b: exact.
The flagship cases include plans whose trunc_mfa is below conv_len, in each
branch of mfa_fft_trunc_sqrt2 (odd w with trunc_mfa above, at and below h,
even w above and below h); a spy shows those took the truncated MFA and that
the pointwise saw trunc_mfa rows."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.models.mul import DRIVERS as JDRIVERS
from mpir_fft_tpu.models.mul import _jitted_driver, mpn_sqr_flagship
from mpir_fft_tpu.utils import params as jparams
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import mfa as tmfa
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, plan_for_depth, validate


def rand_int(rng, bits):
    v = int.from_bytes(rng.bytes(cdiv(bits, 8)), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


def _digits(v, bits):
    return digits_from_int(v, cdiv(bits, DIGIT_BITS))


# tests/test_drivers.py's CASES: (driver, bits_a, bits_b, depth)
CASES = [
    ("radix2", 6000, 6000, 3),
    ("sqrt2", 6000, 6000, 3),
    ("trunc", 9000, 5500, 4),
    ("trunc", 4000, 3800, 3),
    ("trunc_sqrt2", 9000, 5500, 3),
    ("trunc_sqrt2", 12000, 4000, 3),
    ("mfa", 6000, 6000, 3),
    ("mfa_trunc", 9000, 5500, 4),
    ("mfa_trunc", 16000, 9000, 4),
    ("flagship", 9000, 5500, 3),
    ("flagship", 16000, 9000, 4),
    ("flagship", 24000, 6000, 4),
]

# plans whose truncation takes effect: (driver, plan, the branch)
TRUNCATED = [
    ("flagship", plan_for_depth(40000, 12000, 8, sqrt2=True)),      # odd w, 544 > h 512
    ("flagship", plan_for_depth(40000, 9000, 8, sqrt2=True)),       # odd w, 512 == h
    ("flagship", plan_for_depth(30000, 6000, 8, sqrt2=True)),       # odd w, 384 < h
    ("flagship", validate(MulPlan(6, 2, 32, 120, 16, 3840, 512, True))),    # even w, 136 > h 128
    ("flagship", validate(MulPlan(6, 2, 32, 100, 20, 3200, 640, True))),    # even w, 120 < h
    ("trunc", validate(MulPlan(6, 2, 32, 50, 10, 1600, 320, False))),        # trunc 60 of 128
    ("trunc_sqrt2", validate(MulPlan(5, 1, 12, 70, 20, 840, 240, True))),    # odd w, 90 > h 64
    ("trunc_sqrt2", validate(MulPlan(6, 2, 32, 100, 20, 3200, 640, True))),  # even w, 120 of 256
    ("mfa_trunc", validate(MulPlan(6, 2, 32, 50, 10, 1600, 320, False))),   # 64 of 128, > h
    ("mfa_trunc", validate(MulPlan(6, 2, 32, 30, 10, 960, 320, False))),    # 40 of 128, <= h
]


def _both(kind, plan, a, b):
    """(port digits, reference digits) of driver `kind` at `plan`."""
    da, db = _digits(a, plan.bits_a), _digits(b, plan.bits_b)
    got = tmul.DRIVERS[kind][0](torch.from_numpy(da), torch.from_numpy(db), plan).numpy()
    jplan = jparams.MulPlan(**{f: getattr(plan, f) for f in plan.__dataclass_fields__})
    want = np.asarray(_jitted_driver(kind, jplan)(jnp.asarray(da), jnp.asarray(db)))
    return got, want


@pytest.mark.parametrize("kind,ba,bb,depth", CASES)
def test_driver_matches_reference(rng, kind, ba, bb, depth):
    plan = plan_for_depth(ba, bb, depth, tmul.DRIVERS[kind][1])
    a, b = rand_int(rng, ba), rand_int(rng, bb)
    got, want = _both(kind, plan, a, b)
    assert np.array_equal(got, want)
    assert int_from_digits(got) == a * b


@pytest.mark.parametrize("kind,plan", TRUNCATED)
def test_truncated_driver_matches_reference(rng, kind, plan):
    assert (plan.trunc_mfa if kind.endswith(("flagship", "mfa_trunc")) else plan.trunc) \
        < plan.conv_len
    a, b = rand_int(rng, plan.bits_a), rand_int(rng, plan.bits_b)
    got, want = _both(kind, plan, a, b)
    assert np.array_equal(got, want)
    assert int_from_digits(got) == a * b


def _spied(monkeypatch):
    """Spies on the flagship's path: the pointwise's row counts and the MFA
    calls; the flat full-length transforms raise."""
    seen = {"rows": [], "mfa": 0}
    pointwise = tmul._pointwise

    def spy_pointwise(fa, fb, W, recursive):
        seen["rows"].append(fa.shape[-2])
        return pointwise(fa, fb, W, recursive)

    def spy(fn):
        def run(*args, **kw):
            seen["mfa"] += 1
            return fn(*args, **kw)
        return run

    def flat(*args, **kw):
        raise AssertionError("the flat full-length transform ran")

    monkeypatch.setattr(tmul, "_pointwise", spy_pointwise)
    for name in ("mfa_fft_trunc", "mfa_ifft_trunc", "fft_radix2_mfa", "ifft_radix2_mfa"):
        monkeypatch.setattr(tmfa, name, spy(getattr(tmfa, name)))
    monkeypatch.setattr(tsqrt2, "fft_sqrt2", flat)
    monkeypatch.setattr(tsqrt2, "ifft_sqrt2", flat)
    return seen


@pytest.mark.parametrize("plan", [p for k, p in TRUNCATED if k == "flagship"])
def test_flagship_takes_the_truncated_mfa(rng, monkeypatch, plan):
    """The truncated flagship plans run mfa_fft_trunc_sqrt2's truncated
    branch (never the flat full-length pair), the pointwise on trunc_mfa
    rows."""
    seen = _spied(monkeypatch)
    a, b = rand_int(rng, plan.bits_a), rand_int(rng, plan.bits_b)
    da, db = torch.from_numpy(_digits(a, plan.bits_a)), torch.from_numpy(_digits(b, plan.bits_b))
    assert int_from_digits(tmul.mpn_mul_flagship(da, db, plan).numpy()) == a * b
    assert seen["rows"] == [plan.trunc_mfa] and seen["mfa"] > 0


@pytest.mark.parametrize("plan", [
    validate(MulPlan(8, 1, 96, 270, 270, 25920, 25920, True)),      # odd w, 544 > h 512
    validate(MulPlan(6, 2, 32, 60, 60, 1920, 1920, True)),          # even w, 120 of 256
])
def test_sqr_truncated_matches_reference(rng, monkeypatch, plan):
    """Squaring at a truncated plan: the reference's digits, Python's a * a,
    the pointwise on trunc_mfa rows."""
    assert plan.trunc_mfa < plan.conv_len
    a = rand_int(rng, plan.bits_a)
    jplan = jparams.MulPlan(**{f: getattr(plan, f) for f in plan.__dataclass_fields__})
    want = np.asarray(jax.jit(functools.partial(mpn_sqr_flagship, plan=jplan))(
        jnp.asarray(_digits(a, plan.bits_a))))
    seen = _spied(monkeypatch)
    got = tmul.mpn_sqr_flagship(torch.from_numpy(_digits(a, plan.bits_a)), plan).numpy()
    assert int_from_digits(got) == a * a
    assert np.array_equal(got, want)
    assert seen["rows"] == [plan.trunc_mfa] and seen["mfa"] > 0


def test_mul_drivers(rng):
    """mul(a, b, driver=...) serves every driver of the reference's DRIVERS at
    the planner's plan; an unknown driver raises."""
    assert set(tmul.DRIVERS) == set(JDRIVERS)
    assert all(tmul.DRIVERS[k][1] == JDRIVERS[k][1] for k in JDRIVERS)
    a, b = rand_int(rng, 14000), rand_int(rng, 11000)
    for kind in sorted(tmul.DRIVERS):
        assert tmul.mul(a, b, driver=kind, device="cpu") == a * b, kind
    assert tmul.mul(a, b, device="cpu") == a * b
    with pytest.raises(ValueError):
        tmul.mul(a, b, driver="nope", device="cpu")
