"""The port's drivers (models/mul.py) end to end on the CPU path: exact
against Python ints, and digit for digit against the JAX flagship run with
the same plan under MPIR_FFT_NTT=0 (the schoolbook / recursive leaf; the
default NTT plans are held in tests/test_torch_ntt.py): even and odd w,
and plans whose pointwise recurses (2L > 4096).

The JAX driver runs as mpn_mul_flagship under a fresh jax.jit, not through
mul(): mul() consults the TPU tune cache, and its jit cache is keyed by
plan, not by environment."""

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.utils.params import choose_params as j_choose_params
from mpir_fft_tpu.utils.params import plan_for_depth as j_plan_for_depth
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops.limb import digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, plan_from_reference, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import plan_for_depth

# even-w plans: 12000 (w 4, L 16, aligned bits1), 16000 (w 252, L 126,
# bits1 1005: the residue-class split/combine), 24000 / 48000 (C 512),
# 9000 (L 71, odd digit width), 12000 x 5000 (unbalanced, w 34)
EVEN_W = [(12000, 12000), (16000, 16000), (24000, 24000), (48000, 48000),
          (9000, 9000), (12000, 5000)]


def _operands(bits_a, bits_b):
    rnd = random.Random(bits_a * 7 + bits_b)
    return (rnd.getrandbits(bits_a) | (1 << (bits_a - 1)),
            rnd.getrandbits(bits_b) | (1 << (bits_b - 1)))


@pytest.mark.parametrize("bits_a,bits_b", EVEN_W)
def test_mul_exact(bits_a, bits_b):
    a, b = _operands(bits_a, bits_b)
    assert tmul.mul(a, b, device="cpu") == a * b


@pytest.mark.parametrize("bits", [12000, 16000, 9000])
def test_sqr_exact(bits):
    a, _ = _operands(bits, bits)
    assert tmul.sqr(a, device="cpu") == a * a


@pytest.mark.parametrize("bits_a,bits_b", [(12000, 12000), (16000, 16000)])
def test_flagship_matches_reference(monkeypatch, bits_a, bits_b):
    monkeypatch.setenv("MPIR_FFT_NTT", "0")
    a, b = _operands(bits_a, bits_b)
    jp = j_choose_params(bits_a, bits_b, sqrt2=True)
    tp = plan_from_reference(dataclasses.asdict(jp))
    da = digits_from_int(a, -(-bits_a // 16))
    db = digits_from_int(b, -(-bits_b // 16))
    want = np.asarray(jax.jit(functools.partial(jmul.mpn_mul_flagship, plan=jp))(
        jnp.asarray(da), jnp.asarray(db)))
    got = tensor_to_digits(tmul.mpn_mul_flagship(
        digits_to_tensor(da, "cpu"), digits_to_tensor(db, "cpu"), tp))
    assert np.array_equal(got, want)
    if bits_a == bits_b == 12000:
        want_sq = np.asarray(jax.jit(functools.partial(jmul.mpn_sqr_flagship, plan=jp))(
            jnp.asarray(da)))
        got_sq = tensor_to_digits(tmul.mpn_sqr_flagship(digits_to_tensor(da, "cpu"), tp))
        assert np.array_equal(got_sq, want_sq)


def test_mul_slice_small_smoke_size():
    """2x10^6 bits: the plan chip_smoke.py compares in full (depth 10, w 2,
    L 128, conv 4096), here on the plain path."""
    a, b = _operands(2_000_000, 2_000_000)
    assert tmul.mul(a, b, device="cpu") == a * b


def test_odd_w_not_ported():
    """Odd w, once refused, now runs through the sqrt2 top layer: exact."""
    a, b = _operands(40000, 40000)
    assert tmul.choose_params(40000, 40000, sqrt2=True).w % 2 == 1
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(a, device="cpu") == a * a


# odd-w plans: 40000 (depth 4, w 157, L 157), 40000 x 17000 (unbalanced,
# depth 5, w 29, L 58: L % 4 != 0), 30000 x 25000 (depth 8, w 1, L 16)
ODD_W = [(40000, 40000), (40000, 17000), (30000, 25000)]


@pytest.mark.parametrize("bits_a,bits_b", ODD_W)
def test_mul_odd_w_exact(bits_a, bits_b):
    assert tmul.choose_params(bits_a, bits_b, sqrt2=True).w % 2 == 1
    a, b = _operands(bits_a, bits_b)
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(b, device="cpu") == b * b


def test_flagship_odd_w_matches_reference(monkeypatch):
    monkeypatch.setenv("MPIR_FFT_NTT", "0")
    a, b = _operands(40000, 17000)
    jp = j_choose_params(40000, 17000, sqrt2=True)
    tp = plan_from_reference(dataclasses.asdict(jp))
    assert tp.w % 2 == 1
    da, db = digits_from_int(a, 2500), digits_from_int(b, 1063)
    want = np.asarray(jax.jit(functools.partial(jmul.mpn_mul_flagship, plan=jp))(
        jnp.asarray(da), jnp.asarray(db)))
    got = tensor_to_digits(tmul.mpn_mul_flagship(
        digits_to_tensor(da, "cpu"), digits_to_tensor(db, "cpu"), tp))
    assert np.array_equal(got, want)


def test_flagship_recursive_pointwise_matches_reference(monkeypatch):
    """L 2344 (2L > 4096): the pointwise recurses through mulmod_fft (an
    unaligned b = 293 inner plan); exact and digit for digit against the JAX
    flagship."""
    monkeypatch.setenv("MPIR_FFT_NTT", "0")
    bits = 150000
    a, b = _operands(bits, bits)
    jp = j_plan_for_depth(bits, bits, 2, sqrt2=True)
    tp = plan_from_reference(dataclasses.asdict(jp))
    assert tp == plan_for_depth(bits, bits, 2, sqrt2=True) and tp.W // 16 == 2344
    da, db = digits_from_int(a, bits // 16 + 1), digits_from_int(b, bits // 16 + 1)
    got = tensor_to_digits(tmul.mpn_mul_flagship(
        digits_to_tensor(da, "cpu"), digits_to_tensor(db, "cpu"), tp))
    assert int_from_digits(got) == a * b
    want = np.asarray(jax.jit(functools.partial(jmul.mpn_mul_flagship, plan=jp))(
        jnp.asarray(da), jnp.asarray(db)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits_a,bits_b", [(530000, 530000), (800000, 300000)])
def test_flagship_odd_w_recursive_pointwise(bits_a, bits_b):
    """depth 4: w 2071 (L 2071) and, unbalanced, w 2149 (L 2149): odd w with
    2L > 4096, so the pointwise recurses (unaligned b)."""
    plan = plan_for_depth(bits_a, bits_b, 4, sqrt2=True)
    assert plan.W // 16 > 2048 and plan.w % 2 == 1
    a, b = _operands(bits_a, bits_b)
    da = digits_to_tensor(digits_from_int(a, -(-bits_a // 16)), "cpu")
    db = digits_to_tensor(digits_from_int(b, -(-bits_b // 16)), "cpu")
    assert int_from_digits(tensor_to_digits(tmul.mpn_mul_flagship(da, db, plan))) == a * b
    if bits_a == bits_b:
        assert int_from_digits(tensor_to_digits(tmul.mpn_sqr_flagship(da, plan))) == a * a


def test_edges():
    assert tmul.mul(0, 5, device="cpu") == 0
    assert tmul.sqr(0, device="cpu") == 0
    assert tmul.mul(3 << 100, 5 << 200, device="cpu") == 15 << 300    # host shortcut
    with pytest.raises(ValueError):
        tmul.mul(-1, 5, device="cpu")
    with pytest.raises(ValueError):
        tmul.sqr(-1, device="cpu")


def test_default_device_is_the_card():
    """Nothing drops to the CPU unless asked: without a card the default
    device fails instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    a, b = _operands(12000, 12000)
    with pytest.raises((RuntimeError, AssertionError)):
        tmul.mul(a, b)
