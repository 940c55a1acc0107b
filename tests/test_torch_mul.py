"""The port's drivers (models/mul.py) end to end on the CPU path: exact
against Python ints, and digit for digit against the JAX flagship run with
the same plan under MPIR_FFT_NTT=0 (the schoolbook leaf the port serves).

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
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops.limb import digits_from_int
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, plan_from_reference, tensor_to_digits

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
    a, b = _operands(40000, 40000)
    assert tmul.choose_params(40000, 40000, sqrt2=True).w % 2 == 1
    with pytest.raises(NotImplementedError, match="odd w"):
        tmul.mul(a, b, device="cpu")
    with pytest.raises(NotImplementedError, match="odd w"):
        tmul.sqr(a, device="cpu")


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
