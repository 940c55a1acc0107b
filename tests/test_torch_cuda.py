"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc: every test skips elsewhere.  Imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Canonical outputs must be equal; redundant outputs equal after normmod.
All arithmetic is integer, so the tolerance is exact."""

import random

import numpy as np
import pytest
import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models.mul import mul, sqr
from mpir_fft_tpu_torch.ops.fused import (
    canonicalize_plain_torch,
    fused_butterfly_ladder,
    fused_canonicalize_plain,
    fused_normmod_div,
    ladder_plain,
    normmod_rows_plain,
)
from mpir_fft_tpu_torch.ops.pointwise import conv_base_plain
from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _rand(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)


def _canon(x):
    L = x.shape[-1]
    return normmod_rows_plain(x.reshape(-1, L).cpu(), 0, 16 * L)


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("shape,w", [
    ((2, 16, 8, 32), 1), ((3, 4, 5, 71), 7), ((1, 8, 2, 2048), 2), ((4, 2, 1, 16), 3),
])
def test_ladder_matches_plain(dev, kind, shape, w):
    rng = np.random.default_rng(1)
    N, K, h, L = shape
    W = 16 * L
    k = K.bit_length() - 1
    steps = tuple(w << (3 + j) for j in range(k))
    x = _rand(rng, shape, -(1 << 17), 1 << 17, dev)
    before = kernels.LAUNCHES["ladder"]
    got = fused_butterfly_ladder(kind, x, steps, W)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ladder"] == before + 1
    want = ladder_plain(kind, x.cpu(), steps, W)
    assert torch.equal(_canon(got), _canon(want))
    assert int(got.abs().max()) < 1 << 17


@pytest.mark.parametrize("B,L", [(5, 1), (7, 16), (3, 71), (4, 126), (9, 512), (2, 2048)])
def test_conv_base_matches_plain(dev, B, L):
    rng = np.random.default_rng(2)
    a = _rand(rng, (B, L), -(1 << 17), 1 << 17, dev)
    b = _rand(rng, (B, L), -(1 << 17), 1 << 17, dev)
    got = mulmod_base_fused(a, b)
    torch.cuda.synchronize()
    want = conv_base_plain(a.cpu(), b.cpu())
    assert torch.equal(_canon(got), _canon(want))


@pytest.mark.parametrize("L", [1, 16, 71, 512, 2048])
def test_normmod_matches_plain(dev, L):
    rng = np.random.default_rng(3)
    W = 16 * L
    x = rng.integers(-(1 << 29), 1 << 29, (8, L)).astype(np.int32)
    x[0] = 0xFFFF
    x[1] = 0
    x[2] = 0
    x[2, 0] = -1
    x[3] = 0
    x[3, -1] = 1 << 16
    xt = torch.from_numpy(x)
    for s in sorted({0, 1, 15, 16, 17, W - 1, W, W + 5, 2 * W - 14, 2 * W - 1}):
        if not 0 <= s < 2 * W:
            continue
        got = fused_normmod_div(xt.to(dev), s, W)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), normmod_rows_plain(xt, s, W)), s


@pytest.mark.parametrize("Bt,N", [(1, 1), (1, 2049), (3, 5000), (2, 1 << 16)])
def test_canonicalize_matches_plain(dev, Bt, N):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 20, (Bt, N)).astype(np.int32)
    x[:, -2:] = 0
    if Bt > 1:
        # a ripple from digit 0 through every tile of row 0 must not reach row 1
        x[0] = 0xFFFF
        x[0, 0] = 0x1FFFF
        x[0, -2:] = 0
    xt = torch.from_numpy(x)
    got = fused_canonicalize_plain(xt.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), canonicalize_plain_torch(xt))


@pytest.mark.parametrize("bits_a,bits_b", [(12000, 12000), (16000, 16000), (12000, 5000),
                                           (48000, 48000)])
def test_mul_exact_on_gpu(dev, bits_a, bits_b):
    rnd = random.Random(bits_a + bits_b)
    a = rnd.getrandbits(bits_a) | (1 << (bits_a - 1))
    b = rnd.getrandbits(bits_b) | (1 << (bits_b - 1))
    assert mul(a, b, device=dev) == a * b
    assert sqr(a, device=dev) == a * a
