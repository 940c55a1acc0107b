"""The port's whole-block transform (ops/fused.py fused, the counterpart of
mpir_fft_tpu/ops/fused.py fused) against the JAX package on the same numpy
inputs.

The reference runs fused(fn, x) with fn its fft_radix2 / ifft_radix2 under
force_pallas(True), so that its Pallas kernel runs in interpret mode; the
port takes its plain version on the CPU (the column kernel's plain version
on the block as one column).  Values are compared mod p after normmod: all
arithmetic is integer, so the tolerance is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import fused as jfused
from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2
from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops.limb import normmod

# (C, L): W = 16 L, the full transform's root 2^w with w = 2W / C
BLOCKS = [(8, 16), (16, 32), (32, 64), (64, 16)]


def _block(seed, C, L):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 17), 1 << 17, (C, L)).astype(np.int32)


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("C,L", BLOCKS)
def test_fused_matches_reference(kind, C, L):
    W = 16 * L
    w = 2 * W // C
    x = _block(C * L + (kind == "inv"), C, L)
    fn = fft_radix2 if kind == "fwd" else ifft_radix2
    with jfused.force_pallas(True):
        want = np.array(jfused.fused(lambda v: fn(v, w, W), jnp.asarray(x)))
    got = tfused.fused(kind, torch.from_numpy(x), w, W)
    assert got.shape == (C, L) and got.dtype == torch.int32
    assert torch.equal(normmod(got), normmod(torch.from_numpy(want)))


def test_fused_is_one_column_of_the_column_kernel():
    """On the CPU fused is the column kernel's plain version on one column,
    digit for digit, and counts no launch."""
    C, L = 32, 64
    W, x = 16 * L, torch.from_numpy(_block(7, C, L))
    kernels.reset_launches()
    for kind in ("fwd", "inv"):
        want = tfused.mfa_cols_plain(kind, x[None], 2 * W // C, W, 1, C)[0]
        assert torch.equal(tfused.fused(kind, x, 2 * W // C, W), want)
    assert kernels.LAUNCHES["fused"] == 0 and kernels.LAUNCHES["mfa_cols"] == 0


def test_fused_refuses_what_the_column_kernel_does_not_hold():
    x = torch.zeros((1024, 256), dtype=torch.int32)     # 1 MB: past the full column's 512 KB
    with pytest.raises(ValueError):
        tfused.fused("fwd", x, 8, 16 * 256)
    with pytest.raises(ValueError):
        tfused.fused("fwd", torch.zeros((12, 16), dtype=torch.int32), 8, 256)   # C not 2^k
    with pytest.raises(ValueError):
        tfused.fused("fwd", torch.zeros((8, 16), dtype=torch.int32), 64, 512)   # W != 16 L
    with pytest.raises(ValueError):
        tfused.fused("both", torch.zeros((8, 16), dtype=torch.int32), 64, 256)
    with pytest.raises(TypeError):
        tfused.fused("fwd", torch.zeros((8, 16), dtype=torch.int64), 64, 256)
