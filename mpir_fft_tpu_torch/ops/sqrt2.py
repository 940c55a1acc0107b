"""Length-4n transforms using sqrt(2) as the extra root (counterpart of
mpir_fft_tpu/ops/sqrt2.py; ref FFT_radix2_sqrt2 mul_fft.c:839-885,
IFFT_radix2_sqrt2 mul_fft.c:1488-1536).

q = sqrt2^w is a 4n-th root of unity in Z/(2^W+1)Z.  With w even the
length-4n transform is the plain radix-2 transform with root 2^(w/2)
(ref mul_fft.c:850-855) -- the only branch ported so far.  Odd w needs the
half-bit top layer, whose TPU kernels are not ported yet."""

from __future__ import annotations

import torch

from .limb import normmod_div
from .transforms import fft_radix2, ifft_radix2


def _require_even_w(w: int) -> None:
    if w % 2:
        raise NotImplementedError(
            f"odd w={w}: the sqrt2 top layer (fused_sqrt2_top_fwd / "
            "fused_sqrt2_top_inv) is not ported yet")


def fft_sqrt2(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] = 4n over the 4n-th root
    q = sqrt2^w (even w)."""
    _require_even_w(w)
    return fft_radix2(x, w // 2, W)


def ifft_sqrt2(x: torch.Tensor, w: int, W: int, norm_div: int = 0) -> torch.Tensor:
    """Inverse of fft_sqrt2 (times C).  norm_div > 0: divide the outputs by
    2^norm_div and canonicalize (the drivers' scale + normalize tail,
    mul_fft.c:3658-3662), as one normmod_div pass."""
    _require_even_w(w)
    out = ifft_radix2(x, w // 2, W)
    return normmod_div(out, norm_div, W) if norm_div else out
