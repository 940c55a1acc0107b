"""Length-4n transforms using sqrt(2) as the extra root (counterpart of
mpir_fft_tpu/ops/sqrt2.py; ref FFT_radix2_sqrt2 mul_fft.c:839-885,
IFFT_radix2_sqrt2 mul_fft.c:1488-1536).

With p = 2^W + 1, sqrt2 := 2^(3W/4) - 2^(W/4) satisfies sqrt2^2 == 2, so
q = sqrt2^w is a 4n-th root of unity (q^2 = z = 2^w).  Exponents of q are
half-integers, carried in HALF-BIT units (e2; the twiddle is 2^(e2/2)),
mod 4W; an odd half-exponent costs two shifts and a subtract,
x * 2^(k + 1/2) = x * 2^(k + 3W/4) - x * 2^(k + W/4) (mul_fft.c:591-634).

With w even the length-4n transform is the plain radix-2 transform with root
2^(w/2) (mul_fft.c:850-855).  With w odd only the top stage sees odd
half-exponents: the top layer (the reference's `_top_exps`,
`_sqrt2_top_fwd`, `_sqrt2_top_inv`, sqrt2.py:106-150) is one kernel pass
each way (ops/fused.py fused_sqrt2_top_fwd / fused_sqrt2_top_inv, which
build the q^j table j*w themselves), and the two half transforms at root
2^w run as ONE transform over the [..., 2, h, L] view, so the halves are
never copied apart or concatenated."""

from __future__ import annotations

import numpy as np
import torch

from .fused import (fused_sqrt2_top_fwd, fused_sqrt2_top_inv, fused_twiddle_half,
                    twiddle_half_rows_plain)
from .limb import normmod_div
from .transforms import fft_radix2, ifft_radix2


def twiddle_half(x: torch.Tensor, e2, W: int) -> torch.Tensor:
    """x[..., j, :] * 2^(e2[j] / 2) mod p for a static half-bit exponent
    vector e2 (mod 4W).  An affine table (every table this package builds)
    runs as one twiddle_half kernel pass (fused_twiddle_half).  On a CPU
    tensor any other table takes the plain row body; on the card it raises,
    since the kernel takes only e0 + j*step."""
    e2 = np.asarray(e2, np.int64)
    if x.ndim < 2 or e2.ndim != 1 or e2.size != x.shape[-2] or e2.size == 0:
        raise ValueError((tuple(x.shape), e2.shape))
    step = int(e2[1] - e2[0]) if e2.size > 1 else 0
    if np.all(np.diff(e2) == step):
        return fused_twiddle_half(x.contiguous(), int(e2[0] % (4 * W)), step, W)
    if x.device.type != "cpu":
        raise ValueError("twiddle_half: the kernel takes affine tables only")
    return twiddle_half_rows_plain(x, torch.as_tensor(np.mod(e2, 4 * W))[:, None], W)


def fft_sqrt2(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] = 4n over the 4n-th root
    q = sqrt2^w.  Odd w: the top layer, then both halves as one radix-2
    transform at root 2^w (ref mul_fft.c:839-885)."""
    if w % 2 == 0:
        return fft_radix2(x, w // 2, W)
    C, L = x.shape[-2], x.shape[-1]
    top = fused_sqrt2_top_fwd(x.contiguous(), w, W)
    return fft_radix2(top.reshape(x.shape[:-2] + (2, C // 2, L)), w, W).reshape(x.shape)


def ifft_sqrt2(x: torch.Tensor, w: int, W: int, norm_div: int = 0) -> torch.Tensor:
    """Inverse of fft_sqrt2 (times C).  norm_div > 0: divide the outputs by
    2^norm_div and canonicalize (the drivers' scale + normalize tail,
    mul_fft.c:3658-3662) -- fused into the top merge for odd w, one
    normmod_div pass for even w."""
    if w % 2 == 0:
        out = ifft_radix2(x, w // 2, W)
        return normmod_div(out, norm_div, W) if norm_div else out
    C, L = x.shape[-2], x.shape[-1]
    halves = ifft_radix2(x.reshape(x.shape[:-2] + (2, C // 2, L)), w, W)
    return fused_sqrt2_top_inv(halves.reshape(x.shape), w, W, norm_div=norm_div)
