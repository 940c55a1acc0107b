"""Negacyclic weighted transforms (counterpart of
mpir_fft_tpu/ops/negacyclic.py:23-48; ref FFT_radix2_negacyclic
mul_fft.c:1290-1390, IFFT_radix2_negacyclic mul_fft.c:1861-1962).

A negacyclic convolution of length m = 2n (product mod x^m + 1) is a cyclic
convolution of the sequences weighted by q^i, q a primitive 2m-th root:
q = 2^(w/2) in half-bit terms (q^2 = z = 2^w, q^m = 2^W = -1).  The
weighting is one affine twiddle_half table e2[i] = i*w (the twiddle_half
kernel on a GPU tensor); the transform is the plain radix-2 one."""

from __future__ import annotations

import numpy as np
import torch

from .limb import div_2expmod
from .sqrt2 import twiddle_half
from .transforms import fft_radix2, ifft_radix2


def _weight_exps(m: int, w: int) -> np.ndarray:
    return np.arange(m, dtype=np.int64) * w


def fft_negacyclic(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Weight by q^i then forward-transform; length m = x.shape[-2] = 2n."""
    m = x.shape[-2]
    return fft_radix2(twiddle_half(x, _weight_exps(m, w), W), w, W)


def ifft_negacyclic(v: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Inverse-transform then unweight by q^-i; returns m * x for the
    weighted sequence x.  No scaling division: callers divide by
    2^(depth+1) (negacyclic_scale, or fused into normmod_div)."""
    m = v.shape[-2]
    return twiddle_half(ifft_radix2(v, w, W), -_weight_exps(m, w), W)


def negacyclic_scale(c: torch.Tensor, depth_plus1: int, W: int) -> torch.Tensor:
    """Divide by the transform scaling 2^(depth+1) (deferred as in
    mul_fft.c:3256-3260).  Followed by normmod it is one normmod_div pass,
    which is what ops/mulmod.py runs."""
    return div_2expmod(c, depth_plus1, W)
