"""Negacyclic weighted transforms (counterpart of
mpir_fft_tpu/ops/negacyclic.py:23-48; ref FFT_radix2_negacyclic
mul_fft.c:1290-1390, IFFT_radix2_negacyclic mul_fft.c:1861-1962).

A negacyclic convolution of length m = 2n (product mod x^m + 1) is a cyclic
convolution of the sequences weighted by q^i, q a primitive 2m-th root:
q = 2^(w/2) in half-bit terms (q^2 = z = 2^w, q^m = 2^W = -1).  The
weighting is the affine half-bit table e2[i] = i*w (the reference's
`_weight_exps`), and it rides the transform: fft_radix2's pre_half = (0, w)
and ifft_radix2's post_half = (0, -w).  On the whole-transform route (the
recursive mulmod's batched inner rings) each weighted transform is one
transform_small launch; on the ladder route the forward weights ride the
first ladder group and the inverse takes one twiddle_half pass after the
last."""

from __future__ import annotations

import torch

from .limb import div_2expmod
from .transforms import fft_radix2, ifft_radix2


def fft_negacyclic(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Weight by q^i then forward-transform; length m = x.shape[-2] = 2n."""
    return fft_radix2(x, w, W, pre_half=(0, w))


def ifft_negacyclic(v: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Inverse-transform then unweight by q^-i; returns m * x for the
    weighted sequence x.  No scaling division: callers divide by
    2^(depth+1) (negacyclic_scale, or fused into normmod_div)."""
    return ifft_radix2(v, w, W, post_half=(0, -w))


def negacyclic_scale(c: torch.Tensor, depth_plus1: int, W: int) -> torch.Tensor:
    """Divide by the transform scaling 2^(depth+1) (deferred as in
    mul_fft.c:3256-3260).  Followed by normmod it is one normmod_div pass,
    which is what ops/mulmod.py runs."""
    return div_2expmod(c, depth_plus1, W)
