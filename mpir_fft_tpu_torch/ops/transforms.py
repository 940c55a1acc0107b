"""Iterative radix-2 DIF transforms over Z/(2^W+1)Z (counterpart of
mpir_fft_tpu/ops/transforms.py).

A transform of length C = x.shape[-2] runs as consecutive butterfly-ladder
groups: each group of kg <= ladder_stages(L) stages is one pass over the
whole [..., C, L] array (one kernel launch on a GPU tensor), exactly the
grouping of the reference's ladder path (transforms.py:146-168, 297-318).

Conventions (identical to the reference):
  * z = 2^w is a 2n-th root of unity; the forward transform is
    decimation-in-frequency with output in revbin order.
  * No scaling inside transforms: ifft(fft(x)) == 2^log2(C) * x.

Not ported yet: the MFA / staged options (`post_exps`, `pre_exps`,
`pre_half`, `skip_inner`)."""

from __future__ import annotations

import numpy as np
import torch

from .fused import fused_butterfly_ladder, ladder_stages


def ladder_groups(C: int, L: int, kind: str) -> list[tuple[int, int]]:
    """(first stage l, stage count kg) of each ladder launch of a length-C
    transform at digit width L, in execution order."""
    D = C.bit_length() - 1
    kmax = ladder_stages(L)
    groups = []
    if kind == "fwd":
        l = 0
        while l < D:
            kg = min(kmax, D - l)
            groups.append((l, kg))
            l += kg
    else:
        l_hi = D
        while l_hi > 0:
            kg = min(kmax, l_hi)
            groups.append((l_hi - kg, kg))
            l_hi -= kg
    return groups


def _run(x: torch.Tensor, w: int, W: int, kind: str) -> torch.Tensor:
    C, L = x.shape[-2], x.shape[-1]
    assert C == 1 << (C.bit_length() - 1), "transform length must be a power of two"
    shape = x.shape
    x = x.contiguous()
    for l, kg in ladder_groups(C, L, kind):
        K = 1 << kg
        steps = tuple(w << (l + j) for j in range(kg))
        x = fused_butterfly_ladder(
            kind, x.reshape(-1, K, C >> (l + kg), L), steps, W
        ).reshape(shape)
    return x


def fft_radix2(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] over root z = 2^w; output in
    revbin order: out[j] = X(z^revbin(j))."""
    return _run(x, w, W, "fwd")


def ifft_radix2(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Inverse of fft_radix2 (times C): revbin-ordered input, natural-order
    output."""
    return _run(x, w, W, "inv")


def revbin_vec(C: int) -> np.ndarray:
    """revbin(j, log2 C) for all j (ref mpir_revbin, mul_fft.c:52-79)."""
    D = C.bit_length() - 1
    assert C == 1 << D
    j = np.arange(C, dtype=np.int64)
    r = np.zeros_like(j)
    for b in range(D):
        r |= ((j >> b) & 1) << (D - 1 - b)
    return r
