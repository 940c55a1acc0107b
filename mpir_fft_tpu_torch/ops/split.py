"""Split an integer into FFT coefficients and recombine with carries
(counterpart of mpir_fft_tpu/ops/split.py; ref FFT_split_bits
mul_fft.c:87-170, FFT_combine_bits mul_fft.c:180-267).

Integers are vectors of canonical base-2^16 digits in int32.  Every branch
of the reference is kept: digit-aligned strides are pure reshapes;
unaligned strides take the residue-class path (coefficients j == r mod P
share one bit offset and sit at an integer digit stride) when the window
fits one stride, else a static-index gather.  Combining sums the
overlapping coefficient windows and ends in one exact non-modular carry
(`canonicalize_plain`, the canonicalize kernel on a GPU tensor)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .fused import fused_canonicalize_plain
from .limb import DIGIT_BITS, DIGIT_MASK


def _offset_classes(bits: int) -> tuple[int, int]:
    """(P, S): coefficient bit offsets (j*bits) mod 16 cycle with period
    P = 16/gcd(bits, 16); within an offset class the start digit advances by
    the integer stride S = P*bits/16."""
    P = DIGIT_BITS // math.gcd(bits, DIGIT_BITS)
    return P, (P * bits) // DIGIT_BITS


def _zeros(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=x.dtype, device=x.device)


def _const(x: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """A host index/shift table on x's device."""
    return torch.as_tensor(arr, device=x.device)


def fft_split_bits(x: torch.Tensor, bits: int, num_coeffs: int, L: int) -> torch.Tensor:
    """Split digit vector x [..., Lx] into (..., num_coeffs, L) ring elements,
    coefficient j = bits [j*bits, (j+1)*bits) of x, zero-padded to L digits.
    Returns canonical digits."""
    Lx = x.shape[-1]
    if bits % DIGIT_BITS == 0:
        d = bits // DIGIT_BITS
        need = num_coeffs * d
        if need > Lx:
            x = torch.cat([x, _zeros(x, x.shape[:-1] + (need - Lx,))], dim=-1)
        seg = x[..., :need].reshape(x.shape[:-1] + (num_coeffs, d))
        return torch.cat([seg, _zeros(x, seg.shape[:-1] + (L - d,))], dim=-1)
    P, S = _offset_classes(bits)
    Lw = -(-bits // DIGIT_BITS)
    if S >= Lw + 1:
        return _split_bits_classes(x, bits, num_coeffs, L, P, S, Lw)
    j = np.arange(num_coeffs, dtype=np.int64)[:, None]
    i = np.arange(L, dtype=np.int64)[None, :]
    pos = j * bits + DIGIT_BITS * i
    q = pos // DIGIT_BITS
    r = (pos % DIGIT_BITS).astype(np.int32)
    # digit i of a coefficient holds bits [16i, 16(i+1)) of a `bits`-bit value
    width = np.clip(bits - DIGIT_BITS * np.arange(L, dtype=np.int64), 0, DIGIT_BITS)
    mask = ((1 << width) - 1).astype(np.int32)[None, :]
    pad = int(q.max()) + 2 - Lx          # so q+1 is always valid
    if pad > 0:
        x = torch.cat([x, _zeros(x, x.shape[:-1] + (pad,))], dim=-1)
    lo = x[..., _const(x, q)]
    hi = x[..., _const(x, q + 1)]
    rr = _const(x, r)
    val = (lo >> rr) | (hi << (DIGIT_BITS - rr))
    return val & _const(x, mask)


def _split_bits_classes(x, bits: int, num_coeffs: int, L: int,
                        P: int, S: int, Lw: int):
    """Gather-free unaligned split.  Class r holds coefficients j = i*P + r:
    start digit b_r + i*S (b_r = floor(r*bits/16)), constant bit offset
    o_r = (r*bits) mod 16.  Requires S >= Lw + 1."""
    lead = x.shape[:-1]
    Lx = x.shape[-1]
    nc = -(-num_coeffs // P)
    need = ((P - 1) * bits) // DIGIT_BITS + nc * S
    if need > Lx:
        x = torch.cat([x, _zeros(x, lead + (need - Lx,))], dim=-1)
    parts = []
    for r in range(P):
        o = (r * bits) % DIGIT_BITS
        b = (r * bits) // DIGIT_BITS
        v = x[..., b : b + nc * S].reshape(lead + (nc, S))[..., : Lw + 1]
        if o:
            w = ((v[..., :Lw] >> o) | (v[..., 1:] << (DIGIT_BITS - o))) & DIGIT_MASK
        else:
            w = v[..., :Lw]
        parts.append(w)
    seg = torch.stack(parts, dim=-2).reshape(lead + (nc * P, Lw))
    seg = seg[..., :num_coeffs, :]
    width = np.clip(bits - DIGIT_BITS * np.arange(Lw, dtype=np.int64), 0, DIGIT_BITS)
    seg = seg & _const(x, ((1 << width) - 1).astype(np.int32))
    return torch.cat([seg, _zeros(x, seg.shape[:-1] + (L - Lw,))], dim=-1)


def fft_combine_bits(c: torch.Tensor, bits: int, Lout: int) -> torch.Tensor:
    """Combine (..., C, L) canonical nonnegative ring coefficients into a
    digit vector [..., Lout]: sum_j c[j] * 2^(j*bits), carried and canonical.
    Requires each coefficient < 2^(16*L) and the true sum < 2^(16*(Lout-1))."""
    C, L = c.shape[-2], c.shape[-1]
    W = DIGIT_BITS * L
    lead = c.shape[:-2]
    if bits % DIGIT_BITS == 0:
        # segment s of coefficient j lands at row j+s of a (C+nseg, d) digit
        # grid: the sum is nseg row-shifted block adds
        d = bits // DIGIT_BITS
        nseg = -(-L // d)
        rows = C + nseg
        grid = _zeros(c, lead + (rows, d))
        for s in range(nseg):
            w = min(d, L - s * d)
            grid[..., s : s + C, :w] += c[..., s * d : s * d + w]
        flat = grid.reshape(lead + (rows * d,))
        if rows * d < Lout:
            flat = torch.cat([flat, _zeros(c, lead + (Lout - rows * d,))], dim=-1)
        return canonicalize_plain(flat[..., :Lout].contiguous())
    P, S = _offset_classes(bits)
    if S >= 2:
        return _combine_bits_classes(c, bits, Lout, P, S)
    K = W // bits + 2
    d = np.arange(Lout, dtype=np.int64)[:, None]
    k = np.arange(K, dtype=np.int64)[None, :]
    j = (DIGIT_BITS * d + DIGIT_BITS - 1) // bits - k           # (Lout, K)
    off = DIGIT_BITS * d - j * bits
    valid = (j >= 0) & (j < C) & (off > -DIGIT_BITS) & (off < W)
    j_safe = np.where(valid, j, 0)
    qq = off >> 4          # floor(off/16), off possibly negative
    rr = (off & 15).astype(np.int32)
    # pad coefficient digits with one zero in front (for qq == -1) and behind
    z = _zeros(c, c.shape[:-1] + (1,))
    cp = torch.cat([z, c, z], dim=-1)                            # [..., C, L+2]
    qq_safe = np.where(valid, qq, -1) + 1                        # index into cp
    hi_valid = valid & (qq_safe + 1 < L + 2)
    flat_lo = np.where(valid, j_safe * (L + 2) + qq_safe, 0)
    flat_hi = np.where(hi_valid, j_safe * (L + 2) + qq_safe + 1, 0)
    cpf = cp.reshape(cp.shape[:-2] + (C * (L + 2),))
    lo = cpf[..., _const(c, flat_lo)]
    hi = torch.where(_const(c, hi_valid), cpf[..., _const(c, flat_hi)], 0)
    rrj = _const(c, rr)
    val = (lo >> rrj) | (hi << (DIGIT_BITS - rrj))
    val = torch.where(_const(c, valid), val & DIGIT_MASK, 0)
    return canonicalize_plain(val.sum(dim=-1, dtype=torch.int32))


def _combine_bits_classes(c: torch.Tensor, bits: int, Lout: int, P: int, S: int):
    """Gather-free unaligned combine (adjoint of _split_bits_classes):
    coefficient j = i*P + r, left-shifted by its class's bit offset o_r,
    lands at digit b_r + i*S; segment t of a class is one contiguous shifted
    add.  Digits stay below K*2^16 for K ~ W/bits overlapping coefficients,
    inside canonicalize_plain's < 2^20 domain for K <= 16."""
    lead = c.shape[:-2]
    C, L = c.shape[-2], c.shape[-1]
    nc = -(-C // P)
    if nc * P > C:
        c = torch.cat([c, _zeros(c, lead + (nc * P - C, L))], dim=-2)
    nseg = -(-(L + 1) // S)
    Lmax = ((P - 1) * bits) // DIGIT_BITS + (nseg - 1) * S + nc * S
    acc = _zeros(c, lead + (max(Lmax, Lout),))
    for r in range(P):
        o = (r * bits) % DIGIT_BITS
        b = (r * bits) // DIGIT_BITS
        rows = c[..., r::P, :]                                   # (nc, L)
        z1 = _zeros(c, lead + (nc, 1))
        if o:
            # digit i of (value << o): low o bits come from digit i-1's top
            lo = (rows << o) & DIGIT_MASK
            hi = rows >> (DIGIT_BITS - o)
            w = torch.cat([lo, z1], dim=-1) + torch.cat([z1, hi], dim=-1)
        else:
            w = torch.cat([rows, z1], dim=-1)
        pad = nseg * S - (L + 1)
        if pad:
            w = torch.cat([w, _zeros(c, lead + (nc, pad))], dim=-1)
        for t in range(nseg):
            seg = w[..., t * S : (t + 1) * S].reshape(lead + (nc * S,))
            start = b + t * S
            acc[..., start : start + nc * S] += seg
    return canonicalize_plain(acc[..., :Lout].contiguous())


def canonicalize_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact non-modular carry canonicalization of a nonnegative redundant
    digit vector (digits < ~2^20); the true value must fit in the vector
    (each row's, for batched input).  The canonicalize kernel on a GPU
    tensor."""
    return fused_canonicalize_plain(x)
