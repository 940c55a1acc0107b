"""Pointwise multiplication mod p = 2^(16L)+1, base case (counterpart of
mpir_fft_tpu/ops/pointwise.py).

A ring element's digits split into base-2^8 chunks; the product is the
negacyclic convolution of the chunk vectors (mod 2^(8*2L)+1 == p), exact in
int32 for 2L <= 4096 chunks.  `negacyclic_conv_chunks` is the plain torch
version; on a GPU tensor `mulmod_base` runs the schoolbook kernel through
ops/pointwise_fused.py instead."""

from __future__ import annotations

import torch

from .limb import _wrap_inject, normmod

CHUNK_BITS = 8
CHUNK_MASK = (1 << CHUNK_BITS) - 1

# The small-prime NTT-CRT leaf (mpir_fft_tpu/ops/ntt.py) is not ported:
# every ring the base serves takes the schoolbook, and utils/params.py
# prices the pointwise as the schoolbook -- the reference's MPIR_FFT_NTT=0.
NTT_AVAILABLE = False

# chunk accumulation bound: |acc| <= 2L * 2^18 < 2^31 needs 2L <= 4096
SCHOOLBOOK_MAX_CHUNKS = 4096


def digits_to_chunks(x: torch.Tensor) -> torch.Tensor:
    """[..., L] digits -> [..., 2L] base-2^8 chunks (signed-safe: the -1
    form maps to chunks (255, -1, 0, ...) == -1)."""
    lo = x & CHUNK_MASK
    hi = (x - lo) >> CHUNK_BITS
    return torch.stack([lo, hi], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def chunks_to_digits(c: torch.Tensor) -> torch.Tensor:
    """[..., 2L] wide int32 chunks -> [..., L] bounded redundant digits.
    Chunk-level negacyclic carry passes first, to avoid overflow."""
    for _ in range(2):
        cc = c >> CHUNK_BITS
        c = (c - (cc << CHUNK_BITS)) + _wrap_inject(cc)
    r = c.reshape(c.shape[:-1] + (c.shape[-1] // 2, 2))
    return r[..., 0] + (r[..., 1] << CHUNK_BITS)


def negacyclic_conv_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic convolution of chunk vectors [..., M]:
    c_k = sum_{i+j=k} a_i b_j - sum_{i+j=k+M} a_i b_j.  Shift-and-accumulate
    over M steps: b negated-and-concatenated ([-b, b]) turns every negacyclic
    shift into a plain slice."""
    M = a.shape[-1]
    bext = torch.cat([-b, b], dim=-1)
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=a.dtype,
                      device=a.device)
    for i in range(M):
        acc += a[..., i : i + 1] * bext[..., M - i : 2 * M - i]
    return acc


def conv_base_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^(16L)+1 as bounded redundant digits, by chunk
    convolution: the plain version of the schoolbook kernel."""
    return chunks_to_digits(negacyclic_conv_chunks(digits_to_chunks(a), digits_to_chunks(b)))


def base_serves(L: int) -> bool:
    """Can mulmod_base serve an L-digit ring?  The schoolbook needs
    2L <= 4096 (int32 accumulation bound); wider rings need the recursive
    Fermat path (not ported)."""
    return 2 * L <= SCHOOLBOOK_MAX_CHUNKS


def mulmod_base(a: torch.Tensor, b: torch.Tensor, canonical: bool = True) -> torch.Tensor:
    """(a * b) mod 2^(16L)+1 on digit vectors [..., L] (broadcast).

    Inputs may be redundant signed digits (|digit| <= ~2^17, the transform
    invariant): chunk products then stay below 2^18 and the accumulation
    below 2L * 2^18, exact in int32 for 2L <= 4096.  With canonical=False
    the result is bounded redundant digits (|digit| < ~2^20), which the
    inverse transform consumes directly."""
    from .pointwise_fused import mulmod_base_fused

    L = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    d = mulmod_base_fused(
        a.expand(shape).reshape(-1, L).contiguous(),
        b.expand(shape).reshape(-1, L).contiguous(),
    ).reshape(shape)
    return normmod(d) if canonical else d
