"""Wrapper of the schoolbook pointwise kernel (counterpart of
mpir_fft_tpu/ops/pointwise_fused.py; kernel: csrc/conv_base.cu).

The kernel forms the product from separated lo/hi byte planes:

    a = alo + 2^8 ahi,  b = blo + 2^8 bhi   (per base-2^16 digit position)
    c = conv(alo,blo) + 2^8 (conv(alo,bhi)+conv(ahi,blo)) + 2^16 conv(ahi,bhi)

negacyclic over digit positions (2^(16L) == -1), then one carry pass.  With
redundant inputs |digit| <= ~2^17 every accumulator stays below ~2^29 for
L <= 2048 -- exact in int32."""

from __future__ import annotations

import torch

from .. import kernels
from .fused import _require
from .pointwise import SCHOOLBOOK_MAX_CHUNKS, conv_base_plain


def mulmod_base_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^(16L)+1 over a 2-D batch (B, L) of redundant digit
    vectors -> bounded redundant digits.  CPU tensors take the chunk
    convolution (conv_base_plain); CUDA tensors the schoolbook kernel."""
    _require(a, "conv_base", ndim=2)
    _require(b, "conv_base", ndim=2)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"conv_base: operands differ: {tuple(a.shape)} on {a.device} "
                         f"vs {tuple(b.shape)} on {b.device}")
    B, L = a.shape
    if 2 * L > SCHOOLBOOK_MAX_CHUNKS:
        raise ValueError(f"conv_base: L={L} exceeds the int32 accumulation bound")
    if a.device.type == "cpu":
        return conv_base_plain(a, b)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = kernels.lib().mf_conv_base(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L, kernels.stream_of(a))
    kernels.check(rc, "conv_base")
    kernels.LAUNCHES["conv_base"] += 1
    return out
