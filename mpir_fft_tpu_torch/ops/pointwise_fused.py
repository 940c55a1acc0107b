"""Wrapper of the schoolbook pointwise kernel (counterpart of
mpir_fft_tpu/ops/pointwise_fused.py; kernel: csrc/conv_base.cu).

The kernel accumulates the negacyclic digit convolution

    c_j = sum_i a_i b_(j-i)     (a wrapped term negated: 2^(16L) == -1)

in fp64, one fused multiply-add a digit product, exact while L max|a|
max|b| < 2^53 (with redundant inputs |digit| <= ~2^17, below 2^45 for
L <= 2048); then it splits each c_j into 16-bit pieces and recombines them
with one carry pass into digits in (-2^6, 2^16 + 2^6).  Short rows (L up
to the library's mf_conv_base_short_max()) run several to a warp, longer
ones a CTA each; the C side picks the layout from L."""

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
        raise ValueError(f"conv_base: L={L} is past the schoolbook's rings "
                         f"(2L <= {SCHOOLBOOK_MAX_CHUNKS}, pointwise.base_serves)")
    if a.device.type == "cpu":
        return conv_base_plain(a, b)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = kernels.lib().mf_conv_base(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L, kernels.stream_of(a))
    kernels.check(rc, "conv_base")
    kernels.LAUNCHES["conv_base"] += 1
    return out
