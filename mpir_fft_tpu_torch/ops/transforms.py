"""Iterative radix-2 DIF transforms over Z/(2^W+1)Z (counterpart of
mpir_fft_tpu/ops/transforms.py).

A transform of length C = x.shape[-2] takes one of two kernel routes:
  * a batch of transforms (x.ndim >= 3) whose (C, L) row fits a
    shared-memory block (ops/fused.py whole_fits) runs whole, one launch of
    the whole-transform kernel (fused_transform) -- the reference's
    `_auto_fusable` rule (transforms.py:50-62) with Hopper's limit: two
    row buffers within a 227 KB block (WHOLE_SMEM_BYTES = 128 KB), not
    Mosaic's L <= 1024 and 512 KB padded-row cap.  This serves the
    recursive mulmod's inner negacyclic transforms ((256, 32), (64, 84),
    (128, 72) rows at 10^8..10^9 bits) and small multiplies;
  * everything else (the MB-sized outer flagship rows) runs as consecutive
    butterfly-ladder groups: each group of kg <= ladder_stages(L) stages is
    one pass over the whole [..., C, L] array, exactly the grouping of the
    reference's ladder path (transforms.py:146-168, 297-318).
Both routes run the same integer sequence (the whole-transform kernel
repeats the ladder groups on its shared-memory row), so their digits agree.

`post_exps` / `pre_exps` (the MFA's cross twiddles, ref transforms.py:106-187,
262-337): an exponent table over the output (input) positions whose entry j
multiplies (divides) position j by 2^e[j].  It rides the innermost stage of
the group that ends at the transform's last stage, as the ladder's table
`pe` (ops/fused.py fused_butterfly_ladder), so a transform with a table
always takes the ladder route (transform_small has no table), as the
reference does when `_stage_fusable` holds.  The table's leading axes
broadcast against x's.

Conventions (identical to the reference):
  * z = 2^w is a 2n-th root of unity; the forward transform is
    decimation-in-frequency with output in revbin order.
  * No scaling inside transforms: ifft(fft(x)) == 2^log2(C) * x.

Not ported yet: the staged options (`pre_half`, `skip_inner`), which wait
for the staged flagship."""

from __future__ import annotations

import numpy as np
import torch

from .fused import fused_butterfly_ladder, fused_transform, ladder_groups, whole_fits
from .limb import shift_mod


def _run(x: torch.Tensor, w: int, W: int, kind: str, pe=None) -> torch.Tensor:
    C, L = x.shape[-2], x.shape[-1]
    D = C.bit_length() - 1
    assert C == 1 << D, "transform length must be a power of two"
    shape = x.shape
    if pe is None and C > 1 and x.ndim >= 3 and whole_fits(C, L):
        return fused_transform(kind, x.reshape(-1, C, L).contiguous(), w, W).reshape(shape)
    x = x.contiguous()
    if pe is not None:
        pe = torch.remainder(torch.as_tensor(pe, device=x.device), 2 * W)
    if D == 0:
        if pe is not None:
            x = shift_mod(x, (pe if kind == "fwd" else -pe)[..., None], W)
        return x
    for l, kg in ladder_groups(C, L, kind):
        K = 1 << kg
        steps = tuple(w << (l + j) for j in range(kg))
        tab = None
        if pe is not None and l + kg == D:
            # the group ending at the last stage (forward: executed last;
            # inverse: first): its innermost stage takes the table
            blk = (1 << l, K // 2, 2)
            tab = pe.to(torch.int32).reshape(pe.shape[:-1] + blk).expand(
                shape[:-2] + blk).reshape(-1, K // 2, 2).contiguous()
        x = fused_butterfly_ladder(
            kind, x.reshape(-1, K, C >> (l + kg), L), steps, W, tab
        ).reshape(shape)
    return x


def fft_radix2(x: torch.Tensor, w: int, W: int, post_exps=None) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] over root z = 2^w; output in
    revbin order: out[j] = X(z^revbin(j)).  With post_exps (an integer table
    [..., C]), output position j is also multiplied by 2^post_exps[j]."""
    return _run(x, w, W, "fwd", post_exps)


def ifft_radix2(x: torch.Tensor, w: int, W: int, pre_exps=None) -> torch.Tensor:
    """Inverse of fft_radix2 (times C): revbin-ordered input, natural-order
    output.  With pre_exps, input position j is first divided by
    2^pre_exps[j]."""
    return _run(x, w, W, "inv", pre_exps)


def revbin_vec(C: int) -> np.ndarray:
    """revbin(j, log2 C) for all j (ref mpir_revbin, mul_fft.c:52-79)."""
    D = C.bit_length() - 1
    assert C == 1 << D
    j = np.arange(C, dtype=np.int64)
    r = np.zeros_like(j)
    for b in range(D):
        r |= ((j >> b) & 1) << (D - 1 - b)
    return r
