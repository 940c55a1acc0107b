"""Iterative radix-2 DIF transforms over Z/(2^W+1)Z (counterpart of
mpir_fft_tpu/ops/transforms.py).

A transform of length C = x.shape[-2] takes one of two kernel routes:
  * a batch of transforms (x.ndim >= 3) whose (C, L) row the whole-row
    transform takes (ops/fused.py whole_fits) runs whole, one launch of it
    (fused_transform): the reference's `_auto_fusable` rule
    (transforms.py:50-62: L <= 1024 and a padded row within 512 KB) and any
    row of at most 64 KB (WHOLE_BUF_BYTES).  A row of at most 64 KB is one
    CTA, four of which share an SM (the recursive mulmod's inner negacyclic
    transforms, (256, 32), (256, 48), (256, 64), (128, 72) rows at
    10^8..1.6x10^9 bits); a wider one (64-512 KB: the flat pair of
    `mul` / `sqr` at about 1.2-8x10^5 bits, the MFA rows at L 512 / 1024)
    one CTA of up to 227 KB or a thread-block cluster of 2, 4 or 8 CTAs
    (ops/fused.py whole_cluster: the fewest CTAs that hold the row,
    doubled while the batch would fill at most half the card's SMs);
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

The half-bit options (ref transforms.py:106-127, :190-319, and the
negacyclic weights of ops/negacyclic.py):
  * `pre_half = (e0, step2)` on fft_radix2: input position j is first
    multiplied by 2^((e0 + j*step2)/2).  It rides the transform's one
    launch: the whole-transform kernel's load, or the first ladder group
    (the ladder's own option); only a length-1 transform takes a
    twiddle_half pass.
  * `post_half = (e0, step2)` on ifft_radix2: output position j is then
    multiplied by 2^((e0 + j*step2)/2).  On the whole route it rides the
    kernel's store; on the ladder route it is one twiddle_half pass after
    the last group.
  * `skip_inner` on ifft_radix2: the innermost skip_inner stages already
    ran chunk-locally (ifft_innermost, or inside the Garner kernel), so the
    ladder groups start above them.  Such a transform always takes the
    ladder route.  inner_group(C, L) is the stage count of the first
    inverse ladder group (ladder_groups), so the skipped stages and the
    groups that still run line up; it depends on L (4 up to L 1024, 3 at
    L 2048, 2 at L 4096), where the reference's is min(4, log2 C) at any L,
    so raw digits may differ from the reference's, not values mod p."""

from __future__ import annotations

import numpy as np
import torch

from .fused import (fused_butterfly_ladder, fused_transform, fused_twiddle_half, ladder_groups,
                    ladder_plain, whole_fits)
from .limb import shift_mod


def _run(x: torch.Tensor, w: int, W: int, kind: str, pe=None, pre_half=None,
         skip_inner: int = 0, post_half=None) -> torch.Tensor:
    C, L = x.shape[-2], x.shape[-1]
    D = C.bit_length() - 1
    assert C == 1 << D, "transform length must be a power of two"
    assert 0 <= skip_inner <= D and (skip_inner == 0 or pe is None)
    shape = x.shape
    whole = pe is None and skip_inner == 0 and C > 1 and x.ndim >= 3 and whole_fits(C, L)
    if whole:
        return fused_transform(kind, x.reshape(-1, C, L).contiguous(), w, W, pre_half,
                               post_half).reshape(shape)
    return ladder_transform(x, w, W, kind, pe, pre_half, skip_inner, post_half)


def ladder_transform(x: torch.Tensor, w: int, W: int, kind: str, pe=None, pre_half=None,
                     skip_inner: int = 0, post_half=None) -> torch.Tensor:
    """The ladder route of _run for any x: one fused_butterfly_ladder launch
    per ladder group (the table on the group ending at the last stage, the
    forward weights in the first), a twiddle_half pass for a length-1
    transform's pre_half and after the inverse for post_half."""
    C, L = x.shape[-2], x.shape[-1]
    D = C.bit_length() - 1
    shape = x.shape
    x = x.contiguous()
    if pre_half is not None and D == 0:
        x = fused_twiddle_half(x, *pre_half, W)
        pre_half = None
    if pe is not None:
        pe = torch.remainder(torch.as_tensor(pe, device=x.device), 2 * W)
    if D == 0:
        if pe is not None:
            x = shift_mod(x, (pe if kind == "fwd" else -pe)[..., None], W)
    for l, kg in ladder_groups(C, L, kind, skip_inner):
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
            kind, x.reshape(-1, K, C >> (l + kg), L), steps, W, tab,
            pre_half=pre_half if l == 0 else None,
        ).reshape(shape)
    if post_half is not None:
        x = fused_twiddle_half(x, *post_half, W)
    return x


def fft_radix2(x: torch.Tensor, w: int, W: int, post_exps=None,
               pre_half: tuple[int, int] | None = None) -> torch.Tensor:
    """Forward DIF FFT of length C = x.shape[-2] over root z = 2^w; output in
    revbin order: out[j] = X(z^revbin(j)).  With post_exps (an integer table
    [..., C]), output position j is also multiplied by 2^post_exps[j].  With
    pre_half = (e0, step2), input position j is first multiplied by
    2^((e0 + j*step2)/2) (the sqrt2 top layer's t-leg twiddle, the
    negacyclic weights)."""
    return _run(x, w, W, "fwd", post_exps, pre_half)


def ifft_radix2(x: torch.Tensor, w: int, W: int, pre_exps=None,
                skip_inner: int = 0, post_half: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverse of fft_radix2 (times C): revbin-ordered input, natural-order
    output.  With pre_exps, input position j is first divided by
    2^pre_exps[j].  skip_inner: the innermost skip_inner stages already ran
    (ifft_innermost, possibly on a different nominal length: the even-w
    sqrt2 inverse skips inner_group(C/2, L) stages of its length-C
    transform, the same stages).  With post_half = (e0, step2), output
    position j is then multiplied by 2^((e0 + j*step2)/2) (the negacyclic
    unweighting)."""
    return _run(x, w, W, "inv", pre_exps, skip_inner=skip_inner, post_half=post_half)


def revbin_iota(C: int, device=None) -> torch.Tensor:
    """revbin(j, log2 C) for all j as an int64 tensor (the reference's
    traced revbin_iota, transforms.py:95; revbin_vec on the host)."""
    return torch.from_numpy(revbin_vec(C)).to(device)


def fft_radix2_twiddle(x: torch.Tensor, w: int, W: int, ws: int, c: int) -> torch.Tensor:
    """fft_radix2 followed by out[j] *= 2^(ws * revbin(j) * c): the MFA column
    transform (the reference's fft_radix2_twiddle, transforms.py:340, ref
    FFT_radix2_twiddle with r = 0, rs = 1), its table on the ladder's `pe`
    option."""
    pe = (revbin_iota(x.shape[-2], x.device) * (ws * c)) % (2 * W)
    return fft_radix2(x, w, W, post_exps=pe)


def ifft_radix2_twiddle(x: torch.Tensor, w: int, W: int, ws: int, c: int) -> torch.Tensor:
    """Inverse of fft_radix2_twiddle (times 2^D): position j divided by
    2^(ws * revbin(j) * c), then the inverse transform (ref
    IFFT_radix2_twiddle)."""
    pe = (revbin_iota(x.shape[-2], x.device) * (ws * c)) % (2 * W)
    return ifft_radix2(x, w, W, pre_exps=pe)


def inner_group(C: int, L: int) -> int:
    """Stage count of ifft_radix2's first-executed (innermost) ladder group
    on a length-C transform at digit width L (0 at C == 1): the stages
    whose butterfly pairs lie within contiguous 2^kg position blocks."""
    groups = ladder_groups(C, L, "inv")
    return groups[0][1] if groups else 0


def inner_steps(w: int, C: int, kg: int) -> tuple:
    """Stage exponents of the innermost kg inverse stages of a length-C
    transform at root 2^w (stages D - kg .. D - 1)."""
    D = C.bit_length() - 1
    return tuple(w << (D - kg + j) for j in range(kg))


def ifft_innermost(v: torch.Tensor, w: int, W: int, C: int) -> torch.Tensor:
    """Apply ONLY the innermost inner_group(C, L) inverse stages of the
    length-C ifft_radix2 at root 2^w to row chunks v [..., R, L], R a
    multiple of K = 2^inner_group(C, L): those stages pair positions within
    contiguous K-blocks, so they are chunk-local.  The staged flagship's
    pointwise runs them on each spectrum chunk (one ladder launch, or
    inside the Garner kernel: ops/ntt.py garner_post), and the whole-slab
    inverse skips them (skip_inner).  The flat-transform analogue of the
    reference's pointwise-into-inverse fusion (mul_fft.c:2745-2923)."""
    L = v.shape[-1]
    kg = inner_group(C, L)
    if kg == 0:
        return v
    K = 1 << kg
    assert v.shape[-2] % K == 0, (tuple(v.shape), K)
    return fused_butterfly_ladder("inv", v.contiguous().reshape(-1, K, 1, L),
                                  inner_steps(w, C, kg), W).reshape(v.shape)


def ifft_innermost_body(v: torch.Tensor, steps, W: int, K: int) -> torch.Tensor:
    """The plain version of ifft_innermost on [..., R, L] (R a multiple of
    K = 2^len(steps)): the inverse ladder group of stage exponents steps on
    each K-row block (ladder_plain at h == 1).  The Garner kernels' post leg
    repeats this integer sequence (ops/ntt.py garner_post)."""
    L = v.shape[-1]
    assert v.shape[-2] % K == 0 and K == 1 << len(steps), (tuple(v.shape), K, steps)
    return ladder_plain("inv", v.reshape(-1, K, 1, L), tuple(steps), W).reshape(v.shape)


def revbin_vec(C: int) -> np.ndarray:
    """revbin(j, log2 C) for all j (ref mpir_revbin, mul_fft.c:52-79)."""
    D = C.bit_length() - 1
    assert C == 1 << D
    j = np.arange(C, dtype=np.int64)
    r = np.zeros_like(j)
    for b in range(D):
        r |= ((j >> b) & 1) << (D - 1 - b)
    return r
