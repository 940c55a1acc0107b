"""2-D Matrix Fourier Algorithm transforms, plain, truncated and sqrt2
(counterpart of mpir_fft_tpu/ops/mfa.py; ref FFT_radix2_mfa mul_fft.c:2021,
IFFT_radix2_mfa :2411, FFT/IFFT_radix2_mfa_truncate :2357, :2925, and the
production pair FFT_radix2_mfa_truncate_sqrt2 :2212 / its inverse :2593).

A length C = n1*n2 transform becomes n1 column FFTs of length n2 (root
z^n1) with the cross twiddles z^(k2*j1) fused into the columns' last stage,
then n2 row FFTs of length n1 (root z^n2).  Coefficient j lives at cell
(j2, j1), j = j2*n1 + j1; the inverse consumes the forward's layout
directly, so no revbin reordering is needed.  Truncation: trunc2 counts
kept ROWS (trunc = trunc2 * n1 coefficients); columns are row-truncated and
only the first trunc2 rows get row transforms.

The passes on the card:
  * columns (_run_cols): one launch of the column kernel (ops/fused.py
    fused_mfa_cols, csrc/mfa_cols.cu: one CTA a column, or a cluster of 2,
    4 or 8) for every column the reference fuses (mfa_col_fits: L <= 1024,
    truncated or full within 512 KB) that a cluster of 8 holds
    (mfa_col_cluster), else the truncate.py recursion with
    the cross table on the ladder (its `pe` option), as the reference does
    (mfa.py:131-142);
  * rows: fft_radix2 / ifft_radix2 at root w*n2 -- the whole-row
    transform for every (n1, L) row the reference fuses and every row of at
    most 64 KB (whole_fits: the 6.3x10^7 x 5x10^6 plan's (128, 512) rows
    on clusters of CTAs), the ladder otherwise.

The staged flagship's pieces (ref mfa.py:197-263, :337-387): `ifft_mfa_rows`
runs just the row-IFFT leg on chunks of whole rows, and `rows_done=True`
tells the inverses that it already ran; at the full length the flat
dispatch maps it to `skip_inner` (the innermost ladder group, which ran in
the pointwise).

Sharded (`ctx`, a parallel.mfa_sharded.ShardCtx over the ranks of a
torch.distributed group; the reference's `con`, `_shard_ctx`,
`_local_cols` and the sharded branches of `_run_cols` / `_run_rows`,
mfa.py:77-182).  Every rank calls with the same replicated input; rank r
transforms columns [r n1/ndev, (r+1) n1/ndev) (ndev must divide n1), the
global column entering the cross twiddles as the reference's `off`; the
kept rows of every MFA of the call cross to rows in ONE all-to-all
(`ctx.to_rows`), each padded with zero rows to a multiple of ndev (the
reference's pad, mfa.py:157-161), and rank r row-transforms its share.  A
forward under ctx returns the rank's rows [..., P, n1, L] (the sqrt2
composite: flat [..., P n1, L]), which the pointwise takes as they are: it
is position-wise, and each of them is a whole row of n1.  An inverse takes
them back (`ctx.to_cols`, one all-to-all), and returns the rank's column
block [..., n1/ndev, n2, L] (the MFA inverses) or, through `ctx.gather`,
the whole flat result on every rank (the sqrt2 composite).  At trunc == 4n
the sharded composites take the MFA, never the flat pair: the column axis
is the shard axis (the reference's gate, mfa.py:308, :355)."""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import count_copy
from .fused import fused_mfa_cols, fused_sqrt2_top_inv, mfa_col_cluster, mfa_col_fits
from .limb import carry_pass, mul_2expmod, normmod_div
from .sqrt2 import (_fft_trunc_sqrt2, _ifft_trunc_sqrt2, _sqrt2_top_fwd, _sqrt2_top_inv,
                    ifft_sqrt2, twiddle_half)
from .transforms import fft_radix2, ifft_radix2, inner_group, revbin_vec
from .truncate import _cat, truncated


def _cat3(*parts: torch.Tensor) -> torch.Tensor:
    """Concat along axis -3, dropping zero-length parts; a copy is counted."""
    parts = [p for p in parts if p.shape[-3] > 0]
    if len(parts) == 1:
        return parts[0]
    return count_copy(torch.cat(parts, dim=-3))


def _block_cross_exps(rows: int, st: int, n1_mask: int, n2: int, w: int, W: int,
                      device=None, off: int = 0) -> torch.Tensor:
    """Cross exps for `rows` consecutive flat batch rows from st: the column
    of flat row r is off + (r & n1_mask), masked after adding the offset,
    because a block may span more than one copy of the column axis (masking
    the start alone mis-twiddled every row past the wrap;
    tests/test_mfa.py:173); `off` is a block's first global column (a
    rank's share, the reference's shard_map `off`)."""
    j1 = off + ((st + torch.arange(rows, dtype=torch.int64, device=device)[:, None]) & n1_mask)
    rb = torch.from_numpy(revbin_vec(n2)).to(device)
    return (w * rb[None, :] * j1) % (2 * W)


def _cross_exps(n1: int, n2: int, w: int, W: int, device=None) -> torch.Tensor:
    """exps[j1, j2p] = w * revbin(j2p, log n2) * j1 mod 2W: the z^(k2*j1)
    cross twiddle of column j1 at column-output position j2p (int64)."""
    return _block_cross_exps(n1, 0, n1 - 1, n2, w, W, device)


def _run_cols(xc: torch.Tensor, kind: str, w: int, W: int, trunc2: int,
              no_zero_tail: bool = False, n1: int | None = None, off: int = 0) -> torch.Tensor:
    """Column pass over xc [..., cols, n2, L]: the truncated transform of
    `kind` and flavour at trunc2 rows (full at trunc2 == n2) of each column
    at root w*n1 with its cross twiddles.  Leading axes flatten into the
    column kernel's batch.  The columns are all n1 (n1 None), or a rank's
    block of them from global column `off`.  The columns the reference
    fuses take the kernel, all but those no cluster of 8 CTAs holds
    (truncated, past 1.5 MB: no plan gives them), which take the recursion
    as the rest do."""
    cols, n2, L = xc.shape[-3:]
    n1 = n1 or cols
    if mfa_col_fits(n2, L, trunc2 == n2) and mfa_col_cluster(n2, L):
        flat = xc.contiguous().reshape(-1, n2, L)
        return fused_mfa_cols(kind, flat, w, W, n1, trunc2, no_zero_tail,
                              block=None if cols == n1 else (off, cols)).reshape(xc.shape)
    pe = _block_cross_exps(cols, 0, cols - 1, n2, w, W, xc.device, off)
    return truncated(kind, no_zero_tail)(xc, w * n1, W, trunc2, pe)


def _swap(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-3, -2).contiguous()


# ---------------------------------------------------------------------------
# The sharded passes (ctx: parallel.mfa_sharded.ShardCtx)
# ---------------------------------------------------------------------------

def _rank_cols(x: torch.Tensor, ctx) -> tuple[torch.Tensor, int]:
    """The rank's columns of x [..., m2, n1, L] (the same on every rank) as
    a column block [..., n1/ndev, m2, L], and its first column."""
    nl = ctx.local(x.shape[-2])
    off = ctx.rank * nl
    return x[..., off:off + nl, :].transpose(-3, -2).contiguous(), off


def _shares(t2s, ndev: int) -> list[int]:
    """A rank's rows of each kept-row count t2: cdiv(t2, ndev) (zero rows
    pad t2 to ndev such shares)."""
    return [-(-t2 // ndev) for t2 in t2s]


def _fwd_sharded(segs, W: int, n1: int, row_w: int, ctx) -> torch.Tensor:
    """The forward MFAs segs = [(y, v, t2, one)] under ctx: y [..., m2, n1,
    L] on every rank, its columns at root v*n1 truncated to t2 rows
    (fft_trunc1's flavour with one), the rows at root row_w.  Rank r
    transforms its columns; the kept rows of every segment cross to rows in
    ONE all-to-all, each t2 padded with zero rows to ndev shares of
    cdiv(t2, ndev), segment after segment in a share; rank r
    row-transforms its share -> [..., sum of the shares, n1, L]."""
    ndev, blocks = ctx.ndev, []
    for (y, v, t2, one), p in zip(segs, _shares([s[2] for s in segs], ndev)):
        yc, off = _rank_cols(y, ctx)
        yc = _run_cols(yc, "fwd", v, W, t2, one, n1, off)[..., :t2, :]
        if p * ndev > t2:
            yc = _cat(yc, yc.new_zeros(yc.shape[:-2] + (p * ndev - t2, yc.shape[-1])))
        blocks.append(yc.reshape(yc.shape[:-2] + (ndev, p, yc.shape[-1])))
    xc = torch.cat(blocks, dim=-2) if len(blocks) > 1 else blocks[0]
    return fft_radix2(ctx.to_rows(xc.reshape(xc.shape[:-3] + (-1, xc.shape[-1]))), row_w, W)


def _inv_sharded(v: torch.Tensor, t2s, W: int, n1: int, row_w: int, ctx,
                 rows_done: bool) -> list[torch.Tensor]:
    """The inverse's first legs under ctx on the rank's rows v [..., P, n1,
    L] (_fwd_sharded's layout for segments of t2s kept rows): the row IFFTs
    at root row_w (unless rows_done), ONE all-to-all back to columns, and
    each segment's column block [..., n1/ndev, t2, L] of spectrum rows."""
    if not rows_done:
        v = ifft_radix2(v, row_w, W)
    ndev, P, L = ctx.ndev, v.shape[-3], v.shape[-1]
    c = ctx.to_cols(v)
    c = c.reshape(c.shape[:-2] + (ndev, P, L))
    out, at = [], 0
    for t2, p in zip(t2s, _shares(t2s, ndev)):
        out.append(c[..., at:at + p, :].reshape(c.shape[:-3] + (ndev * p, L))[..., :t2, :])
        at += p
    assert at == P, (t2s, P)
    return out


def _inv_cols(head: torch.Tensor, w: int, W: int, n1: int, m2: int, t2: int, one: bool,
              off: int, tail: torch.Tensor | None = None) -> torch.Tensor:
    """The column inverse of a rank's block from global column off: head
    [..., nl, t2, L] its row-IFFTed spectrum rows; past t2 zero (the plain
    flavour) or, with one, tail [..., nl, m2 - t2, L], the unscaled
    coefficients there, scaled by n1 as in mfa_ifft_trunc."""
    if t2 < m2:
        if tail is None:
            tail = head.new_zeros(head.shape[:-2] + (m2 - t2, head.shape[-1]))
        elif one:
            tail = mul_2expmod(tail, n1.bit_length() - 1, W)
        head = _cat(head, tail)
    return _run_cols(head, "inv", w, W, t2, one, n1, off)


def _gather_cells(c: torch.Tensor, ctx) -> torch.Tensor:
    """The whole flat [..., m2 n1, L] array on every rank from the ranks'
    column blocks c [..., n1/ndev, m2, L]: one all-gather."""
    return _flat(_swap(ctx.gather(c, -3)))


def fft_radix2_mfa(x: torch.Tensor, w: int, W: int, n1: int, n2: int, ctx=None) -> torch.Tensor:
    """Forward 2-D MFA: x [..., n2, n1, L] -> the same shape, transformed.
    Under ctx: the rank's rows [..., cdiv(n2, ndev), n1, L]."""
    if ctx is not None:
        return _fwd_sharded([(x, w, n2, False)], W, n1, w * n2, ctx)
    xc = _run_cols(_swap(x), "fwd", w, W, n2)       # [..., n1, n2, L]: columns
    return fft_radix2(_swap(xc), w * n2, W)           # [..., n2, n1, L]: rows


def ifft_mfa_rows(v: torch.Tensor, row_w: int, W: int, n1: int) -> torch.Tensor:
    """Just the row-IFFT leg of the inverse MFA over flat [..., R, L] chunks
    (R a multiple of n1): the first pass every spectrum position < trunc
    takes, in both w parities (root w*n2 == (w//2)*(2*n2)).  Chunk-local,
    so the staged flagship runs it on each pointwise chunk (ref
    mfa.py:197-208), a rank's rows too."""
    R, L = v.shape[-2], v.shape[-1]
    assert R % n1 == 0, (tuple(v.shape), n1)
    return ifft_radix2(v.reshape(v.shape[:-2] + (R // n1, n1, L)), row_w, W).reshape(v.shape)


def ifft_radix2_mfa(x: torch.Tensor, w: int, W: int, n1: int, n2: int,
                    rows_done: bool = False, ctx=None) -> torch.Tensor:
    """Inverse 2-D MFA (times n1*n2): row IFFTs, then column IFFTs with the
    cross twiddles divided out before their first stage.  rows_done: the
    row IFFTs already ran (ifft_mfa_rows).  Under ctx x is the rank's rows
    (fft_radix2_mfa's under ctx) and the result its column block [...,
    n1/ndev, n2, L]."""
    if ctx is not None:
        (head,) = _inv_sharded(x, [n2], W, n1, w * n2, ctx, rows_done)
        return _inv_cols(head, w, W, n1, n2, n2, False, ctx.rank * ctx.local(n1))
    xr = x if rows_done else ifft_radix2(x, w * n2, W)
    return _swap(_run_cols(_swap(xr), "inv", w, W, n2))


def mfa_fft_trunc(x: torch.Tensor, w: int, W: int, n1: int, n2: int, trunc2: int,
                  no_zero_tail: bool = False, ctx=None) -> torch.Tensor:
    """Truncated forward MFA: only the first trunc2 output rows are valid.
    With no_zero_tail, input rows >= trunc2 are arbitrary (truncate1
    semantics); otherwise they must be zero.  Under ctx: the rank's share
    of the trunc2 kept rows, [..., cdiv(trunc2, ndev), n1, L]."""
    assert 1 <= trunc2 <= n2
    if ctx is not None:
        return _fwd_sharded([(x, w, trunc2, no_zero_tail)], W, n1, w * n2, ctx)
    xr = _swap(_run_cols(_swap(x), "fwd", w, W, trunc2, no_zero_tail))
    head = fft_radix2(xr[..., :trunc2, :, :], w * n2, W)
    return _cat3(head, xr[..., trunc2:, :, :])


def mfa_ifft_trunc(v: torch.Tensor, w: int, W: int, n1: int, n2: int, trunc2: int,
                   no_zero_tail: bool = False, rows_done: bool = False,
                   ctx=None) -> torch.Tensor:
    """Truncated inverse MFA (times n1*n2 on the first trunc2 rows).  Plain
    flavour: the coefficient rows >= trunc2 are zero; no_zero_tail: input
    rows >= trunc2 hold the unscaled coefficients (cell (j2, j1) =
    x_{j2 n1 + j1}), as truncate.ifft_trunc1.  rows_done: the first trunc2
    rows already went through ifft_mfa_rows.  Under ctx (plain flavour
    only; the sharded sqrt2 composite supplies its own tail) v is the
    rank's rows (mfa_fft_trunc's under ctx) and the result its column
    block [..., n1/ndev, n2, L]."""
    assert 1 <= trunc2 <= n2
    if ctx is not None:
        if no_zero_tail:
            raise ValueError("mfa_ifft_trunc: no_zero_tail takes no ShardCtx")
        (head,) = _inv_sharded(v, [trunc2], W, n1, w * n2, ctx, rows_done)
        return _inv_cols(head, w, W, n1, n2, trunc2, False, ctx.rank * ctx.local(n1))
    head = v[..., :trunc2, :, :]
    if not rows_done:
        head = ifft_radix2(head, w * n2, W)
    tail = v[..., trunc2:, :, :]
    if no_zero_tail and trunc2 < n2:
        # the row IFFTs scaled the head by n1; scale the known coefficients
        # to match, so the columns' ifft_trunc1 sees one uniform factor
        tail = mul_2expmod(tail, n1.bit_length() - 1, W)
    xc = _run_cols(_swap(_cat3(head, tail)), "inv", w, W, trunc2, no_zero_tail)
    return _swap(xc)


# ---------------------------------------------------------------------------
# sqrt2 composites at length 4n = 2 * (n1 * n2): flat [..., 4n, L] arrays,
# each half in MFA (n2, n1) cell layout (forward and inverse agree, and the
# pointwise stage is position-wise, so no reordering is needed)
# ---------------------------------------------------------------------------

def _as2d(x: torch.Tensor, n2: int, n1: int) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (n2, n1, x.shape[-1]))


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-3] + (x.shape[-3] * x.shape[-2], x.shape[-1]))


def _cells(fn, n1: int):
    """fn(y2, n2, ...) on a flat [..., n2*n1, L] array viewed as its (n2, n1)
    cells, flat again."""
    def run(y, *args):
        n2 = y.shape[-2] // n1
        return _flat(fn(_as2d(y, n2, n1), n2, *args))
    return run


def _segments(C: int, w: int, n1: int, trunc: int) -> list[tuple[int, int, int, bool]]:
    """The MFAs of the length-C sqrt2 composite truncated at trunc, as the
    sharded composites run them: (m2 rows of n1, t2 kept, root v, one) each
    -- even w one MFA of the whole length at root w/2 (ref
    mul_fft.c:850-855); odd w the left half, and past h the right half's
    truncate1 MFA."""
    h = C // 2
    n2 = h // n1
    if w % 2 == 0:
        return [(2 * n2, trunc // n1, w // 2, False)]
    if trunc <= h:
        return [(n2, trunc // n1, w, False)]
    return [(n2, n2, w, False), (n2, (trunc - h) // n1, w, True)]


def _fft_trunc_sqrt2_sharded(x: torch.Tensor, w: int, W: int, n1: int, trunc: int,
                             ctx) -> torch.Tensor:
    """mfa_fft_trunc_sqrt2 under ctx: the top layer (odd w past h) on the
    whole halves on every rank (its inputs are there), both halves' kept
    rows in one all-to-all (_fwd_sharded)."""
    C = x.shape[-2]
    segs = _segments(C, w, n1, trunc)
    ys = _sqrt2_top_fwd(x, w, W) if len(segs) == 2 else (x[..., :segs[0][0] * n1, :],)
    parts = [(_as2d(y, m2, n1), v, t2, one) for y, (m2, t2, v, one) in zip(ys, segs)]
    return _flat(_fwd_sharded(parts, W, n1, w * (C // 2 // n1), ctx))


def _ifft_trunc_sqrt2_sharded(v: torch.Tensor, w: int, W: int, n1: int, trunc: int, C: int,
                              norm_div: int, rows_done: bool, ctx) -> torch.Tensor:
    """mfa_ifft_trunc_sqrt2 under ctx: one all-to-all back to columns for
    both halves, the column inverses on the rank's block, then the ranks'
    blocks gathered whole onto every rank, where the top merge (odd w past
    h: its twiddles are affine in the flat position, which a block's are
    not) runs on the whole halves with the norm tail; elsewhere the norm
    tail runs on the blocks before the one gather.  Below the full length
    with odd w the left half is gathered first, for the right half's
    reconstructed tail (twiddle_half over its flat positions), and the
    right half after it: two gathers there, one everywhere else."""
    h = C // 2
    n2, L = h // n1, v.shape[-1]
    segs = _segments(C, w, n1, trunc)
    off = ctx.rank * ctx.local(n1)
    heads = _inv_sharded(v.reshape(v.shape[:-2] + (-1, n1, L)), [s[1] for s in segs], W, n1,
                         w * n2, ctx, rows_done)

    def nd(x):
        return normmod_div(x, norm_div, W) if norm_div else x

    if len(segs) == 1:
        m2, t2, vw, _ = segs[0]
        c = _inv_cols(heads[0], vw, W, n1, m2, t2, False, off)
        if w % 2:
            # odd w, trunc <= h: the result is twice the left half's
            c = carry_pass(c + c)
        return _gather_cells(nd(c), ctx)
    k = trunc - h
    k2 = k // n1
    sl = _inv_cols(heads[0], w, W, n1, n2, n2, False, off)
    if k == h:
        o = _inv_cols(heads[1], w, W, n1, n2, n2, True, off)
        both = _gather_cells(torch.stack([sl, o], dim=-4), ctx)
        return fused_sqrt2_top_inv(both.reshape(both.shape[:-3] + (C, L)), w, W,
                                   norm_div=norm_div)
    sL = _gather_cells(sl, ctx)
    # the missing right inputs, unscaled, as _ifft_trunc_sqrt2 builds them
    tail = twiddle_half(sL[..., k:, :], np.arange(k, h, dtype=np.int64) * w
                        - 2 * (h.bit_length() - 1), W)
    tail, _ = _rank_cols(_as2d(tail, n2 - k2, n1), ctx)
    oR = _gather_cells(_inv_cols(heads[1], w, W, n1, n2, k2, True, off, tail), ctx)
    xa, xb = _sqrt2_top_inv(sL[..., :k, :], oR[..., :k, :], w, W, norm_div=norm_div)
    return _cat(xa, nd(carry_pass(sL[..., k:, :] + sL[..., k:, :])), xb)


def mfa_fft_trunc_sqrt2(x: torch.Tensor, w: int, W: int, n1: int, trunc: int,
                        ctx=None) -> torch.Tensor:
    """Truncated length-4n forward transform over root sqrt2^w with MFA
    halves (for even w one length-4n MFA at root 2^(w/2), ref
    mul_fft.c:850-855).  x flat [..., 4n, L], zero past trunc; trunc a
    multiple of n1.  Valid outputs: positions < trunc.  At trunc == 4n the
    flat transform (fft_sqrt2) runs, as in the reference (mfa.py:308-317),
    unless sharded: under ctx (x the same on every rank) the MFA runs at
    every trunc and the result is the rank's rows [..., P n1, L]."""
    assert trunc % n1 == 0
    if ctx is not None:
        return _fft_trunc_sqrt2_sharded(x, w, W, n1, trunc, ctx)
    return _fft_trunc_sqrt2(
        x, w, W, trunc,
        _cells(lambda y, n2, v: fft_radix2_mfa(y, v, W, n1, n2), n1),
        _cells(lambda y, n2, v, t, one: mfa_fft_trunc(y, v, W, n1, n2, t // n1, one), n1))


def mfa_ifft_trunc_sqrt2(v: torch.Tensor, w: int, W: int, n1: int, trunc: int,
                         norm_div: int = 0, rows_done: bool = False, ctx=None,
                         C: int | None = None) -> torch.Tensor:
    """Inverse of mfa_fft_trunc_sqrt2 (times 4n on positions < trunc;
    positions >= trunc unspecified).  norm_div > 0 folds the drivers'
    divide-by-2^norm_div + normmod tail into the last pass over each
    position.  rows_done: positions < trunc already took the chunk-local
    first leg -- below the full length the row IFFTs (ifft_mfa_rows, root
    w * n2); at trunc == 4n, the flat dispatch, the innermost ladder group
    (transforms.ifft_innermost at length 2n), skipped here as skip_inner
    (ref mfa.py:337-369).  Under ctx: v is the rank's rows (the forward's
    under ctx, rows_done meaning the row IFFTs at every trunc), C the
    transform length, and the result whole on every rank, at least trunc
    positions."""
    assert trunc % n1 == 0
    if ctx is not None:
        return _ifft_trunc_sqrt2_sharded(v, w, W, n1, trunc, C, norm_div, rows_done, ctx)
    C = v.shape[-2]
    if trunc == C:
        skip = inner_group(C // 2, v.shape[-1]) if rows_done else 0
        return ifft_sqrt2(v, w, W, norm_div=norm_div, skip_inner=skip)
    return _ifft_trunc_sqrt2(
        v, w, W, trunc, norm_div,
        _cells(lambda y, n2, u: ifft_radix2_mfa(y, u, W, n1, n2, rows_done), n1),
        _cells(lambda y, n2, u, t, one: mfa_ifft_trunc(y, u, W, n1, n2, t // n1, one,
                                                       rows_done), n1))
