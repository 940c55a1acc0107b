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
  * rows: fft_radix2 / ifft_radix2 at root w*n2 -- the whole-transform
    kernel when an (n1, L) row fits (whole_fits), the ladder otherwise.

The staged flagship's pieces (ref mfa.py:197-263, :337-387): `ifft_mfa_rows`
runs just the row-IFFT leg on chunks of whole rows, and `rows_done=True`
tells the inverses that it already ran; at the full length the flat
dispatch maps it to `skip_inner` (the innermost ladder group, which ran in
the pointwise).

Not ported here: the sharding constrainer (`con`, `_shard_ctx`,
`_local_cols`; ROADMAP item 10)."""

from __future__ import annotations

import torch

from .fused import fused_mfa_cols, mfa_col_cluster, mfa_col_fits
from .limb import mul_2expmod
from .sqrt2 import _fft_trunc_sqrt2, _ifft_trunc_sqrt2, ifft_sqrt2
from .transforms import fft_radix2, ifft_radix2, inner_group, revbin_vec
from .truncate import truncated


def _cat3(*parts: torch.Tensor) -> torch.Tensor:
    """Concat along axis -3, dropping zero-length parts."""
    parts = [p for p in parts if p.shape[-3] > 0]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=-3)


def _block_cross_exps(rows: int, st: int, n1_mask: int, n2: int, w: int, W: int,
                      device=None) -> torch.Tensor:
    """Cross exps for `rows` consecutive flat batch rows from st: the column
    of flat row r is r & n1_mask, masked after adding the offset, because a
    block may span more than one copy of the column axis (masking the start
    alone mis-twiddled every row past the wrap; tests/test_mfa.py:173)."""
    j1 = (st + torch.arange(rows, dtype=torch.int64, device=device)[:, None]) & n1_mask
    rb = torch.from_numpy(revbin_vec(n2)).to(device)
    return (w * rb[None, :] * j1) % (2 * W)


def _cross_exps(n1: int, n2: int, w: int, W: int, device=None) -> torch.Tensor:
    """exps[j1, j2p] = w * revbin(j2p, log n2) * j1 mod 2W: the z^(k2*j1)
    cross twiddle of column j1 at column-output position j2p (int64)."""
    return _block_cross_exps(n1, 0, n1 - 1, n2, w, W, device)


def _run_cols(xc: torch.Tensor, kind: str, w: int, W: int, trunc2: int,
              no_zero_tail: bool = False) -> torch.Tensor:
    """Column pass over xc [..., n1, n2, L]: the truncated transform of
    `kind` and flavour at trunc2 rows (full at trunc2 == n2) of each column
    at root w*n1 with its cross twiddles.  Leading axes flatten into the
    column kernel's batch.  The columns the reference fuses take the
    kernel, all but those no cluster of 8 CTAs holds (truncated, past
    1.5 MB: no plan gives them), which take the recursion as the rest do."""
    n1, n2, L = xc.shape[-3:]
    if mfa_col_fits(n2, L, trunc2 == n2) and mfa_col_cluster(n2, L):
        flat = xc.contiguous().reshape(-1, n2, L)
        return fused_mfa_cols(kind, flat, w, W, n1, trunc2, no_zero_tail).reshape(xc.shape)
    return truncated(kind, no_zero_tail)(xc, w * n1, W, trunc2,
                                         _cross_exps(n1, n2, w, W, xc.device))


def _swap(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-3, -2).contiguous()


def fft_radix2_mfa(x: torch.Tensor, w: int, W: int, n1: int, n2: int) -> torch.Tensor:
    """Forward 2-D MFA: x [..., n2, n1, L] -> the same shape, transformed."""
    xc = _run_cols(_swap(x), "fwd", w, W, n2)       # [..., n1, n2, L]: columns
    return fft_radix2(_swap(xc), w * n2, W)           # [..., n2, n1, L]: rows


def ifft_mfa_rows(v: torch.Tensor, row_w: int, W: int, n1: int) -> torch.Tensor:
    """Just the row-IFFT leg of the inverse MFA over flat [..., R, L] chunks
    (R a multiple of n1): the first pass every spectrum position < trunc
    takes, in both w parities (root w*n2 == (w//2)*(2*n2)).  Chunk-local,
    so the staged flagship runs it on each pointwise chunk (ref
    mfa.py:197-208)."""
    R, L = v.shape[-2], v.shape[-1]
    assert R % n1 == 0, (tuple(v.shape), n1)
    return ifft_radix2(v.reshape(v.shape[:-2] + (R // n1, n1, L)), row_w, W).reshape(v.shape)


def ifft_radix2_mfa(x: torch.Tensor, w: int, W: int, n1: int, n2: int,
                    rows_done: bool = False) -> torch.Tensor:
    """Inverse 2-D MFA (times n1*n2): row IFFTs, then column IFFTs with the
    cross twiddles divided out before their first stage.  rows_done: the
    row IFFTs already ran (ifft_mfa_rows)."""
    xr = x if rows_done else ifft_radix2(x, w * n2, W)
    return _swap(_run_cols(_swap(xr), "inv", w, W, n2))


def mfa_fft_trunc(x: torch.Tensor, w: int, W: int, n1: int, n2: int, trunc2: int,
                  no_zero_tail: bool = False) -> torch.Tensor:
    """Truncated forward MFA: only the first trunc2 output rows are valid.
    With no_zero_tail, input rows >= trunc2 are arbitrary (truncate1
    semantics); otherwise they must be zero."""
    assert 1 <= trunc2 <= n2
    xr = _swap(_run_cols(_swap(x), "fwd", w, W, trunc2, no_zero_tail))
    head = fft_radix2(xr[..., :trunc2, :, :], w * n2, W)
    return _cat3(head, xr[..., trunc2:, :, :])


def mfa_ifft_trunc(v: torch.Tensor, w: int, W: int, n1: int, n2: int, trunc2: int,
                   no_zero_tail: bool = False, rows_done: bool = False) -> torch.Tensor:
    """Truncated inverse MFA (times n1*n2 on the first trunc2 rows).  Plain
    flavour: the coefficient rows >= trunc2 are zero; no_zero_tail: input
    rows >= trunc2 hold the unscaled coefficients (cell (j2, j1) =
    x_{j2 n1 + j1}), as truncate.ifft_trunc1.  rows_done: the first trunc2
    rows already went through ifft_mfa_rows."""
    assert 1 <= trunc2 <= n2
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


def mfa_fft_trunc_sqrt2(x: torch.Tensor, w: int, W: int, n1: int, trunc: int) -> torch.Tensor:
    """Truncated length-4n forward transform over root sqrt2^w with MFA
    halves (for even w one length-4n MFA at root 2^(w/2), ref
    mul_fft.c:850-855).  x flat [..., 4n, L], zero past trunc; trunc a
    multiple of n1.  Valid outputs: positions < trunc.  At trunc == 4n the
    flat transform (fft_sqrt2) runs, as in the reference (mfa.py:308-317)."""
    assert trunc % n1 == 0
    return _fft_trunc_sqrt2(
        x, w, W, trunc,
        _cells(lambda y, n2, v: fft_radix2_mfa(y, v, W, n1, n2), n1),
        _cells(lambda y, n2, v, t, one: mfa_fft_trunc(y, v, W, n1, n2, t // n1, one), n1))


def mfa_ifft_trunc_sqrt2(v: torch.Tensor, w: int, W: int, n1: int, trunc: int,
                         norm_div: int = 0, rows_done: bool = False) -> torch.Tensor:
    """Inverse of mfa_fft_trunc_sqrt2 (times 4n on positions < trunc;
    positions >= trunc unspecified).  norm_div > 0 folds the drivers'
    divide-by-2^norm_div + normmod tail into the last pass over each
    position.  rows_done: positions < trunc already took the chunk-local
    first leg -- below the full length the row IFFTs (ifft_mfa_rows, root
    w * n2); at trunc == 4n, the flat dispatch, the innermost ladder group
    (transforms.ifft_innermost at length 2n), skipped here as skip_inner
    (ref mfa.py:337-369)."""
    assert trunc % n1 == 0
    C = v.shape[-2]
    if trunc == C:
        skip = inner_group(C // 2, v.shape[-1]) if rows_done else 0
        return ifft_sqrt2(v, w, W, norm_div=norm_div, skip_inner=skip)
    return _ifft_trunc_sqrt2(
        v, w, W, trunc, norm_div,
        _cells(lambda y, n2, u: ifft_radix2_mfa(y, u, W, n1, n2, rows_done), n1),
        _cells(lambda y, n2, u, t, one: mfa_ifft_trunc(y, u, W, n1, n2, t // n1, one,
                                                       rows_done), n1))
