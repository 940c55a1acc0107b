"""Out-of-core execution of the flagship multiply (counterpart of
mpir_fft_tpu/models/huge.py; ref FFT/IFFT_radix2_mfa_truncate_sqrt2,
mul_fft.c:2212-2355 / 2593-2743, with its combined inverse, :2745-2923).

Every MFA pass of the production transform runs as a stream of chunks over
PACKED coefficient storage, the reference's blocking one level up:

  * Between passes, coefficients live canonical (ops/limb.normmod) as
    16-bit digit planes plus a per-row int8 mask of the -1 residue: half
    the bytes of the int32 compute form.  Each chunk unpacks, transforms
    (the ladder, the column and row transforms of ops/transforms.py and
    ops/truncate.py, unchanged), re-canonicalizes and repacks.
  * Column passes gather a block of columns from every row chunk (the
    reference's stride-n1 column walk, mul_fft.c:2035-2051); row passes
    gather a row-group range from every column block.  No pass holds the
    whole slab in compute form, and a store is freed as soon as the pass
    that consumes it ends.
  * The pointwise stage consumes the two spectra chunk pair by chunk pair,
    dropping each consumed chunk, and feeds each product chunk through the
    row-IFFT leg.

The digit planes are int16 tensors holding the uint16 digits' bits (torch's
uint16 has few kernels); `_unpack` masks them back to [0, 2^16).  Gathers
are direct indexing.  The half-bit twiddles are affine in the flat row
(the split: e2 = (r0 + i) w; the inverse's tail: (g0 n1 + i) w, with its
powers of two folded into e0; the head: -(g0 n1 + i) w), so each is one
twiddle_half kernel pass (ops/fused.py fused_twiddle_half).  The ladder's
cross-twiddle tables of a column block start at its first column
(ops/mfa.py _block_cross_exps).

Scope: flagship (sqrt2) plans with digit-aligned bits1 and both operands in
the first convolution half (j1, j2 <= conv_len/2), trunc_mfa a multiple of
n1: `huge_serves`.  Entries: mul_huge / sqr_huge on digit tensors.

Sharded (`ctx`, a parallel.mfa_sharded.ShardCtx; the reference's :199-300,
:455-749): every rank runs the same passes on the same inputs and keeps
only its share of each store part -- in C form its columns [rank n1/ndev,
(rank+1) n1/ndev) of the chunk, in R form the rank's ndev-th of the part's
row groups -- and a pass that crosses forms gathers its block by one
all-to-all (`_exchange_cols`, `_rows`), the packed digits and
their mask as bytes.  The pointwise is the rank's own rows; the streamed
combine adds the rank's rows into its accumulator, and one all-reduce
makes the sum whole on every rank.  The reference's gates (ndev divides
n1, each row pass's G, each pointwise chunk's groups) hold for every pass
or for none: the stores are sharded through the whole product, or every
rank runs it unsharded (`_sharded`).

Not ported: the reference's `_drain` / `_patient` / `_SYNC` (a remote
TPU's deferred frees; stream order and dropped references do that here)."""

from __future__ import annotations

import os

import torch

from mpir_fft_tpu_torch.ops.fused import fused_twiddle_half
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, DIGIT_MASK, Ring, normmod, normmod_div
from mpir_fft_tpu_torch.ops.mfa import _block_cross_exps, ifft_mfa_rows
from mpir_fft_tpu_torch.ops.mulmod import mulmod
from mpir_fft_tpu_torch.ops.split import canonicalize_plain
from mpir_fft_tpu_torch.ops.transforms import fft_radix2, ifft_radix2
from mpir_fft_tpu_torch.ops.truncate import fft_trunc, fft_trunc1, ifft_trunc, ifft_trunc1
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv

# unpacked int32 bytes a transform chunk may touch (the reference's default
# and environment name)
CHUNK_BYTES = int(os.environ.get("MPIR_FFT_HUGE_CHUNK_MB", 256)) << 20
# spectrum row-chunk bytes; also the pointwise batch
PW_CHUNK_BYTES = int(os.environ.get("MPIR_FFT_HUGE_PW_CHUNK_MB", 128)) << 20


# ---------------------------------------------------------------------------
# Packed storage: canonical digits as 16-bit planes + int8 mask of -1 rows
# ---------------------------------------------------------------------------

def _pack(x: torch.Tensor):
    """int32 [..., L] (any redundancy) -> (int16 [..., L], int8 [...])."""
    y = normmod(x.contiguous())
    neg = y[..., 0] < 0
    u = torch.where(neg[..., None], 0, y).to(torch.int16)
    return u, neg.to(torch.int8)


def _pack_canonical(x: torch.Tensor):
    """Pack digits already canonical nonnegative (< 2^16): no normmod."""
    return x.to(torch.int16), torch.zeros(x.shape[:-1], dtype=torch.int8, device=x.device)


def _unpack(u: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int32 digits of a packed block: the -1 rows (all-zero planes) become
    [-1, 0, ...]."""
    x = u.to(torch.int32) & DIGIT_MASK
    x[..., 0] -= m.to(torch.int32)
    return x


class Store:
    """Packed coefficient matrix, chunked along rows or blocked along cols.

    form "R": parts ([Rc_i, L] int16, [Rc_i] int8), Rc_i % n1 == 0, covering
      flat coefficient rows [0, sum Rc_i); rows past the stored prefix are
      ZERO (an operand's split covers only its j rows).
    form "C": parts ([G, cb_i, L] int16, [G, cb_i] int8), block i covering
      columns [sum cb_<i, +cb_i) of a (row-group, column) = (G, n1) view;
      flat row r = g * n1 + c."""

    def __init__(self, form: str, parts: list, n1: int):
        self.form, self.parts, self.n1 = form, parts, n1

    def free(self):
        self.parts = []


def _ranges(total: int, pref: int):
    out, r0 = [], 0
    while r0 < total:
        size = min(pref, total - r0)
        out.append((r0, size))
        r0 += size
    return out


def _pow2_at_most(x: int) -> int:
    return 1 << max(0, x.bit_length() - 1)


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------

def _gather_cols(parts, c0: int, cb: int, n1: int, G: int, L: int) -> torch.Tensor:
    """[cb, G, L] int32: columns [c0, c0+cb) of an R-form store's (G, n1)
    view, column-major (the column transforms' batch first); zero row
    groups past the stored prefix."""
    u0 = parts[0][0]
    out = torch.zeros((cb, G, L), dtype=torch.int32, device=u0.device)
    g0 = 0
    for u, m in parts:
        g = u.shape[0] // n1
        blk = _unpack(u.view(g, n1, L)[:, c0:c0 + cb], m.view(g, n1)[:, c0:c0 + cb])
        out[:, g0:g0 + g] = blk.transpose(0, 1)
        g0 += g
    return out


def _gather_rows(parts, g0: int, gb: int, L: int) -> torch.Tensor:
    """[gb, n1, L] int32: row groups [g0, g0+gb) across every column block
    of a C-form store."""
    n1 = sum(u.shape[1] for u, _ in parts)
    out = torch.empty((gb, n1, L), dtype=torch.int32, device=parts[0][0].device)
    c = 0
    for u, m in parts:
        cb = u.shape[1]
        out[:, c:c + cb] = _unpack(u[g0:g0 + gb], m[g0:g0 + gb])
        c += cb
    return out


# ---------------------------------------------------------------------------
# Sharded gathers: one all-to-all each (stores held as the ranks' shares)
# ---------------------------------------------------------------------------

def _wire(u: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A packed block as bytes [..., 2L + 1]: the digit planes, then the
    mask (gloo exchanges no int16)."""
    return torch.cat([u.view(torch.int8), m.unsqueeze(-1)], dim=-1)


def _unwire(b: torch.Tensor) -> torch.Tensor:
    """The int32 digits of a _wire block."""
    k = b.shape[-1] - 1
    return _unpack(b[..., :k].contiguous().view(torch.int16), b[..., k])


def _exchange_cols(parts, c: int, cb: int, n1: int, G: int, L: int, ctx) -> torch.Tensor:
    """[cb, G, L] int32: columns [rank n1/ndev + c, +cb) of an R-form store
    held as the ranks' shares (rank i: groups [i gl, (i+1) gl) of each
    part's gl ndev), column-major, zero row groups past the stored prefix:
    each rank sends every rank that rank's columns of its rows."""
    ndev, nl = ctx.ndev, n1 // ctx.ndev
    sends, sizes = [], []
    for u, m in parts:
        gl = u.shape[0] // n1
        sends.append(_wire(u.view(gl, ndev, nl, L)[:, :, c:c + cb].transpose(0, 1),
                           m.view(gl, ndev, nl)[:, :, c:c + cb].transpose(0, 1)))
        sizes.append(gl)
    out = torch.zeros((cb, G, L), dtype=torch.int32, device=ctx.device)
    got = ctx.all_to_all(torch.cat(sends, dim=1))   # [ndev (their shares), groups, cb, 2L+1]
    g0 = at = 0
    for gl in sizes:
        out[:, g0:g0 + ndev * gl] = _unwire(got[:, at:at + gl]).reshape(-1, cb, L).transpose(0, 1)
        g0, at = g0 + ndev * gl, at + gl
    return out


def _rows(stores, g0: int, gsz: int, L: int, ctx) -> tuple[list, int]:
    """The rank's row groups of C-form stores, from [g0, g0+gsz): ([gl, n1,
    L] int32 each, the first group's index); unsharded all gsz from g0,
    sharded the rank's gl = gsz/ndev, one all-to-all for all the stores
    (each rank holds its columns of every store)."""
    if ctx is None:
        return [_gather_rows(st.parts, g0, gsz, L) for st in stores], g0
    ndev, gl = ctx.ndev, gsz // ctx.ndev
    widths = [sum(u.shape[1] for u, _ in st.parts) for st in stores]
    mine = torch.cat([_wire(u[g0:g0 + gsz], m[g0:g0 + gsz])
                      for st in stores for u, m in st.parts], dim=1)
    got = ctx.all_to_all(mine.view(ndev, gl, sum(widths), -1)).transpose(0, 1)
    out, at = [], 0
    for nl in widths:
        out.append(_unwire(got[:, :, at:at + nl]).reshape(gl, ndev * nl, L))
        at += nl
    return out, g0 + ctx.rank * gl


# ---------------------------------------------------------------------------
# Pass runners, streamed over chunks
# ---------------------------------------------------------------------------

def _col_pass(store: Store, fcol, G_in: int, g_keep: int, L: int, ctx=None) -> Store:
    """Column pass over an R-form store -> C-form store.
    fcol(blk [cb, G_in, L], c0) -> [cb, G_out >= g_keep, L]; outputs cut to
    g_keep row groups (truncated transforms leave garbage past trunc2).
    Sharded: the rank's columns, cb at a time, each block one all-to-all."""
    assert store.form == "R"
    n1 = store.n1
    first, cols = (0, n1) if ctx is None else (ctx.rank * (n1 // ctx.ndev), n1 // ctx.ndev)
    cb = max(1, min(cols, CHUNK_BYTES // (4 * G_in * L)))
    while cols % cb:
        cb -= 1
    parts = []
    for c, _ in _ranges(cols, cb):
        blk = (_gather_cols(store.parts, c, cb, n1, G_in, L) if ctx is None
               else _exchange_cols(store.parts, c, cb, n1, G_in, L, ctx))
        out = fcol(blk, first + c)
        del blk
        u, m = _pack(out[:, :g_keep])
        del out
        parts.append((u.transpose(0, 1).contiguous(), m.transpose(0, 1).contiguous()))
    return Store("C", parts, n1)


def _row_pass(store: Store, frow, L: int, gb: int, ctx=None) -> Store:
    """Row pass over a C-form store -> R-form store with gb*n1-row chunks.
    frow(blk [gb, n1, L]) -> the same shape (independent length-n1
    transforms).  Sharded: gb a multiple of ndev, the rank's share of each
    chunk (one all-to-all)."""
    assert store.form == "C"
    G = store.parts[0][0].shape[0]
    gb = max(1, min(G, gb))
    if ctx is not None:
        gb = max(ctx.ndev, gb - gb % ctx.ndev)
    parts = []
    for g0, gsz in _ranges(G, gb):
        (blk,), _ = _rows([store], g0, gsz, L, ctx)
        parts.append(_pack(frow(blk).reshape(-1, L)))
    return Store("R", parts, store.n1)


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------

def _geometry(plan: MulPlan):
    ring = Ring(plan.n, plan.w)
    return ring, plan.conv_len, plan.conv_len // 2, plan.n1, plan.trunc_mfa


def _rb_groups(plan: MulPlan) -> int:
    """Spectrum / pointwise chunk size in row GROUPS (of n1 rows): a power of
    two, so chunk boundaries never straddle the half-spectrum boundary h."""
    ring, C4, h, n1, t = _geometry(plan)
    pref = max(1, PW_CHUNK_BYTES // (4 * n1 * ring.L))
    return min(_pow2_at_most(pref), h // n1)


def _cross(cb: int, c0: int, n1: int, G: int, w: int, W: int, device) -> torch.Tensor:
    """The cross twiddles of columns [c0, c0+cb) of a (G, n1) MFA at root
    2^w: [cb, G] (the reference's _cross_exps(cb, G, w, W, j1_start=c0))."""
    return _block_cross_exps(cb, c0, n1 - 1, G, w, W, device)


def _split_store(digits: torch.Tensor, plan: MulPlan, j: int, twiddle: bool,
                 ctx=None) -> Store:
    """Split one operand into packed coefficient row chunks (prefix store:
    rows >= ceil(j/n1)*n1 are implicit zeros).  With twiddle=True row r is
    also multiplied by sqrt2^(w*r) -- the sqrt2 top layer's (a - b)
    weighting with b == 0 (ref FFT_radix2_butterfly_sqrt2 exponents,
    mul_fft.c:591-634), valid because j1, j2 <= h means the second-half
    input rows of both operands are zero.  Sharded: chunks of whole groups
    for every rank, each rank splitting its share."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W = ring.L, plan.W
    assert plan.bits1 % DIGIT_BITS == 0, "huge path needs digit-aligned bits1"
    d = plan.bits1 // DIGIT_BITS
    unit = n1 * (1 if ctx is None else ctx.ndev)
    jr = cdiv(j, unit) * unit
    need = jr * d
    if digits.shape[-1] < need:
        digits = torch.cat([digits, digits.new_zeros(need - digits.shape[-1])])
    rb = max(unit, (CHUNK_BYTES // (4 * L) // unit) * unit)
    parts = []
    for r0, rows in _ranges(jr, rb):
        if ctx is not None:
            rows //= ctx.ndev
            r0 += ctx.rank * rows
        c = digits.new_zeros((rows, L))
        c[:, :d] = digits[r0 * d:(r0 + rows) * d].view(rows, d)
        if twiddle:
            parts.append(_pack(fused_twiddle_half(c, r0 * plan.w, plan.w, W)))
        else:
            parts.append(_pack_canonical(c))
    return Store("R", parts, n1)


def _forward(digits: torch.Tensor, plan: MulPlan, j: int, ctx=None) -> Store:
    """Forward transform of one operand -> R-form spectrum store covering
    flat spectrum positions [0, t) (left half then right half, the layout
    of ops/mfa.mfa_fft_trunc_sqrt2); sharded, the rank's shares."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W, w = ring.L, plan.W, plan.w
    dev = digits.device
    assert j <= h, "huge path: operand must fit the first half"
    gb = _rb_groups(plan)

    if w % 2 == 0:
        G, t2 = C4 // n1, t // n1
        sp = _split_store(digits, plan, j, twiddle=False, ctx=ctx)
        c = _col_pass(
            sp, lambda b, c0: fft_trunc(b, (w // 2) * n1, W, t2,
                                        _cross(b.shape[0], c0, n1, G, w // 2, W, dev)),
            G, t2, L, ctx)
        sp.free()
        r = _row_pass(c, lambda b: fft_radix2(b, (w // 2) * G, W), L, gb, ctx)
        c.free()
        return r

    G = h // n1
    if t <= h:
        t2 = t // n1
        sp = _split_store(digits, plan, j, twiddle=False, ctx=ctx)
        c = _col_pass(
            sp, lambda b, c0: fft_trunc(b, w * n1, W, t2, _cross(b.shape[0], c0, n1, G, w, W, dev)),
            G, t2, L, ctx)
        sp.free()
        r = _row_pass(c, lambda b: fft_radix2(b, w * G, W), L, gb, ctx)
        c.free()
        return r

    k2 = (t - h) // n1
    # left half: the plain MFA of s = a + b_zero = a
    sp = _split_store(digits, plan, j, twiddle=False, ctx=ctx)
    cL = _col_pass(
        sp, lambda b, c0: fft_radix2(b, w * n1, W,
                                     post_exps=_cross(b.shape[0], c0, n1, G, w, W, dev)),
        G, G, L, ctx)
    sp.free()
    left = _row_pass(cL, lambda b: fft_radix2(b, w * G, W), L, gb, ctx)
    cL.free()
    # right half: the truncate1 MFA of the sqrt2-weighted rows
    spT = _split_store(digits, plan, j, twiddle=True, ctx=ctx)
    cR = _col_pass(
        spT, lambda b, c0: fft_trunc1(b, w * n1, W, k2, _cross(b.shape[0], c0, n1, G, w, W, dev)),
        G, k2, L, ctx)
    spT.free()
    right = _row_pass(cR, lambda b: fft_radix2(b, w * G, W), L, gb, ctx)
    cR.free()
    return Store("R", left.parts + right.parts, n1)


def _pointwise_rows(fa: Store, fb: Store | None, plan: MulPlan, ctx=None):
    """Pointwise mulmod + row-IFFT streamed over aligned chunk pairs (ref
    pointwise loop mul_fft.c:3626-3654 fused with the combined inverse's row
    leg, mul_fft.c:2745-2923); consumed chunks are dropped.  fb=None
    squares.  Returns (prodL, prodR): rows [0, bnd) and [bnd, t), bnd = h
    for the odd t > h composite, else t (prodR empty).  Sharded: the
    rank's shares, whole row groups each (no exchange)."""
    ring, C4, h, n1, t = _geometry(plan)
    W = plan.W
    row_w = plan.w * ((C4 // 2) // n1)
    bnd = h if (plan.w % 2 == 1 and t > h) else t
    ranks = 1 if ctx is None else ctx.ndev
    outL, outR, r0 = [], [], 0
    for i in range(len(fa.parts)):
        a = _unpack(*fa.parts[i])
        fa.parts[i] = None
        if fb is None:
            prod = mulmod(a, a, W)
        else:
            b = _unpack(*fb.parts[i])
            fb.parts[i] = None
            assert b.shape == a.shape, "spectrum chunking mismatch"
            prod = mulmod(a, b, W)
            del b
        del a
        res = _pack(ifft_mfa_rows(prod, row_w, W, n1))
        del prod
        (outL if r0 < bnd else outR).append(res)
        r0 += res[0].shape[0] * ranks
    fa.free()
    if fb is not None:
        fb.free()
    assert sum(u.shape[0] for u, _ in outL) * ranks == bnd
    return Store("R", outL, n1), Store("R", outR, n1)


class _CombineAcc:
    """Streaming FFT_combine_bits (ref mul_fft.c:207-267): row chunks of
    canonical coefficients accumulate into one redundant digit vector at
    their digit offsets (digit-aligned bits1), and one exact carry at the
    end (ops/split.canonicalize_plain: the canonicalize kernel's chained
    route on the card, which takes any length, so no padding).  Sharded,
    each rank adds its rows, and one all-reduce sums the ranks'
    accumulators before the carry."""

    def __init__(self, plan: MulPlan, t: int, Lout: int, device, ctx=None):
        assert plan.bits1 % DIGIT_BITS == 0
        self.d = plan.bits1 // DIGIT_BITS
        self.L = plan.W // DIGIT_BITS
        self.Lout = Lout
        self.nseg = cdiv(self.L, self.d)
        # every row's window fits without clamping; the true value fits Lout
        size = max(Lout, t * self.d + self.nseg * self.d)
        self.acc = torch.zeros(size, dtype=torch.int32, device=device)
        self.ctx = ctx

    def add(self, c: torch.Tensor, row0: int):
        """Add rows c [rows, L] (canonical) as coefficients row0, row0+1, ..."""
        rows, d = c.shape[0], self.d
        for s in range(self.nseg):
            seg = c[:, s * d:(s + 1) * d]
            lo = (row0 + s) * d
            win = self.acc[lo:lo + rows * d].view(rows, d)
            win[:, :seg.shape[1]] += seg

    def finish(self) -> torch.Tensor:
        # digits past Lout are zero: the value fits and no digit is negative
        # (in every rank's part of the sum too)
        acc = self.acc[:self.Lout]
        if self.ctx is not None:
            acc = self.ctx.all_reduce_sum(acc)
        out = canonicalize_plain(acc)
        self.acc = None
        return out


def _inverse_and_combine(prodL: Store, prodR: Store, plan: MulPlan, ctx=None) -> torch.Tensor:
    """Inverse transform (row legs already applied) + scale + combine ->
    canonical product digit vector (ref IFFT_radix2_mfa_truncate_sqrt2
    mul_fft.c:2593-2743 + scale / combine mul_fft.c:3658-3665).  Sharded:
    the column passes on the rank's columns; the tail, the final rows and
    the combine on the rank's row groups (each block one all-to-all), the
    sum whole on every rank."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W, w = ring.L, plan.W, plan.w
    dev = prodL.parts[0][0].device
    Lout = cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2
    gb = _rb_groups(plan)
    if ctx is not None:
        gb = max(ctx.ndev, gb - gb % ctx.ndev)

    def emit_simple(cstore: Store, scale: int) -> torch.Tensor:
        """Final pass for the single-MFA shapes: scale + combine."""
        out = _CombineAcc(plan, t, Lout, dev, ctx)
        for g0, gsz in _ranges(cstore.parts[0][0].shape[0], gb):
            (blk,), gs = _rows([cstore], g0, gsz, L, ctx)
            out.add(normmod_div(blk, scale, W).view(-1, L), gs * n1)
        cstore.free()
        return out.finish()

    if w % 2 == 0 or t <= h:
        wc = w // 2 if w % 2 == 0 else w
        G = (C4 if w % 2 == 0 else h) // n1
        t2 = t // n1
        c = _col_pass(
            prodL, lambda b, c0: ifft_trunc(b, wc * n1, W, t2,
                                            _cross(b.shape[0], c0, n1, G, wc, W, dev)),
            G, t2, L, ctx)
        prodL.free()
        # odd-w t <= h: the result is 2 * left (ref mul_fft.c:1694-1695) --
        # the doubling folds into the scale
        return emit_simple(c, plan.lg_conv - (0 if w % 2 == 0 else 1))

    G = h // n1
    k = t - h
    k2 = k // n1
    lg_h = h.bit_length() - 1
    lg_n1 = n1.bit_length() - 1

    # sL = column IFFT of the (row-done) left half
    sL = _col_pass(
        prodL, lambda b, c0: ifft_radix2(b, w * n1, W,
                                         pre_exps=_cross(b.shape[0], c0, n1, G, w, W, dev)),
        G, G, L, ctx)
    prodL.free()

    # vr = [prodR rows (row-done spectrum positions h..t) | the reconstructed
    # tail t_j = (sL_j / 2^lg_h) * sqrt2^(w j) * n1, j in [k, h)] (ref
    # mul_fft.c:2680-2691; the n1 factor matches ifft_trunc1's uniform-scale
    # contract, ops/mfa.mfa_ifft_trunc): one half-bit twiddle, the powers of
    # two in its e0
    tail = []
    for g0, gsz in _ranges(G - k2, gb):
        (blk,), gs = _rows([sL], k2 + g0, gsz, L, ctx)
        tail.append(_pack(fused_twiddle_half(blk.view(-1, L), gs * n1 * w + 2 * (lg_n1 - lg_h),
                                             w, W)))
    vr = Store("R", list(prodR.parts) + tail, n1)
    prodR.free()
    oR = _col_pass(
        vr, lambda b, c0: ifft_trunc1(b, w * n1, W, k2, _cross(b.shape[0], c0, n1, G, w, W, dev)),
        G, k2, L, ctx)
    vr.free()

    # final rows: u_r = oR_r * sqrt2^(-w r); xa / xb = sL_r +- u_r (r < k);
    # mid = 2 sL_r (k <= r < h); all / 2^lg_conv (ref mul_fft.c:3658-3662)
    out = _CombineAcc(plan, t, Lout, dev, ctx)
    for g0, gsz in _ranges(k2, gb):
        (s, o), gs = _rows([sL, oR], g0, gsz, L, ctx)
        s = s.view(-1, L)
        u = fused_twiddle_half(o.view(-1, L), -gs * n1 * w, -w, W)
        del o
        out.add(normmod_div(s + u, plan.lg_conv, W), gs * n1)
        out.add(normmod_div(s - u, plan.lg_conv, W), h + gs * n1)
    for g0, gsz in _ranges(G - k2, gb):
        (s,), gs = _rows([sL], k2 + g0, gsz, L, ctx)
        out.add(normmod_div(s.view(-1, L), plan.lg_conv - 1, W), gs * n1)
    sL.free()
    oR.free()
    return out.finish()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def huge_serves(plan: MulPlan) -> bool:
    """The shape constraints of the out-of-core pipeline."""
    h = plan.conv_len // 2
    return (plan.sqrt2 and plan.bits1 % DIGIT_BITS == 0 and plan.j1 <= h and plan.j2 <= h
            and plan.trunc_mfa % plan.n1 == 0)


def _sharded(ctx, plan: MulPlan):
    """ctx where its ranks divide every axis the passes shard -- n1 (the
    column passes) and the row groups of each row pass and final stream
    (G = h/n1, and t/n1 or (t-h)/n1 kept; then every chunk of them, which
    the pointwise takes, as the reference's gates :199-300 ask) -- else
    None: every rank runs the product unsharded."""
    if ctx is None:
        return None
    h, n1, t = plan.conv_len // 2, plan.n1, plan.trunc_mfa
    kept = (t - h if plan.w % 2 and t > h else t) // n1
    ok = all(n % ctx.ndev == 0 for n in (n1, h // n1, kept))
    return ctx if ok else None


def mul_huge(da: torch.Tensor, db: torch.Tensor, plan: MulPlan, ctx=None) -> torch.Tensor:
    """Canonical product digits [out_len_digits(plan)] of two digit vectors
    [La], [Lb] (on one device), out of core.  ctx: the passes sharded over
    its ranks (the same da, db on each; the product whole on each)."""
    assert huge_serves(plan)
    ctx = _sharded(ctx, plan)
    fa = _forward(da, plan, plan.j1, ctx)
    fb = _forward(db, plan, plan.j2, ctx)
    prodL, prodR = _pointwise_rows(fa, fb, plan, ctx)
    return _inverse_and_combine(prodL, prodR, plan, ctx)


def sqr_huge(da: torch.Tensor, plan: MulPlan, ctx=None) -> torch.Tensor:
    """Squaring: ONE forward transform; ctx as mul_huge's."""
    assert huge_serves(plan)
    ctx = _sharded(ctx, plan)
    fa = _forward(da, plan, plan.j1, ctx)
    prodL, prodR = _pointwise_rows(fa, None, plan, ctx)
    return _inverse_and_combine(prodL, prodR, plan, ctx)
