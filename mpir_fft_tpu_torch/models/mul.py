"""Integer multiplication drivers (counterpart of mpir_fft_tpu/models/mul.py;
ref new_mpn_mul* mul_fft.c:3190-3668).

Every driver splits both operands into ring coefficients, forward-
transforms, pointwise-multiplies, inverse-transforms, scales by
2^-lg_conv and normalizes, and combines with carries.  They differ in the
transform pair (`DRIVERS`, the reference's six generations plus the
flagship):

  driver        transform pair                      ref
  radix2        fft_radix2 / ifft_radix2            (baseline)
  sqrt2         fft_sqrt2 / ifft_sqrt2              new_mpn_mul2, mul_fft.c:3267
  mfa           fft_radix2_mfa / ifft_radix2_mfa    new_mpn_mul3, mul_fft.c:3339
  trunc_sqrt2   fft_trunc_sqrt2 / ifft_trunc_sqrt2  new_mpn_mul4, mul_fft.c:3415
  trunc         fft_trunc / ifft_trunc              new_mpn_mul5, mul_fft.c:3494
  mfa_trunc     mfa_fft_trunc / mfa_ifft_trunc      new_mpn_mul,  mul_fft.c:3190
  flagship      mfa_fft_trunc_sqrt2 / mfa_ifft_trunc_sqrt2 with the recursive
                pointwise                           new_mpn_mul6, mul_fft.c:3573

The flagship truncates at plan.trunc_mfa: where it is below conv_len (an
unbalanced product: the reference's 9/16 rule rounds every balanced plan up
to the full length), the forward is the truncated MFA pair, the pointwise
runs on the first trunc_mfa rows only, and the inverse folds the divide +
normalize tail in; at the full length both transforms are the flat sqrt2
pair (odd w through the top layer kernels).  The pointwise (ops/mulmod.py
mulmod) takes the small-prime NTT-CRT for power-of-two rings L <= 8192, the
schoolbook for other L <= 2048 (and for all of them under MPIR_FFT_NTT=0),
and the recursive Fermat mulmod for the rest; the other drivers take the
leaf (`mulmod_base`) wherever it serves, as the reference's recursive=False.

Staging (`_staged_flagship`, the reference's models/mul.py:401-515): `mul`
and `sqr` send every flagship plan with conv_len * L > 2^24 elements
(`flagship_is_staged`: 10^8 bits and up) through the same math in stages,
as the reference does -- one operand's forward at a time (on balanced
full-length plans a zero-top forward: split only conv/2 rows, the s-leg a
plain transform, the t-leg's half-bit twiddle riding its first ladder
group), the pointwise on row chunks (`_pw_chunk_rows`) each followed by
its chunk-local first inverse leg (inside the Garner kernel where the NTT
serves the ring: ops/ntt.py garner_post), then the inverse without that
leg and with the norm tail folded in, and the combine.  The thresholds are
the reference's; `mpn_mul_flagship` / `mpn_sqr_flagship` stay the
unstaged drivers.

Out of core and in pieces (the reference's :257-273, :588-719): past 2^29
coefficient elements (`_HUGE_THRESHOLD_ELEMS`, the reference's) a flagship
plan that `huge_serves` runs in models/huge.py (`mul_huge` / `sqr_huge`:
packed 16-bit stores, chunked column and row passes); an extreme-uneven
one runs as balanced pieces (`_mul_piecewise`, b shipped once); the rest
raises ValueError at plan time.  `mul_many` runs a batch of pairs as one
driver call on (Bt, L) digit tensors at one shared plan.

Every driver is its `Stages` (split, forward, pointwise, inverse,
normalize, combine; `driver_stages`), which the driver composes and the
stage profile (utils/profile.py) times one by one.

Spans (kernels.span; recorded only while a torch.profiler records): a
driver's call runs inside mf.<driver> (mf.flagship for the flagship,
staged or whole, and for sqr; mf.huge out of core), each stage inside
mf.split, mf.fwd (one of each an operand), mf.pw, mf.inv, mf.norm and
mf.combine; below the full length the staged pointwise's row-IFFT legs
inside mf.pw.rows, under mf.pw, and the truncated transforms' phases
inside the spans of ops/sqrt2.py; `mul`, `sqr` and `mul_many` inside
mf.mul, mf.sqr and mf.mul_many, with their conversions in
mf.digits_from_int, mf.h2d, mf.d2h and mf.int_from_digits.

Plans: `mul` / `sqr` take a measured plan from the tune cache for their
device where one is recorded (utils/tune.py cached_plan; MPIR_FFT_TUNE=0
turns the lookup off), else the analytic `choose_params`; `mul_many`
always the analytic one.

Device data model: integers are canonical base-2^16 digit vectors (int32
tensors) on an explicit device; `mul` / `sqr` default to "cuda" and never
move work to the CPU unless asked to."""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from mpir_fft_tpu_torch.kernels import count_copy, span, spanned
from mpir_fft_tpu_torch.models.huge import huge_serves, mul_huge, sqr_huge
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod_div
from mpir_fft_tpu_torch.ops.mfa import (_gather_cells, fft_radix2_mfa, ifft_mfa_rows,
                                        ifft_radix2_mfa, mfa_fft_trunc, mfa_fft_trunc_sqrt2,
                                        mfa_ifft_trunc, mfa_ifft_trunc_sqrt2)
from mpir_fft_tpu_torch.ops.mulmod import mulmod
from mpir_fft_tpu_torch.ops.ntt import garner_post
from mpir_fft_tpu_torch.ops.pointwise import base_serves, mulmod_base
from mpir_fft_tpu_torch.ops.split import fft_combine_bits, fft_split_bits
from mpir_fft_tpu_torch.ops.sqrt2 import fft_sqrt2, fft_trunc_sqrt2, ifft_sqrt2, ifft_trunc_sqrt2
from mpir_fft_tpu_torch.ops.transforms import (fft_radix2, ifft_innermost, ifft_radix2,
                                               inner_group, inner_steps)
from mpir_fft_tpu_torch.ops.truncate import fft_trunc, ifft_trunc
from mpir_fft_tpu_torch.parallel.mfa_sharded import sharded
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params
from mpir_fft_tpu_torch.utils.tune import cached_plan

# below this many product bits the host big-int product wins (the reference
# likewise delegates below-crossover sizes to mpn_mul, mul_fft.c:3135-3139)
_SMALL_THRESHOLD_BITS = 1 << 14


def out_len_digits(plan: MulPlan) -> int:
    return cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2


def _pointwise(fa: torch.Tensor, fb: torch.Tensor, W: int, recursive: bool) -> torch.Tensor:
    """Pointwise product mod 2^W+1 over the whole coefficient batch (ref
    pointwise loop, mul_fft.c:3626-3654): redundant digits in, bounded
    redundant digits out.  recursive=True is mulmod's choice (the
    flagship); False takes the leaf wherever base_serves(L), as the
    reference's other drivers do (models/mul.py:61-74)."""
    if recursive or not base_serves(W // DIGIT_BITS):
        return mulmod(fa, fb, W)
    return mulmod_base(fa, fb, canonical=False)


class Stages(NamedTuple):
    """A driver's pipeline at one plan, as the stages it runs (the stage
    profile, utils/profile.py, times each one alone)."""
    split: Callable               # digits [..., La] -> coefficient rows
    fwd: Callable                 # rows -> the spectrum rows the pointwise takes
    pw: Callable                  # (fa, fb) -> products (fb is fa: a square)
    inv: Callable                 # products -> coefficients
    norm: Callable | None         # divide by 2^lg_conv and normmod; None: inv folds it in
    combine: Callable             # coefficients -> canonical product digits


def _split_fn(plan: MulPlan, rows: int):
    return lambda d: fft_split_bits(d, plan.bits1, rows, plan.W // DIGIT_BITS)


def _norm_fn(plan: MulPlan):
    return lambda c: normmod_div(c, plan.lg_conv, plan.W)


def _combine_fn(plan: MulPlan, valid: int):
    """Combine the first `valid` coefficients into the product's digits
    (ref FFT_combine_bits, mul_fft.c:3658-3665)."""
    out_len = out_len_digits(plan)
    return lambda c: fft_combine_bits(c[..., :valid, :], plan.bits1, out_len)


def _pad_rows(prod: torch.Tensor, C: int, axis: int = -2) -> torch.Tensor:
    """prod with zero rows appended along `axis` up to length C (a copy,
    counted)."""
    n = prod.shape[axis]
    if n == C:
        return prod
    shape = list(prod.shape)
    shape[axis] = C - n
    return count_copy(torch.cat([prod, prod.new_zeros(shape)], dim=axis))


def _as_cells(c: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    return c.reshape(c.shape[:-2] + (plan.n2, plan.n1, c.shape[-1]))


def _from_cells(c: torch.Tensor) -> torch.Tensor:
    return c.reshape(c.shape[:-3] + (-1, c.shape[-1]))


def _plain_stages(kind: str, plan: MulPlan, ctx=None) -> Stages:
    """The stages of the six drivers other than the flagship: the leaf
    pointwise (recursive=False) between their transform pairs, truncated
    at plan.trunc (trunc, trunc_sqrt2) or at trunc_mfa // n1 MFA rows
    (mfa_trunc).  ctx (mfa, mfa_trunc): the MFA sharded over its ranks
    (ops/mfa.py), the pointwise on each rank's rows, the norm tail on its
    columns before the one gather."""
    C, W, w, n1, n2 = plan.conv_len, plan.W, plan.w, plan.n1, plan.n2
    split, norm = _split_fn(plan, C), _norm_fn(plan)

    def pw(fa, fb):
        return _pointwise(fa, fb, W, False)

    if kind in ("radix2", "sqrt2"):
        fwd, inv = {"radix2": (fft_radix2, ifft_radix2), "sqrt2": (fft_sqrt2, ifft_sqrt2)}[kind]
        return Stages(split, lambda x: fwd(x, w, W), pw, lambda v: inv(v, w, W), norm,
                      _combine_fn(plan, C))
    if kind in ("trunc", "trunc_sqrt2"):
        t = plan.trunc
        fwd, inv = {"trunc": (fft_trunc, ifft_trunc),
                    "trunc_sqrt2": (fft_trunc_sqrt2, ifft_trunc_sqrt2)}[kind]
        return Stages(split, lambda x: fwd(x, w, W, t)[..., :t, :],
                      lambda fa, fb: _pad_rows(pw(fa, fb), C), lambda v: inv(v, w, W, t), norm,
                      _combine_fn(plan, t))
    if kind == "mfa":
        t2, valid = n2, C
    else:
        assert kind == "mfa_trunc", kind
        t2, valid = plan.trunc_mfa // n1, plan.trunc_mfa

    def fwd(x):
        x = _as_cells(x, plan)
        if kind == "mfa":
            return fft_radix2_mfa(x, w, W, n1, n2, ctx=ctx)
        y = mfa_fft_trunc(x, w, W, n1, n2, t2, ctx=ctx)
        return y if ctx is not None else y[..., :t2, :, :]

    def inv(v):
        if kind == "mfa":
            return ifft_radix2_mfa(v, w, W, n1, n2, ctx=ctx)
        return mfa_ifft_trunc(v, w, W, n1, n2, t2, ctx=ctx)

    if ctx is not None:
        # the rank's rows in, its column block out: the norm tail on the
        # block, then the one gather
        return Stages(split, fwd, pw, lambda v: _gather_cells(norm(inv(v)), ctx), None,
                      _combine_fn(plan, valid))
    return Stages(split, fwd, lambda fa, fb: _pad_rows(pw(fa, fb), n2, -3),
                  lambda v: _from_cells(inv(v)), norm, _combine_fn(plan, valid))


def _stage(name: str, fn, *args):
    """fn(*args) inside the span mf.<name>."""
    with span(name):
        return fn(*args)


def _split_fwd(s: Stages, d: torch.Tensor) -> torch.Tensor:
    return _stage("fwd", s.fwd, _stage("split", s.split, d))


def _run_stages(s: Stages, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = _stage("inv", s.inv, _stage("pw", s.pw, _split_fwd(s, a), _split_fwd(s, b)))
    if s.norm is not None:
        c = _stage("norm", s.norm, c)
    return _stage("combine", s.combine, c)


def mpn_mul_radix2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Plain full-length cyclic FFT multiply."""
    assert not plan.sqrt2
    return _run_stages(_plain_stages("radix2", plan), a, b)


def mpn_mul_sqrt2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Length-4n multiply through the sqrt2 transforms, no truncation."""
    assert plan.sqrt2
    return _run_stages(_plain_stages("sqrt2", plan), a, b)


def mpn_mul_trunc(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Truncated 1-D multiply at plan.trunc."""
    assert not plan.sqrt2
    return _run_stages(_plain_stages("trunc", plan), a, b)


def mpn_mul_trunc_sqrt2(a: torch.Tensor, b: torch.Tensor, plan: MulPlan) -> torch.Tensor:
    """Truncated length-4n multiply at plan.trunc."""
    assert plan.sqrt2
    return _run_stages(_plain_stages("trunc_sqrt2", plan), a, b)


def mpn_mul_mfa(a: torch.Tensor, b: torch.Tensor, plan: MulPlan, ctx=None) -> torch.Tensor:
    """Cyclic multiply through the 2-D MFA transforms (n1 columns of n2);
    ctx: sharded over its ranks (the same a, b on each; the product whole
    on each)."""
    assert not plan.sqrt2
    return _run_stages(_plain_stages("mfa", plan, sharded(ctx, plan.n1)), a, b)


def mpn_mul_mfa_trunc(a: torch.Tensor, b: torch.Tensor, plan: MulPlan,
                      ctx=None) -> torch.Tensor:
    """Truncated MFA multiply: trunc_mfa // n1 kept rows; ctx as
    mpn_mul_mfa's."""
    assert not plan.sqrt2
    return _run_stages(_plain_stages("mfa_trunc", plan, sharded(ctx, plan.n1)), a, b)


def _flat_flagship_stages(plan: MulPlan, ctx=None) -> Stages:
    """The unstaged flagship's stages: truncated sqrt2 MFA transforms at
    t = plan.trunc_mfa (the flat sqrt2 pair at t == conv_len), the
    recursive pointwise on the first t rows, the inverse with the divide +
    normmod tail folded in.  Coefficients past j1 + j2 - 1 are zero, so the
    combine takes only plan.trunc.  ctx: the MFA sharded over its ranks at
    every t (ops/mfa.py), the pointwise on each rank's rows, the inverse
    gathered whole onto every rank."""
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    if ctx is not None:
        return Stages(
            _split_fn(plan, plan.conv_len),
            lambda x: mfa_fft_trunc_sqrt2(x, plan.w, W, n1, t, ctx=ctx),
            lambda fa, fb: _pointwise(fa, fb, W, True),
            lambda prod: mfa_ifft_trunc_sqrt2(prod, plan.w, W, n1, t, norm_div=plan.lg_conv,
                                              ctx=ctx, C=plan.conv_len),
            None, _combine_fn(plan, plan.trunc))
    return Stages(
        _split_fn(plan, plan.conv_len),
        lambda x: mfa_fft_trunc_sqrt2(x, plan.w, W, n1, t)[..., :t, :],
        lambda fa, fb: _pointwise(fa, fb, W, True),
        lambda prod: mfa_ifft_trunc_sqrt2(_pad_rows(prod, plan.conv_len), plan.w, W, n1, t,
                                          norm_div=plan.lg_conv),
        None, _combine_fn(plan, plan.trunc))


def mpn_mul_flagship(a: torch.Tensor, b: torch.Tensor, plan: MulPlan,
                     ctx=None) -> torch.Tensor:
    """The production multiply on digit tensors a [..., La], b [..., Lb]
    (the stages of _flat_flagship_stages).  Returns the canonical product
    digits [..., out_len_digits(plan)].  ctx: sharded over its ranks (the
    same a, b on each; the product whole on each); both operands' forwards
    stacked cross to rows in one all-to-all."""
    assert plan.sqrt2
    s = _flat_flagship_stages(plan, sharded(ctx, plan.n1))
    ia, ib = _stage("split", s.split, a), _stage("split", s.split, b)
    with span("fwd"):
        if ia.shape == ib.shape:
            # one transform over both stacked operands: double the batch per launch
            fab = s.fwd(torch.stack([ia, ib]))
            fa, fb = fab[0], fab[1]
        else:
            fa, fb = s.fwd(ia), s.fwd(ib)
    prod = _stage("pw", s.pw, fa, fb)
    del fa, fb
    return _stage("combine", s.combine, _stage("inv", s.inv, prod))


def mpn_sqr_flagship(a: torch.Tensor, plan: MulPlan, ctx=None) -> torch.Tensor:
    """Squaring through the flagship pipeline: one forward transform,
    pointwise fa*fa; ctx as mpn_mul_flagship's."""
    assert plan.sqrt2
    s = _flat_flagship_stages(plan, sharded(ctx, plan.n1))
    fh = _split_fwd(s, a)
    return _stage("combine", s.combine, _stage("inv", s.inv, _stage("pw", s.pw, fh, fh)))


# ---------------------------------------------------------------------------
# Staged execution (the reference's models/mul.py:255-296, :401-515; its
# thresholds unchanged, so the same plans take the same path)
# ---------------------------------------------------------------------------

# above this many coefficient int32 elements, the flagship runs staged
_STAGED_THRESHOLD_ELEMS = 1 << 24

# bytes of spectrum rows per pointwise chunk (twice this where the leaf
# serves the ring): bounds the pointwise's working set
_PW_CHUNK_BYTES = 128 << 20


def flagship_is_staged(plan: MulPlan) -> bool:
    return plan.conv_len * (plan.W // DIGIT_BITS) > _STAGED_THRESHOLD_ELEMS


# ---------------------------------------------------------------------------
# Out-of-core and piecewise routing (the reference's models/mul.py:257-273,
# :557-612, :650-719 and models/huge.py:717-749): above 2^29 coefficient
# elements a flagship plan runs out of core (models/huge.py mul_huge /
# sqr_huge) or, for extreme imbalance, as balanced pieces
# (_mul_piecewise); the rest is refused before any work.  The threshold is
# the reference's, so every plan takes the same route in both packages.
# ---------------------------------------------------------------------------

# above this many coefficient int32 elements the staged pipeline's
# whole-spectrum buffers outgrow the reference's device memory
_HUGE_THRESHOLD_ELEMS = 1 << 29


def flagship_is_huge(plan: MulPlan) -> bool:
    return plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS and huge_serves(plan)


def _require_huge_servable(plan: MulPlan) -> None:
    """Raise ValueError, naming the violated constraints, for a plan past the
    out-of-core threshold that the out-of-core engine cannot serve."""
    if plan.conv_len * (plan.W // DIGIT_BITS) <= _HUGE_THRESHOLD_ELEMS or huge_serves(plan):
        return
    h = plan.conv_len // 2
    why = []
    if plan.j1 > h or plan.j2 > h:
        why.append(
            f"unbalanced operands: j1={plan.j1}, j2={plan.j2} must both be "
            f"<= conv_len/2 = {h} (pick a deeper plan or balance the inputs)")
    if plan.bits1 % DIGIT_BITS:
        why.append(f"bits1={plan.bits1} not digit-aligned")
    if plan.trunc_mfa % plan.n1:
        why.append(f"trunc_mfa={plan.trunc_mfa} not a multiple of n1={plan.n1}")
    raise ValueError(
        "plan exceeds the in-HBM staged pipeline's capacity "
        f"({plan.conv_len}x{plan.W // DIGIT_BITS} int32 elems > "
        f"{_HUGE_THRESHOLD_ELEMS}) but the out-of-core engine cannot serve "
        "it: " + "; ".join(why))


def _piecewise_serves(plan: MulPlan) -> bool:
    """Does the reference take this plan as balanced pieces: past the
    threshold, not out-of-core servable, and the cause is imbalance?"""
    h = plan.conv_len // 2
    return (plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS
            and not huge_serves(plan) and (plan.j1 > h or plan.j2 > h))


def _pw_chunk_rows(plan: MulPlan) -> int:
    """Rows per pointwise chunk (the reference's :493-503): max(256,
    bytes / 4L), at most trunc_mfa, rounded down to whole n1 groups (the
    row-IFFT leg's), at least n1."""
    L = plan.W // DIGIT_BITS
    pw_bytes = _PW_CHUNK_BYTES * (2 if base_serves(L) else 1)
    rows = min(max(256, pw_bytes // (4 * L)), plan.trunc_mfa)
    return max(plan.n1, (rows // plan.n1) * plan.n1)


def _inner_leg(plan: MulPlan):
    """The chunk-local first inverse leg run after each pointwise chunk (ref
    :282-296): at the full length the flat inverse's innermost ladder group
    (ifft_innermost at length conv/2), below it the MFA's row IFFTs;
    identical in both w parities."""
    W, n1 = plan.W, plan.n1
    if plan.trunc_mfa == plan.conv_len:
        return lambda v: ifft_innermost(v, plan.w, W, plan.conv_len // 2)
    row_w = plan.w * ((plan.conv_len // 2) // n1)
    return lambda v: ifft_mfa_rows(v, row_w, W, n1)


def _staged_flagship_stages(plan: MulPlan) -> Stages:
    """The staged flagship's stages (the reference's _staged_flagship,
    models/mul.py:401-515, unsharded), on digit tensors [La] / [Lb]: the
    forward of one operand (zero-top on balanced full-length plans), the
    pointwise in chunks of _pw_chunk_rows rows each followed by its
    chunk-local first inverse leg, the products overwriting the first
    spectrum's rows in place (the reference donates it), the inverse
    without that leg and with the norm tail folded in, the combine."""
    assert plan.sqrt2
    L = plan.W // DIGIT_BITS
    C, W, n1, t = plan.conv_len, plan.W, plan.n1, plan.trunc_mfa
    h = C // 2
    inner = _inner_leg(plan)
    # balanced full-length plans split each operand into <= conv/2
    # coefficients, so the top half of the coefficient array is zero and the
    # sqrt2 top layer degenerates to s = a, t = a q^j (in both w parities:
    # the even-w flat DIF's first stage splits the same way)
    zerotop = t == C and max(plan.j1, plan.j2) <= h
    # the innermost inverse group at the full length, for the Garner kernel
    kg = inner_group(h, L)
    post_steps = inner_steps(plan.w, h, kg)
    rows = _pw_chunk_rows(plan)

    def fwd(ia):
        if zerotop:
            # the t-leg's half-bit twiddle t_j = a_j q^j rides its first ladder group
            return torch.cat([fft_radix2(ia, plan.w, W),
                              fft_radix2(ia, plan.w, W, pre_half=(0, plan.w))], dim=-2)
        return mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t)

    def pw_inner(fa, fb):
        # the pointwise, then its chunk-local first inverse leg; at the full
        # length the leg rides inside the Garner kernel where the NTT serves
        # the ring, and runs here only if the hook was not consumed
        if t == C:
            with garner_post(L, 1 << kg, post_steps) as cell:
                prod = _pointwise(fa, fb, W, True)
            return prod if cell["consumed"] else inner(prod)
        prod = _pointwise(fa, fb, W, True)
        with span("pw.rows"):
            return inner(prod)

    def pw(fa, fb):
        # the forwards hold conv_len rows, the chunks cover the first t
        for i in range(0, t, rows):
            j = min(i + rows, t)
            ca = fa[i:j]
            fa[i:j] = pw_inner(ca, ca if fb is fa else fb[i:j])
        if t < C:
            fa[t:] = 0
            # the chunks' write-back and the fill: every row of fa once
            count_copy(fa)
        return fa

    return Stages(_split_fn(plan, h if zerotop else C), fwd, pw,
                  lambda fa: mfa_ifft_trunc_sqrt2(fa, plan.w, W, n1, t, norm_div=plan.lg_conv,
                                                  rows_done=True),
                  None, _combine_fn(plan, t))


def _staged_flagship_sharded(plan: MulPlan, ctx) -> Stages:
    """The staged flagship's stages sharded over ctx's ranks (the
    reference's models/mul.py:299-398), on the same digit tensors [La] /
    [Lb] on every rank: the split whole on every rank; the MFA forward
    under ctx at every trunc_mfa (no zero-top: the column axis is the shard
    axis), whose all-to-all leaves each rank its rows; the pointwise on the
    rank's rows in _pw_chunk_rows chunks, each followed by its row-IFFT leg
    -- inside the Garner kernel as the group K = n1 where the hook takes it
    (ops/ntt.py garner_post: at full width K n1 rows exceed the ladder's
    buffer and it declines), else ifft_mfa_rows; the inverse with
    rows_done and the norm tail folded in, gathered whole onto every rank;
    the combine.  The reference keeps the pointwise replicated unless t %
    ndev == 0 and (t / ndev) % n1 == 0, so that its flat row shards are
    whole row groups; here a rank's rows are whole rows of n1 by
    construction (each MFA's kept rows padded to a multiple of ndev at the
    exchange), so the pointwise is always the rank's own."""
    L = plan.W // DIGIT_BITS
    C, W, n1, t = plan.conv_len, plan.W, plan.n1, plan.trunc_mfa
    row_w = plan.w * ((C // 2) // n1)
    steps = inner_steps(row_w, n1, n1.bit_length() - 1)
    rows = _pw_chunk_rows(plan)

    def pw_inner(fa, fb):
        with garner_post(L, n1, steps) as cell:
            prod = _pointwise(fa, fb, W, True)
        return prod if cell["consumed"] else ifft_mfa_rows(prod, row_w, W, n1)

    def pw(fa, fb):
        for i in range(0, fa.shape[-2], rows):
            ca = fa[i:i + rows]
            fa[i:i + rows] = pw_inner(ca, ca if fb is fa else fb[i:i + rows])
        return fa

    return Stages(_split_fn(plan, C),
                  lambda ia: mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t, ctx=ctx), pw,
                  lambda fa: mfa_ifft_trunc_sqrt2(fa, plan.w, W, n1, t, norm_div=plan.lg_conv,
                                                  rows_done=True, ctx=ctx, C=C),
                  None, _combine_fn(plan, t))


def _staged_flagship(plan: MulPlan, ctx=None):
    """The staged flagship of a plan as run(da, db=None) on digit tensors
    [La], [Lb] (db None: the square of da) -> the canonical product digits
    [out_len_digits(plan)]: the stages of _staged_flagship_stages, one
    operand's forward at a time; ctx: those of _staged_flagship_sharded
    over its ranks (the same da, db on each; the product whole on each)."""
    ctx = sharded(ctx, plan.n1)
    s = _staged_flagship_stages(plan) if ctx is None else _staged_flagship_sharded(plan, ctx)

    @spanned("flagship")
    def run(da, db=None):
        fa = _split_fwd(s, da)
        fb = fa if db is None else _split_fwd(s, db)
        _stage("pw", s.pw, fa, fb)
        del fb
        c = _stage("inv", s.inv, fa)
        del fa
        return _stage("combine", s.combine, c)

    return run


DRIVERS = {
    "radix2": (mpn_mul_radix2, False),
    "sqrt2": (mpn_mul_sqrt2, True),
    "trunc": (mpn_mul_trunc, False),
    "trunc_sqrt2": (mpn_mul_trunc_sqrt2, True),
    "mfa": (mpn_mul_mfa, False),
    "mfa_trunc": (mpn_mul_mfa_trunc, False),
    "flagship": (mpn_mul_flagship, True),
}


def driver_stages(kind: str, plan: MulPlan) -> Stages:
    """The stages of driver `kind` at `plan` on the route mul() takes: for
    the flagship those of the staged pipeline where flagship_is_staged,
    else of mpn_mul_flagship.  Out-of-core plans have no such stages
    (models/huge.py streams every pass) and raise ValueError, as does a
    plan the reference refuses."""
    assert plan.sqrt2 == DRIVERS[kind][1], (kind, plan)
    if kind != "flagship":
        return _plain_stages(kind, plan)
    _require_huge_servable(plan)
    if flagship_is_huge(plan):
        raise ValueError("an out-of-core plan runs no whole-spectrum stages "
                         f"({plan.conv_len * (plan.W // DIGIT_BITS)} elements > "
                         f"{_HUGE_THRESHOLD_ELEMS})")
    if flagship_is_staged(plan):
        return _staged_flagship_stages(plan)
    return _flat_flagship_stages(plan)


def _tune_enabled() -> bool:
    return os.environ.get("MPIR_FFT_TUNE", "1").lower() not in ("0", "off", "false")


def _select_plan(bits_a: int, bits_b: int, driver: str = "flagship", device="cuda") -> MulPlan:
    """mul()'s plan (the reference's models/mul.py:521-543): a measured
    entry of the tune cache for this device and size bucket
    (utils/tune.py cached_plan, written by `cli tune`) where there is one
    and MPIR_FFT_TUNE is not 0 / off / false, else the analytic plan."""
    if _tune_enabled():
        plan = cached_plan(bits_a, bits_b, driver, device)
        if plan is not None:
            return plan
    return choose_params(bits_a, bits_b, sqrt2=DRIVERS[driver][1])


def _driver(kind: str, plan: MulPlan):
    """run(da, db) -> product digits: the driver of kind at plan, where a
    flagship plan takes mul()'s route -- out of core (flagship_is_huge),
    staged (flagship_is_staged) or whole -- and a plan the reference refuses
    raises ValueError here, before any operand is converted (the
    reference's _jitted_driver, models/mul.py:588-599)."""
    fn, needs_sqrt2 = DRIVERS[kind]
    assert plan.sqrt2 == needs_sqrt2, (kind, plan)
    if kind == "flagship":
        _require_huge_servable(plan)
        if flagship_is_huge(plan):
            return spanned("huge")(lambda da, db: mul_huge(da, db, plan))
        if flagship_is_staged(plan):
            return _staged_flagship(plan)
    return spanned(kind)(lambda da, db: fn(da, db, plan))


def _sqr_driver(plan: MulPlan):
    """run(da) -> the square's digits on sqr()'s route (the reference's
    _jitted_sqr, models/mul.py:603-612)."""
    _require_huge_servable(plan)
    if flagship_is_huge(plan):
        return spanned("huge")(lambda da: sqr_huge(da, plan))
    if flagship_is_staged(plan):
        return _staged_flagship(plan)
    return spanned("flagship")(lambda da: mpn_sqr_flagship(da, plan))


def _mul_piecewise(a: int, b: int, driver: str, device) -> int:
    """Extreme-uneven products past the out-of-core threshold as balanced
    pieces (the reference's models/mul.py:665-702): the larger operand
    splits into pieces the size of the smaller, each piece's product runs
    through the driver's route, and the products accumulate in an int64
    base-2^16 digit window at their digit offsets (O(n) in all), followed
    by one vectorised carry.  Unlike the reference, `b` is converted and
    shipped to the device once, not once a piece, and each product's
    digits land in the accumulator shifted, without a round trip through a
    Python int."""
    ba, bb = a.bit_length(), b.bit_length()
    if ba < bb:
        a, b, ba, bb = b, a, bb, ba
    step = bb
    mask = (1 << step) - 1
    Lout = cdiv(ba + bb, DIGIT_BITS) + 2
    acc = np.zeros(Lout + 4, np.int64)
    db = digits_to_tensor(digits_from_int(b, cdiv(bb, DIGIT_BITS)), device)
    for lo in range(0, ba, step):
        piece = (a >> lo) & mask
        if not piece:
            continue
        bp = piece.bit_length()
        if bp + bb <= _SMALL_THRESHOLD_BITS:
            pd = digits_from_int(piece * b, cdiv(bp + bb, DIGIT_BITS))
        else:
            plan = _select_plan(bp, bb, driver, device)
            if driver == "flagship" and _piecewise_serves(plan):
                pv = mul(piece, b, driver, device)
                pd = digits_from_int(pv, cdiv(max(pv.bit_length(), 1), DIGIT_BITS))
            else:
                dp = digits_to_tensor(digits_from_int(piece, cdiv(bp, DIGIT_BITS)), device)
                pd = tensor_to_digits(_driver(driver, plan)(dp, db))
        q = lo // DIGIT_BITS
        acc[q:q + pd.shape[0]] += pd.astype(np.int64) << (lo % DIGIT_BITS)
    # every digit is a sum of shifted canonical digits (< 2^33): each
    # vectorised carry pass shrinks the largest, and the loop ends
    while True:
        c = acc >> DIGIT_BITS
        if not c.any():
            break
        acc = (acc - (c << DIGIT_BITS)) + np.concatenate([[0], c[:-1]])
    assert acc[Lout:].max(initial=0) == 0
    return int.from_bytes(acc[:Lout].astype("<u2").tobytes(), "little")


def _to_device(convert, v, n: int, device) -> torch.Tensor:
    """convert(v, n) (the host's digits) inside mf.digits_from_int, then
    their copy to `device` inside mf.h2d."""
    with span("digits_from_int"):
        digits = convert(v, n)
    with span("h2d"):
        return digits_to_tensor(digits, device)


def _from_device(t: torch.Tensor, convert):
    """The digits t copied to the host inside mf.d2h (the host waits there
    for the device), then convert(digits) inside mf.int_from_digits."""
    with span("d2h"):
        digits = tensor_to_digits(t)
    with span("int_from_digits"):
        return convert(digits)


@spanned("mul")
def mul(a: int, b: int, driver: str = "flagship", device="cuda") -> int:
    """Multiply two nonnegative Python ints through a driver of DRIVERS on
    `device`.  Small products are computed on the host.  A flagship plan
    past 2^29 elements runs out of core or, for extreme imbalance, as
    balanced pieces; one the reference refuses (`_require_huge_servable`)
    raises ValueError before any work."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {sorted(DRIVERS)}")
    if a < 0 or b < 0:
        raise ValueError("nonnegative operands only (mpn semantics)")
    if a == 0 or b == 0:
        return 0
    ba, bb = a.bit_length(), b.bit_length()
    if ba + bb <= _SMALL_THRESHOLD_BITS:
        return a * b
    plan = _select_plan(ba, bb, driver, device)
    if driver == "flagship" and _piecewise_serves(plan):
        return _mul_piecewise(a, b, driver, device)
    run = _driver(driver, plan)
    da = _to_device(digits_from_int, a, cdiv(ba, DIGIT_BITS), device)
    db = _to_device(digits_from_int, b, cdiv(bb, DIGIT_BITS), device)
    return _from_device(run(da, db), int_from_digits)


@spanned("sqr")
def sqr(a: int, device="cuda") -> int:
    """Square a nonnegative Python int with one forward transform (out of
    core past 2^29 elements); a plan the reference refuses raises
    ValueError before any work."""
    if a < 0:
        raise ValueError("nonnegative operand only (mpn semantics)")
    if a == 0:
        return 0
    ba = a.bit_length()
    if 2 * ba <= _SMALL_THRESHOLD_BITS:
        return a * a
    run = _sqr_driver(_select_plan(ba, ba, "flagship", device))
    da = _to_device(digits_from_int, a, cdiv(ba, DIGIT_BITS), device)
    return _from_device(run(da), int_from_digits)


@spanned("mul_many")
def mul_many(pairs, driver: str = "flagship", device="cuda") -> list[int]:
    """Multiply many (a, b) pairs of nonnegative ints in ONE batched driver
    call (the reference's models/mul.py:615-647): every op of the pipeline
    takes leading dims, so k products share one chain of launches.

    All pairs share one plan sized for the largest operands; smaller
    operands are zero-padded (exact: padding only widens the ring).  Plans
    that run staged or out of core loop over `mul` instead: there one
    product already fills the card.  A batch of one, or products below the
    host threshold, compute on the host, as in the reference."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; one of {sorted(DRIVERS)}")
    pairs = list(pairs)
    for a, b in pairs:
        if a < 0 or b < 0:
            raise ValueError("nonnegative operands only (mpn semantics)")
    if not pairs:
        return []
    ba = max(a.bit_length() for a, _ in pairs)
    bb = max(b.bit_length() for _, b in pairs)
    if ba == 0 or bb == 0 or ba + bb <= _SMALL_THRESHOLD_BITS or len(pairs) == 1:
        return [a * b for a, b in pairs]
    # the analytic plan: the tune cache holds no batch-class entries (utils/tune.py)
    plan = choose_params(ba, bb, sqrt2=DRIVERS[driver][1])
    if driver == "flagship" and (flagship_is_huge(plan) or flagship_is_staged(plan)):
        return [mul(a, b, driver, device) for a, b in pairs]
    La, Lb = cdiv(ba, DIGIT_BITS), cdiv(bb, DIGIT_BITS)

    def stacked(vs, n):
        return np.stack([digits_from_int(v, n) for v in vs])

    da = _to_device(stacked, [a for a, _ in pairs], La, device)
    db = _to_device(stacked, [b for _, b in pairs], Lb, device)
    return _from_device(_driver(driver, plan)(da, db),
                        lambda out: [int_from_digits(row) for row in out])
