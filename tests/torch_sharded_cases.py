"""What tests/test_torch_sharded.py runs on spawned ranks: each case is
fn(ctx, *args) at module level (the spawn start method imports it here)
and returns host objects.  Imports no JAX: the ranks load only the port."""

import numpy as np
import torch

import mpir_fft_tpu_torch.models.mul as M
from mpir_fft_tpu_torch.models import huge
from mpir_fft_tpu_torch.ops import ntt
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.ops.mfa import _flat, _segments, _shares, mfa_fft_trunc_sqrt2
from mpir_fft_tpu_torch.ops.truncate import _cat
from mpir_fft_tpu_torch.ops.split import fft_split_bits
from mpir_fft_tpu_torch.parallel import mfa_sharded as S
from mpir_fft_tpu_torch.utils.interop import tensor_to_digits
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, plan_for_depth, validate


def run(ctx, cases):
    """{name: fn(ctx, *args)} for cases [(name, fn, args)], in order."""
    return {name: fn(ctx, *args) for name, fn, args in cases}


def _counts(ctx):
    """The exchanges ctx ran and their bytes (not their ms: those differ
    between ranks)."""
    return {k: v for k, v in ctx.stats.items() if k != "ms"}


def _on(ctx, v, bits):
    return torch.from_numpy(digits_from_int(v, cdiv(bits, DIGIT_BITS))).to(ctx.device)


def gather_spectrum(v, n1, trunc, C, w, ctx):
    """The spectrum of mfa_fft_trunc_sqrt2 under ctx, whole on every rank:
    the ranks' rows v [..., P n1, L] gathered into the unsharded layout's
    positions [0, trunc)."""
    L = v.shape[-1]
    g = ctx.gather(v.reshape(v.shape[:-2] + (1, -1, n1, L)), -4)
    out, at = [], 0
    segs = _segments(C, w, n1, trunc)
    for (_, t2, _, _), p in zip(segs, _shares([s[1] for s in segs], ctx.ndev)):
        rows = g[..., at:at + p, :, :].reshape(g.shape[:-4] + (-1, n1, L))
        out.append(_flat(rows[..., :t2, :, :]))
        at += p
    return _cat(*out)


def spectrum(ctx, digits, fields, trunc):
    """The sharded sqrt2 forward of digits at plan fields, gathered whole,
    and the exchanges the forward ran: (positions [trunc, L], stats)."""
    plan = validate(MulPlan(**fields))
    x = fft_split_bits(torch.from_numpy(digits).to(ctx.device), plan.bits1, plan.conv_len,
                       plan.W // DIGIT_BITS)
    ctx.reset_stats()
    v = mfa_fft_trunc_sqrt2(x, plan.w, plan.W, plan.n1, trunc, ctx=ctx)
    stats = _counts(ctx)
    whole = gather_spectrum(v, plan.n1, trunc, plan.conv_len, plan.w, ctx)
    return tensor_to_digits(whole), stats


def product(ctx, kind, fields, a, b):
    """The product digits of a, b through driver kind (mfa, mfa_trunc,
    flagship; staged, the sharded staged flagship) sharded over ctx."""
    plan = validate(MulPlan(**fields))
    da, db = _on(ctx, a, plan.bits_a), _on(ctx, b, plan.bits_b)
    if kind == "staged":
        return tensor_to_digits(M._staged_flagship(plan, ctx)(da, db))
    return tensor_to_digits(S.sharded_mul_fn(ctx, plan, kind)(da, db))


def garner(ctx, fields, a, b):
    """The sharded staged flagship's product and square at a hand-built
    plan, staging forced, and whether each pointwise's Garner hook was
    consumed: (product digits, square digits, [taken per pointwise])."""
    plan = validate(MulPlan(**fields))
    taken, real = [], ntt._take_post

    def spy(B, Mr):
        post = real(B, Mr)
        taken.append(post is not None)
        return post

    ntt._take_post, old = spy, M._STAGED_THRESHOLD_ELEMS
    M._STAGED_THRESHOLD_ELEMS = 0
    try:
        run_ = S.sharded_mul_fn(ctx, plan, "flagship")
        da = _on(ctx, a, plan.bits_a)
        prod = tensor_to_digits(run_(da, _on(ctx, b, plan.bits_b)))
        sq = tensor_to_digits(run_(da))
    finally:
        ntt._take_post, M._STAGED_THRESHOLD_ELEMS = real, old
    return prod, sq, taken


def exchanges(ctx, fields, a, b):
    """The sharded staged flagship stage by stage, the exchanges counted
    after each: [(stage, all_to_all, all_gather)], and the product's
    digits; then the unstaged flagship's counts (both forwards stacked)."""
    plan = validate(MulPlan(**fields))
    s = M._staged_flagship_sharded(plan, ctx)
    da, db = _on(ctx, a, plan.bits_a), _on(ctx, b, plan.bits_b)
    seen = []

    def note(stage):
        seen.append((stage, ctx.stats["all_to_all"], ctx.stats["all_gather"]))

    ctx.reset_stats()
    fa = s.fwd(s.split(da))
    note("forward a")
    fb = s.fwd(s.split(db))
    note("forward b")
    s.pw(fa, fb)
    note("pointwise")
    out = tensor_to_digits(s.combine(s.inv(fa)))
    note("inverse")
    ctx.reset_stats()
    flat = tensor_to_digits(M.mpn_mul_flagship(da, db, plan, ctx=ctx))
    note("unstaged")
    return seen, out, flat


def dp_uneven(ctx):
    """Whether the data-parallel batch refuses ndev + 1 pairs."""
    plan = plan_for_depth(1 << 13, 1 << 13, 3, sqrt2=True)
    d = torch.ones((ctx.ndev + 1, cdiv(1 << 13, DIGIT_BITS)), dtype=torch.int32,
                   device=ctx.device)
    try:
        S.sharded_mul_many_fn(ctx, plan)(d, d)
    except ValueError:
        return True
    return False


def out_of_core(ctx, fields, a, b, square):
    """mul_huge (sqr_huge) sharded over ctx with small chunks: (product
    digits, the exchanges it ran, whether the passes were sharded)."""
    plan = validate(MulPlan(**fields))
    old = huge.CHUNK_BYTES, huge.PW_CHUNK_BYTES
    huge.CHUNK_BYTES, huge.PW_CHUNK_BYTES = 1 << 14, 1 << 13
    ctx.reset_stats()
    try:
        da = _on(ctx, a, plan.bits_a)
        out = (huge.sqr_huge(da, plan, ctx) if square
               else huge.mul_huge(da, _on(ctx, b, plan.bits_b), plan, ctx))
    finally:
        huge.CHUNK_BYTES, huge.PW_CHUNK_BYTES = old
    return tensor_to_digits(out), _counts(ctx), huge._sharded(ctx, plan) is not None


def value(digits) -> int:
    return int_from_digits(np.asarray(digits))
