"""The port's staged flagship (models/mul.py _staged_flagship) and its pieces
-- the ladder's pre_half twiddle, skip_inner / rows_done, and the Garner
kernel's garner_post leg -- against the JAX package on the same numpy
inputs.

The reference runs as tests/test_staged.py runs it: its staged pipeline
and its Garner hook under force_pallas(True), so its Pallas kernels run in
interpret mode.  The two packages group the inverse's innermost stages
differently (the port's inner_group follows its own ladder grouping), so
raw redundant digits may differ: transforms are compared after normmod,
products as integers.  All arithmetic is integer: the tolerance is exact."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.ops import mfa as jmfa
from mpir_fft_tpu.ops import ntt as jntt
from mpir_fft_tpu.ops import pointwise as jpw
from mpir_fft_tpu.ops import sqrt2 as jsqrt2
from mpir_fft_tpu.ops import transforms as jtr
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu.ops.limb import normmod as jnormmod
from mpir_fft_tpu.utils.params import MulPlan as JMulPlan
from mpir_fft_tpu.utils.params import choose_params as j_choose_params
from mpir_fft_tpu.utils.params import plan_for_depth as j_plan_for_depth
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import mfa as tmfa
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops import pointwise as tpw
from mpir_fft_tpu_torch.ops import sqrt2 as tsqrt2
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params, plan_for_depth, validate


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    return normmod(T(np.asarray(x))).numpy()


def _rand(rng, shape):
    return rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32)


def jref(fn, x, **static):
    """The reference function fn(x, **static) jitted, on a numpy input."""
    return np.asarray(jax.jit(functools.partial(fn, **static))(jnp.asarray(x)))


def _rand_int(rng, bits):
    v = int.from_bytes(rng.bytes(cdiv(bits, 8)), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


# ---------------------------------------------------------------------------
# the staged flagship, end to end (the cases of tests/test_staged.py:61-100)
# ---------------------------------------------------------------------------

# (depth, w, bits1, j1, j2, bits_a, bits_b) of hand-built plans
FLAT_EVEN = (5, 64, 1008, 40, 40, 40320, 40320)    # zero-top, L 128 (NTT, hook taken)
FLAT_ODD = (7, 1, 48, 200, 200, 9600, 9600)        # zero-top, odd w, L 8 (NTT, hook taken)
TRUNC = (5, 64, 992, 16, 15, 15800, 14600)         # trunc_mfa < conv_len: MFA, row leg


def _plans(case):
    """(port plan, reference plan) of a case."""
    if case == "unbalanced":         # full length, j1 > conv/2: no zero-top, schoolbook
        return plan_for_depth(24000, 6000, 4, sqrt2=True), j_plan_for_depth(24000, 6000, 4, True)
    args = {"flat_even": FLAT_EVEN, "flat_odd": FLAT_ODD, "trunc": TRUNC}[case]
    names = ("depth", "w", "bits1", "j1", "j2", "bits_a", "bits_b")
    kw = dict(zip(names, args), sqrt2=True)
    return validate(MulPlan(**kw)), JMulPlan(**kw)


def _ref_staged(plan, a, b):
    """The reference's staged pipeline under forced Pallas (b None: sqr)."""
    jmul._staged_flagship.cache_clear()
    try:
        with force_pallas(True):
            fn = jmul._staged_flagship(plan)
            da = jnp.asarray(digits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS)))
            if b is None:
                return int_from_digits(np.asarray(fn(da)))
            db = jnp.asarray(digits_from_int(b, cdiv(plan.bits_b, DIGIT_BITS)))
            return int_from_digits(np.asarray(fn(da, db)))
    finally:
        jmul._staged_flagship.cache_clear()


def _port_staged(plan, a, b):
    da = torch.from_numpy(digits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS)))
    db = None if b is None else torch.from_numpy(digits_from_int(b, cdiv(plan.bits_b,
                                                                          DIGIT_BITS)))
    return int_from_digits(tmul._staged_flagship(plan)(da, db).numpy())


def _spy_post(monkeypatch):
    """Record what every pointwise's Garner step took from the hook."""
    taken = []
    real = tntt._take_post

    def spy(B, M):
        got = real(B, M)
        taken.append(got)
        return got

    monkeypatch.setattr(tntt, "_take_post", spy)
    return taken


@pytest.mark.parametrize("case,square", [("flat_even", False), ("flat_even", True),
                                         ("flat_odd", False), ("unbalanced", False),
                                         ("trunc", False)])
def test_staged_matches_product_and_reference(rng, monkeypatch, case, square):
    """Each case equals a*b and the reference's staged result; the
    zero-top cases take the hook (the inverse leg inside the Garner step),
    the others never see one consumed."""
    plan, jplan = _plans(case)
    assert plan.trunc_mfa == jplan.trunc_mfa
    h = plan.conv_len // 2
    zerotop = plan.trunc_mfa == plan.conv_len and max(plan.j1, plan.j2) <= h
    assert zerotop == case.startswith("flat")
    assert (plan.trunc_mfa < plan.conv_len) == (case == "trunc")
    assert (plan.w % 2 == 1) == (case in ("flat_odd", "unbalanced"))
    a = _rand_int(rng, plan.bits_a)
    b = None if square else _rand_int(rng, plan.bits_b)
    taken = _spy_post(monkeypatch)
    rows = []
    real_pw = tmul._pointwise

    def pw(fa, fb, W, recursive):
        rows.append(fa.shape[0])
        return real_pw(fa, fb, W, recursive)

    monkeypatch.setattr(tmul, "_pointwise", pw)
    if case == "trunc":     # several chunks, the last one short (32 = 24 + 8 rows)
        monkeypatch.setattr(tmul, "_pw_chunk_rows", lambda p: 3 * p.n1)
    got = _port_staged(plan, a, b)
    want = a * (a if square else b)
    assert got == want
    assert sum(rows) == plan.trunc_mfa        # the chunks cover the kept rows only
    assert _ref_staged(jplan, a, b) == want
    consumed = [t for t in taken if t is not None]
    if zerotop:
        K = 1 << ttr.inner_group(h, plan.W // DIGIT_BITS)
        assert consumed and all(t[0] == K for t in consumed)
    else:
        assert not consumed


def test_staged_leg_taken_outside_garner_under_ntt_off(rng, monkeypatch):
    """MPIR_FFT_NTT=0: the zero-top plan's pointwise is the schoolbook, the
    hook stays unconsumed, and the caller's own ladder leg keeps the product
    exact."""
    monkeypatch.setenv("MPIR_FFT_NTT", "0")
    plan, _ = _plans("flat_even")
    a, b = _rand_int(rng, plan.bits_a), _rand_int(rng, plan.bits_b)
    taken = _spy_post(monkeypatch)
    legs = []
    real = tmul.ifft_innermost

    def leg(*args):
        legs.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tmul, "ifft_innermost", leg)
    assert _port_staged(plan, a, b) == a * b
    assert not taken and legs


# ---------------------------------------------------------------------------
# routing: the same plans take the staged path in both packages
# ---------------------------------------------------------------------------

SIZES = [(10**6, 10**6), (10**7, 10**7), (10**8, 10**8), (10**9, 10**9),
         (2 * 10**9, 2 * 10**9), (10_000_000, 7_000_000), (63_095_734, 5_011_872),
         (398_107_170, 199_053_585), (1_000_000_000, 100_000_000)]


def _ref_chunk_rows(jplan):
    """The reference's chunk rule, inline in its _staged_flagship
    (models/mul.py:493-503), from its own constants."""
    L = jplan.W // DIGIT_BITS
    pw_bytes = jmul._PW_CHUNK_BYTES * (2 if jpw.base_serves(L) else 1)
    rows = min(max(256, pw_bytes // (4 * L)), jplan.trunc_mfa)
    return max(jplan.n1, (rows // jplan.n1) * jplan.n1)


@pytest.mark.parametrize("ntt", ["1", "0"])
def test_staging_rule_matches_reference(monkeypatch, ntt):
    """flagship_is_staged and the chunk rows equal the reference's on the
    default plans from 10^6 to 2x10^9 bits and the four unbalanced sizes
    (and on the MPIR_FFT_NTT=0 plans): pure planner calls."""
    monkeypatch.setenv("MPIR_FFT_NTT", ntt)
    assert tmul._STAGED_THRESHOLD_ELEMS == jmul._STAGED_THRESHOLD_ELEMS
    assert tmul._PW_CHUNK_BYTES == jmul._PW_CHUNK_BYTES
    staged = []
    for ba, bb in SIZES:
        plan, jplan = choose_params(ba, bb, sqrt2=True), j_choose_params(ba, bb, sqrt2=True)
        assert tmul.flagship_is_staged(plan) == jmul.flagship_is_staged(jplan), (ba, bb)
        assert tmul._pw_chunk_rows(plan) == _ref_chunk_rows(jplan), (ba, bb)
        staged.append(tmul.flagship_is_staged(plan))
    if ntt == "1":    # 10^8 and up, and both L 2048 unbalanced plans
        assert staged == [False, False, True, True, True, False, False, True, True]


@pytest.mark.parametrize("threshold,want_staged", [(0, True), (1 << 40, False)])
def test_mul_and_sqr_route_by_flagship_is_staged(rng, monkeypatch, threshold, want_staged):
    """mul() and sqr() send a plan to _staged_flagship exactly when
    flagship_is_staged holds (moved here by the threshold), mpn_*_flagship
    otherwise, and stay exact either way; other drivers are never staged."""
    monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", threshold)
    calls = []
    real = tmul._staged_flagship

    def spy(plan):
        calls.append(plan)
        return real(plan)

    monkeypatch.setattr(tmul, "_staged_flagship", spy)
    a, b = _rand_int(rng, 40000), _rand_int(rng, 30000)
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(a, device="cpu") == a * a
    assert tmul.mul(a, b, driver="sqrt2", device="cpu") == a * b
    assert len(calls) == (2 if want_staged else 0)


# ---------------------------------------------------------------------------
# pre_half: the t-leg twiddle riding the first ladder group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,w,e0,step2", [((64, 8), 3, 0, 3), ((2, 256, 128), 2, 5, 2),
                                              ((2, 16, 4), 1, 0, 1), ((1, 4), 5, 7, 5)])
def test_fft_pre_half_matches_reference(rng, shape, w, e0, step2):
    """fft_radix2(pre_half=) equals the reference's, and equals
    twiddle_half followed by fft_radix2: on the ladder route (a single
    operand (64, 8) and a stacked (2, 256, 128), whose rows exceed the
    whole-transform block), on the whole-transform route (stacked (2, 16,
    4)) and at length 1."""
    C, L = shape[-2], shape[-1]
    W = DIGIT_BITS * L
    x = _rand(rng, shape)
    got = ttr.fft_radix2(T(x), w, W, pre_half=(e0, step2))
    e2 = e0 + np.arange(C, dtype=np.int64) * step2
    sep = ttr.fft_radix2(tsqrt2.twiddle_half(T(x), e2, W), w, W)
    assert np.array_equal(canon(got), canon(sep))
    want = jref(jtr.fft_radix2, x, w=w, W=W, pre_half=(e0, step2))
    assert np.array_equal(canon(got), canon(want))


def test_ladder_pre_half_plain_is_twiddle_then_stages(rng):
    """The ladder's plain version with pre_half: the half-bit twiddle of
    transform position q*h + hpos, then the stages -- raw digits equal to
    twiddle_half_rows_plain followed by ladder_plain."""
    N, K, h, L, W = 3, 8, 4, 8, 128
    steps = (3, 6, 12)
    x = T(_rand(rng, (N, K, h, L)))
    got = tfused.fused_butterfly_ladder("fwd", x, steps, W, pre_half=(5, 3))
    j = torch.arange(K * h, dtype=torch.int64).reshape(K, h)
    e2 = torch.remainder(5 + 3 * j, 4 * W)[None, :, :, None].expand(N, K, h, 1)
    tw = tfused.twiddle_half_rows_plain(x.reshape(-1, L), e2.reshape(-1, 1), W)
    assert torch.equal(got, tfused.ladder_plain("fwd", tw.reshape(x.shape), steps, W))
    with pytest.raises(ValueError):
        tfused.fused_butterfly_ladder("inv", x, steps, W, pre_half=(5, 3))


# ---------------------------------------------------------------------------
# skip_inner / rows_done: the chunk-local first inverse leg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,L,w", [(64, 8, 3), (64, 8, 4), (32, 2048, 1)])
def test_ifft_skip_inner_after_innermost(rng, C, L, w):
    """ifft_sqrt2(skip_inner=inner_group(C/2, L)) after ifft_innermost
    equals ifft_sqrt2, in both w parities (odd w: the halves' transforms;
    even w: one length-C transform at root 2^(w/2)), and the reference's
    ifft_sqrt2 after normmod.  At L 2048 the port's group is 3 stages, the
    reference's 4."""
    W = DIGIT_BITS * L
    x = _rand(rng, (C, L))
    h = C // 2
    kg = ttr.inner_group(h, L)
    assert kg == tfused.ladder_groups(h, L, "inv")[0][1]
    full = tsqrt2.ifft_sqrt2(T(x), w, W)
    legged = tsqrt2.ifft_sqrt2(ttr.ifft_innermost(T(x), w, W, h), w, W, skip_inner=kg)
    assert np.array_equal(canon(legged), canon(full))
    assert np.array_equal(canon(legged), canon(jref(jsqrt2.ifft_sqrt2, x, w=w, W=W)))
    body = ttr.ifft_innermost_body(T(x), ttr.inner_steps(w, h, kg), W, 1 << kg)
    assert torch.equal(body, ttr.ifft_innermost(T(x), w, W, h))


@pytest.mark.parametrize("n,w,n1,trunc", [(16, 1, 4, 40), (16, 3, 8, 16), (16, 2, 4, 44)])
def test_mfa_rows_done_matches_reference(rng, n, w, n1, trunc):
    """mfa_ifft_trunc_sqrt2(rows_done=True) after ifft_mfa_rows on the kept
    positions equals the reference's rows_done inverse after its
    ifft_mfa_rows, and the port's own inverse without the split, at the
    positions < trunc (odd w with trunc above and below C/2, even w)."""
    W = n * w
    L = W // DIGIT_BITS
    C = 4 * n
    x = _rand(rng, (C, L))
    x[trunc:] = 0
    n2 = (C // 2) // n1
    row_w = w * n2
    v = T(x).clone()
    v[:trunc] = tmfa.ifft_mfa_rows(v[:trunc], row_w, W, n1)
    got = tmfa.mfa_ifft_trunc_sqrt2(v, w, W, n1, trunc, rows_done=True)
    plain = tmfa.mfa_ifft_trunc_sqrt2(T(x), w, W, n1, trunc)
    jv = np.array(x)
    jv[:trunc] = jref(jmfa.ifft_mfa_rows, x[:trunc], row_w=row_w, W=W, n1=n1)
    want = jref(jmfa.mfa_ifft_trunc_sqrt2, jv, w=w, W=W, n1=n1, trunc=trunc, rows_done=True)
    assert np.array_equal(canon(got)[:trunc], canon(plain)[:trunc])
    assert np.array_equal(canon(got)[:trunc], canon(want)[:trunc])


# ---------------------------------------------------------------------------
# garner_post: the inverse leg inside the Garner step
# ---------------------------------------------------------------------------

def _body(steps, W, K):
    return lambda d: ttr.ifft_innermost_body(d, steps, W, K)


@pytest.mark.parametrize("M,B", [(128, 64), (4096, 8)])
def test_garner_post_fused_equals_separate(rng, M, B):
    """Both Garner forms (the dense tier's garner_carry at M 128, the 4-step
    tier's garner_residues at M 4096) with the post leg equal the plain
    Garner followed by ifft_innermost_body, raw digits identical; and a
    pointwise under the hook equals the leg run after it, with the hook
    consumed."""
    W = DIGIT_BITS * M
    kg = tfused.ladder_stages(M)
    K = 1 << kg
    steps = tuple(W >> (kg - j) for j in range(kg))
    body = _body(steps, W, K)
    if M <= tntt.TIER1_MAX_M:
        lim = 2 * M * 128 * 128
        parts = [T(rng.integers(-lim, lim + 1, (B, 2 * M))) for _ in range(3)]
        got = tntt.garner_carry(*parts, post=(K, steps))
        assert torch.equal(got, body(tntt.garner_carry_plain(*parts)))
    else:
        parts = [T(rng.integers(0, p, (B, M))) for p in tntt.PRIMES_T2]
        got = tntt.garner_residues(*parts, post=(K, steps))
        assert torch.equal(got, body(tntt.garner_residues_plain(*parts)))
    a, b = T(_rand(rng, (B, M))), T(_rand(rng, (B, M)))
    with tntt.garner_post(M, K, steps) as cell:
        fused = tpw.mulmod_base(a, b, canonical=False)
    assert cell["consumed"] is True
    assert torch.equal(fused, body(tpw.mulmod_base(a, b, canonical=False)))
    with pytest.raises(ValueError):       # K must divide the rows
        tntt.garner_carry(*[T(np.zeros((6, 256), np.int32))] * 3, post=(4, (1, 2)))


def test_garner_post_matches_reference(rng):
    """At the reference's own test shape (L 128, B 64, K 8, stages W/8, W/4,
    W/2) the port's fused pointwise equals the reference's garner_post
    pointwise after normmod."""
    L, W, B, K = 128, 2048, 64, 8
    steps = (W // 8, W // 4, W // 2)
    a, b = _rand(rng, (B, L)), _rand(rng, (B, L))
    with tntt.garner_post(L, K, steps) as cell:
        got = tpw.mulmod_base(T(a), T(b), canonical=False)
    assert cell["consumed"] is True
    jbody = lambda blk: jtr.ifft_innermost_body(blk, list(steps), W, K)
    with force_pallas(True):
        with jntt.garner_post(L, K, jbody) as jcell:
            want = jpw.mulmod_base(jnp.asarray(a), jnp.asarray(b), canonical=False)
    assert jcell["consumed"] is True
    assert np.array_equal(normmod(got).numpy(), np.asarray(jnormmod(want)))


def test_garner_post_unconsumed_under_ntt_off(rng, monkeypatch):
    """MPIR_FFT_NTT=0: the schoolbook leaves the hook unconsumed, and the
    caller's leg after it gives the values of the consumed NTT pointwise
    (ref tests/test_staged.py:137-169), row by row mod p; a hook for
    another ring width is never taken either."""
    L, W, B, K = 128, 2048, 16, 8
    steps = (W // 8, W // 4, W // 2)
    body = _body(steps, W, K)
    a, b = T(_rand(rng, (B, L))), T(_rand(rng, (B, L)))
    with tntt.garner_post(2 * L, K, steps) as cell:
        tpw.mulmod_base(a, b, canonical=False)
    assert cell["consumed"] is False
    with tntt.garner_post(L, K, steps) as cell:
        ntt_out = tpw.mulmod_base(a, b, canonical=False)
    assert cell["consumed"] is True
    monkeypatch.setenv("MPIR_FFT_NTT", "0")
    with tntt.garner_post(L, K, steps) as cell:
        prod = tpw.mulmod_base(a, b, canonical=False)
    assert cell["consumed"] is False
    assert torch.equal(normmod(ntt_out), normmod(body(prod)))
