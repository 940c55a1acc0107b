"""The port's 2-D MFA transforms (ops/mfa.py) and its column kernel's program
(ops/fused.py mfa_cols_schedule) against the JAX package on the same numpy
inputs.

Transform values are compared mod p after normmod, at the kept positions
only (rows < trunc2, positions < trunc): the reference leaves the rest
unspecified.  The column kernel's schedule is run here by a torch
interpreter, op for op the integer sequence csrc/mfa_cols.cu runs, and must
give the plain version's raw digits.  All arithmetic is integer, so the
tolerance is exact.  The reference runs under jax.jit, and once under
force_pallas(True), so that its fused_batched_idx column kernel runs in
interpret mode."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpir_fft_tpu.ops import mfa as jmfa
from mpir_fft_tpu.ops.fused import MAX_FUSED_L, force_pallas, whole_row_ok
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import mfa as tmfa
from mpir_fft_tpu_torch.ops.limb import carry_pass, normmod, shift_mod
from mpir_fft_tpu_torch.utils.params import choose_params

# (n, w, n1, n2) of tests/test_mfa.py's CASES: C = 2n = n1 n2, W = n w
CASES = [(8, 2, 4, 4), (8, 16, 2, 8), (16, 4, 8, 4), (32, 2, 8, 8)]


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def canon(x):
    return normmod(T(np.asarray(x))).numpy()


def _rand(rng, shape):
    return rng.integers(-(1 << 17), 1 << 17, shape).astype(np.int32)


def jref(fn, x, **static):
    """The reference function fn(x, **static) jitted, on a numpy input."""
    return np.asarray(jax.jit(functools.partial(fn, **static))(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the column kernel's program, interpreted
# ---------------------------------------------------------------------------

def interpret_cols(kind, x, w, W, n1, trunc2, one):
    """Run mfa_cols_schedule on x (B, n2, L) as csrc/mfa_cols.cu runs it:
    every op on whole rows, in place, with the kernel's shifts (the tensor
    path of shift_mod) and carries."""
    B, n2, L = x.shape
    W2 = 2 * W
    kmax = tfused.ladder_stages(L)
    pe = tmfa._block_cross_exps(B, 0, n1 - 1, n2, w, W)
    X = x.clone()

    def sh(v, e):
        e = torch.remainder(torch.as_tensor(e, dtype=torch.int64), W2)
        return shift_mod(v, e[:, None] if e.ndim else e, W)

    def stage(lo, C, s, wr, inverse, use_pe, carry):
        half = C >> (s + 1)
        for p in range(C // 2):
            pos = p % half
            qa = lo + (p // half) * 2 * half + pos
            qb = qa + half
            e = pos * (wr << s) % W2
            A, Bv = X[:, qa], X[:, qb]
            if use_pe:
                e0, e1 = pe[:, qa], (e + pe[:, qb]) % W2
                if not inverse:
                    s0, s1 = sh(A + Bv, e0), sh(A - Bv, e1)
                else:
                    a, u = sh(A, -e0), sh(Bv, -e1)
                    s0, s1 = a + u, a - u
            elif not inverse:
                s0, s1 = A + Bv, sh(A - Bv, e)
            else:
                u = sh(Bv, -e)
                s0, s1 = A + u, A - u
            if carry:
                s0, s1 = carry_pass(s0), carry_pass(s1)
            X[:, qa], X[:, qb] = s0, s1

    def transform(lo, C, wr, inverse, use_pe):
        D = C.bit_length() - 1
        if D == 0:
            if use_pe:
                X[:, lo] = sh(X[:, lo], -pe[:, lo] if inverse else pe[:, lo])
            return
        done = 0
        while done < D:
            kg = min(kmax, D - done)
            first = D - done - kg if inverse else done
            for jj in range(kg):
                s = first + kg - 1 - jj if inverse else first + jj
                stage(lo, C, s, wr, inverse, use_pe and s == D - 1, jj == kg - 1)
            done += kg

    def dbl(v):
        return carry_pass(v + v)

    for op, lo, n, k, e1, e2, wr, use_pe in tfused.mfa_cols_schedule(kind, n2, w * n1,
                                                                    trunc2, one):
        if op in (tfused._OP_FFT, tfused._OP_IFFT):
            transform(lo, n, wr, op == tfused._OP_IFFT, bool(use_pe))
        elif op == tfused._OP_TOP_FWD:
            for j in range(n):
                A, Bv = X[:, lo + j], X[:, lo + n + j]
                if j < k:
                    X[:, lo + j], X[:, lo + n + j] = carry_pass(A + Bv), sh(A - Bv, j * wr)
                else:
                    X[:, lo + n + j] = sh(A, j * wr)
        elif op == tfused._OP_FOLD:
            for j in range(k, e1):
                X[:, lo + j] = carry_pass(X[:, lo + j] + X[:, lo + n + j])
        elif op == tfused._OP_DOUBLE:
            for j in range(n):
                X[:, lo + j] = dbl(X[:, lo + j])
        elif op == tfused._OP_RESTORE:
            X[:, lo:lo + n] = x[:, lo:lo + n]
        elif op == tfused._OP_PE_DIV:
            for j in range(n):
                X[:, lo + j] = sh(X[:, lo + j], -pe[:, lo + j])
        elif op == tfused._OP_TAIL0:
            for j in range(k, n):
                A = X[:, lo + j]
                X[:, lo + j], X[:, lo + n + j] = dbl(A), sh(A, j * wr - e1)
        elif op == tfused._OP_TAIL1:
            for j in range(k, n):
                A, Bv = X[:, lo + j], X[:, lo + n + j]
                t = sh(carry_pass(sh(A, -e1) - dbl(Bv)), j * wr)
                X[:, lo + j], X[:, lo + n + j] = carry_pass(dbl(A) - sh(Bv, e2)), t
        elif op == tfused._OP_BFLY_INV:
            for j in range(k):
                A = X[:, lo + j]
                u = sh(X[:, lo + n + j], -(j * wr))
                X[:, lo + j], X[:, lo + n + j] = carry_pass(A + u), carry_pass(A - u)
        elif op == tfused._OP_OUT1:
            for j in range(k):
                X[:, lo + j] = carry_pass(dbl(X[:, lo + j]) - sh(X[:, lo + n + j], e2))
        else:
            raise AssertionError(op)
    return X


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("B,n1,n2,L,w", [(2 * 4, 4, 16, 2, 3), (2 * 2, 2, 32, 1, 1),
                                         (8, 8, 8, 4, 2), (2, 2, 128, 512, 1),
                                         (2, 1, 256, 1024, 2)])
def test_cols_schedule_matches_plain(rng, kind, B, n1, n2, L, w):
    """The kernel's program equals its plain version (the truncate.py
    recursion with the cross table), raw digits, at every trunc2 (the
    cluster shapes (128, 512) and (256, 1024): at the ends and around the
    middle) and both flavours; B spans more than one copy of the column
    axis where n1 < B."""
    W = 16 * L
    trunc2s = range(1, n2 + 1) if n2 <= 32 else (1, n2 // 2, n2 // 2 + 1, n2 - 1, n2)
    for trunc2 in trunc2s:
        for one in (False, True):
            if not tfused.mfa_col_fits(n2, L, trunc2 == n2):
                continue                    # (256, 1024) full: the ladder route
            x = T(_rand(rng, (B, n2, L)))
            if kind == "fwd" and not one:
                x[:, trunc2:] = 0
            want = tfused.fused_mfa_cols(kind, x, w, W, n1, trunc2, one)
            got = interpret_cols(kind, x, w, W, n1, trunc2, one)
            assert torch.equal(got, want), (trunc2, one)


def test_cols_route_equals_reference():
    """mfa_col_fits is the reference's _run_cols condition (mfa.py:131-133):
    L <= MAX_FUSED_L, and a full column only where whole_row_ok."""
    for n2 in (4, 8, 16, 32, 64, 128, 256, 512):
        for L in range(16, 2049, 16):
            for full in (False, True):
                want = L <= MAX_FUSED_L and (not full or whole_row_ok(n2, L))
                assert tfused.mfa_col_fits(n2, L, full) == want, (n2, L, full)


# (bits_a, bits_b, driver): the plans whose columns the parent ran on the
# ladder: 6.3x10^7 x 5x10^6 (13 / 1 / 512, (128, 512) full and truncated),
# 3.7x10^7 x 3.3x10^7 (flagship 13 / 1 / 512; mfa_trunc and mfa 13 / 2 /
# 1024: (128, 1024) truncated and full), 7.4x10^7 x 6.6x10^7 (flagship
# 13 / 2 / 1024: (256, 1024) truncated; mfa_trunc 14 / 1 / 1024 the same)
ROUTED = [(63_095_734, 5_011_872, "flagship"), (36_869_450, 32_859_931, "flagship"),
          (36_869_450, 32_859_931, "mfa_trunc"), (36_869_450, 32_859_931, "mfa"),
          (73_564_225, 65_564_184, "flagship"), (73_564_225, 65_564_184, "mfa_trunc")]


@pytest.mark.parametrize("bits_a,bits_b,driver", ROUTED)
def test_cols_route_plans(monkeypatch, bits_a, bits_b, driver):
    """Every column pass of these plans' transforms takes the column kernel
    (fused_mfa_cols), none the truncate.py recursion: the calls into the
    wrapper are counted, each checked against mfa_col_fits and given its
    cluster.  The passes are recorded, not computed (a stand-in returns its
    input; the row transforms likewise), since the columns take 256 MB at
    these sizes; the values are the other tests' and the card's."""
    plan = choose_params(bits_a, bits_b, sqrt2=driver == "flagship")
    W, L, n1 = plan.W, plan.W // 16, plan.n1
    calls = []

    def record(kind, x, w, W_, n1_, trunc2, one=False, block=None):
        n2 = x.shape[-2]
        assert block is None and tfused.mfa_col_fits(n2, L, trunc2 == n2)
        calls.append((kind, n2, trunc2 == n2, tfused.mfa_col_cluster(n2, L)))
        return x

    def ladder_route(kind, one):
        raise AssertionError("a column pass took the truncate.py recursion")

    monkeypatch.setattr(tmfa, "fused_mfa_cols", record)
    monkeypatch.setattr(tmfa, "truncated", ladder_route)
    monkeypatch.setattr(tmfa, "fft_radix2", lambda x, *a, **k: x)
    monkeypatch.setattr(tmfa, "ifft_radix2", lambda x, *a, **k: x)
    x = torch.zeros((1, plan.conv_len, L), dtype=torch.int32)
    if driver == "flagship":
        t = plan.trunc_mfa
        assert t < plan.conv_len
        tmfa.mfa_fft_trunc_sqrt2(x, plan.w, W, n1, t)
        tmfa.mfa_ifft_trunc_sqrt2(x, plan.w, W, n1, t, norm_div=plan.lg_conv)
    else:
        xc = x.reshape(1, plan.n2, n1, L)
        t2 = plan.trunc_mfa // n1 if driver == "mfa_trunc" else plan.n2
        assert t2 < plan.n2 or driver == "mfa"
        tmfa.mfa_fft_trunc(xc, plan.w, W, n1, plan.n2, t2)
        tmfa.mfa_ifft_trunc(xc, plan.w, W, n1, plan.n2, t2)
    assert calls and {k for k, *_ in calls} == {"fwd", "inv"}, calls
    assert all(R > 1 for *_, R in calls), calls         # each a cluster launch


def test_cols_wrapper_rejects_unfused():
    """The wrapper takes only what the reference fuses, on the CPU as on
    the card: a full (256, 1024) column (1 MB) and any L 2048 column raise.
    A truncated column past a cluster of 8 CTAs fits the rule but no
    cluster holds it (the card's wrapper raises there)."""
    x = torch.zeros((2, 256, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfused.fused_mfa_cols("fwd", x, 1, 16 * 1024, 2, 256)
    tfused.fused_mfa_cols("fwd", x[:, :, :16].contiguous(), 1, 256, 2, 256)   # (256, 16): fused
    with pytest.raises(ValueError):
        tfused.fused_mfa_cols("inv", torch.zeros((2, 4, 2048), dtype=torch.int32), 1,
                              16 * 2048, 2, 2)
    assert tfused.mfa_col_fits(1024, 1024, False)
    assert tfused.mfa_col_cluster(1024, 1024) is None
    assert [tfused.mfa_col_cluster(n2, L) for n2, L in
            ((128, 256), (128, 512), (128, 1024), (256, 1024), (64, 896))] == [1, 2, 4, 8, 2]


def test_cols_unheld_column_takes_recursion(rng, monkeypatch):
    """A truncated (1024, 1024) column, 4 MB: the reference's rule fuses it,
    no cluster of 8 CTAs holds it, so _run_cols gives it the truncate.py
    recursion (no plan makes one).  mfa_fft_trunc returns, never entering
    the column kernel's wrapper, and its column pass equals the wrapper's
    plain version on the CPU, raw digits."""
    n1, n2, L, w, trunc2 = 2, 1024, 1024, 1, 600
    W = 16 * L
    x = T(_rand(rng, (n2, n1, L)))
    x[trunc2:] = 0
    want = tfused.fused_mfa_cols("fwd", tmfa._swap(x).reshape(n1, n2, L), w, W, n1, trunc2)

    def no_kernel(*a, **k):
        raise AssertionError("an unheld column entered the column kernel's wrapper")

    monkeypatch.setattr(tmfa, "fused_mfa_cols", no_kernel)
    got = tmfa._run_cols(tmfa._swap(x), "fwd", w, W, trunc2)
    assert torch.equal(got, want)
    out = tmfa.mfa_fft_trunc(x, w, W, n1, n2, trunc2)
    assert out.shape == x.shape


# ---------------------------------------------------------------------------
# the transforms against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w,n1,n2", CASES)
def test_mfa_match_reference(rng, n, w, n1, n2):
    """fft_radix2_mfa / ifft_radix2_mfa on a stacked (2, n2, n1, L) input."""
    W = n * w
    L = W // 16
    x = _rand(rng, (2, n2, n1, L))
    f = tmfa.fft_radix2_mfa(T(x), w, W, n1, n2)
    assert np.array_equal(canon(f), canon(jref(jmfa.fft_radix2_mfa, x, w=w, W=W, n1=n1, n2=n2)))
    o = tmfa.ifft_radix2_mfa(T(x), w, W, n1, n2)
    assert np.array_equal(canon(o), canon(jref(jmfa.ifft_radix2_mfa, x, w=w, W=W, n1=n1, n2=n2)))
    back = tmfa.ifft_radix2_mfa(f, w, W, n1, n2)
    lgC = (2 * n).bit_length() - 1
    assert torch.equal(normmod(back), tfused.normmod_rows_plain(T(x), lgC, W))


@pytest.mark.parametrize("n,w,n1,n2", CASES[:3])
def test_mfa_trunc_match_reference(rng, n, w, n1, n2):
    """mfa_fft_trunc / mfa_ifft_trunc in both flavours, trunc2 from 1 to n2."""
    W = n * w
    L = W // 16
    for trunc2 in sorted({1, n2 // 2, n2 // 2 + 1, n2 - 1, n2}):
        for one in (False, True):
            x = _rand(rng, (2, n2, n1, L))
            if not one:
                x[:, trunc2:] = 0
            st = dict(w=w, W=W, n1=n1, n2=n2, trunc2=trunc2, no_zero_tail=one)
            f = tmfa.mfa_fft_trunc(T(x), **st)
            want = jref(jmfa.mfa_fft_trunc, x, **st)
            assert np.array_equal(canon(f)[:, :trunc2], canon(want)[:, :trunc2]), (trunc2, one)
            o = tmfa.mfa_ifft_trunc(T(x), **st)
            want = jref(jmfa.mfa_ifft_trunc, x, **st)
            assert np.array_equal(canon(o)[:, :trunc2], canon(want)[:, :trunc2]), (trunc2, one)


# (n, w, n1, trunc): odd w with trunc > h, odd w with trunc <= h, even w
SQRT2 = [(16, 1, 4, 40), (16, 3, 8, 16), (16, 2, 4, 24), (16, 2, 4, 44)]


@pytest.mark.parametrize("n,w,n1,trunc", SQRT2)
def test_mfa_trunc_sqrt2_match_reference(rng, n, w, n1, trunc):
    """mfa_fft_trunc_sqrt2 / mfa_ifft_trunc_sqrt2, norm_div off and on, and
    their round trip."""
    C4, W = 4 * n, n * w
    L = W // 16
    x = _rand(rng, (2, C4, L))
    x[:, trunc:] = 0
    st = dict(w=w, W=W, n1=n1, trunc=trunc)
    f = tmfa.mfa_fft_trunc_sqrt2(T(x), **st)
    want = jref(jmfa.mfa_fft_trunc_sqrt2, x, **st)
    assert np.array_equal(canon(f)[:, :trunc], canon(want)[:, :trunc])
    v = _rand(rng, (2, C4, L))
    lgC = C4.bit_length() - 1
    for nd in (0, lgC):
        o = tmfa.mfa_ifft_trunc_sqrt2(T(v), **st, norm_div=nd)
        want = jref(jmfa.mfa_ifft_trunc_sqrt2, v, **st, norm_div=nd)
        assert np.array_equal(canon(o)[:, :trunc], canon(want)[:, :trunc]), nd
    back = tmfa.mfa_ifft_trunc_sqrt2(f, **st, norm_div=lgC)
    assert torch.equal(back[:, :trunc], normmod(T(x))[:, :trunc])


def test_cols_pallas_wrap_matches_reference(rng):
    """The reference's column kernel (fused_batched_idx) in interpret mode
    on a stacked input whose flat block spans more than one copy of the
    column axis (n1 = 4 columns, batch 2 x 4): the port's column kernel
    program gives the same values."""
    n, w, n1, n2 = 8, 2, 4, 4
    W = n * w
    L = W // 16
    x = _rand(rng, (2, n2, n1, L))
    with force_pallas(True):
        want = np.asarray(jmfa.fft_radix2_mfa(jnp.asarray(x), w, W, n1, n2))
        wanti = np.asarray(jmfa.ifft_radix2_mfa(jnp.asarray(x), w, W, n1, n2))
    assert np.array_equal(canon(tmfa.fft_radix2_mfa(T(x), w, W, n1, n2)), canon(want))
    assert np.array_equal(canon(tmfa.ifft_radix2_mfa(T(x), w, W, n1, n2)), canon(wanti))


@pytest.mark.parametrize("kind", ["fwd", "inv"])
def test_cols_ladder_route_equals_kernel_route(rng, monkeypatch, kind):
    """Columns too wide for the column kernel take the truncate.py recursion
    with the cross table on the ladder (pe): the same raw digits."""
    n, w, n1, n2 = 16, 4, 8, 4
    W = n * w
    x = T(_rand(rng, (2, n1, n2, W // 16)))
    for trunc2 in (1, 2, 3, 4):
        for one in (False, True):
            xin = x.clone()
            if kind == "fwd" and not one:
                xin[..., trunc2:, :] = 0
            want = tmfa._run_cols(xin, kind, w, W, trunc2, one)
            with monkeypatch.context() as m:
                m.setattr(tmfa, "mfa_col_fits", lambda n2, L, full: False)
                got = tmfa._run_cols(xin, kind, w, W, trunc2, one)
            assert torch.equal(got, want), (trunc2, one)
