"""Limb/digit substrate (counterpart of mpir_fft_tpu/ops/limb.py).

An element of Z/pZ, p = 2^W + 1 (W = n*w bits), is a vector of L = W/16
signed base-2^16 digits in int32: value(x) = sum_i x[i] * 2^(16*i) mod p.
Digits are redundant: each has ~15 bits of headroom, carries accumulate
everywhere, and overflow out of the top digit wraps to digit 0 negated
(2^W == -1 mod p).  `carry_pass` bounds digit magnitudes; `normmod` is the
exact canonicalization.

Canonical form: digits in [0, 2^16), except the residue -1 == 2^W, stored
as [-1, 0, ..., 0].

Everything here is plain torch on int32 tensors of any device.  `>>` on a
signed torch integer is an arithmetic shift, i.e. floor division by a power
of two, which every carry below relies on.  int32 wraps silently, so each
bound quoted in a docstring is one the callers must keep.

`normmod` / `normmod_div` run through the row kernel wrapper in
ops/fused.py (the CUDA kernel on a GPU tensor, `_normmod_core` otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

DIGIT_BITS = 16
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1


class Ring:
    """Static parameters of the ring Z/(2^(n*w)+1)Z: n a power of two and
    n*w divisible by 16."""

    def __init__(self, n: int, w: int):
        assert n >= 1 and (n & (n - 1)) == 0, "n must be a power of two"
        bits = n * w
        assert bits % DIGIT_BITS == 0, f"n*w={bits} must be divisible by {DIGIT_BITS}"
        self.n = n
        self.w = w
        self.bits = bits          # W
        self.L = bits // DIGIT_BITS
        self.p = (1 << bits) + 1

    def __repr__(self):
        return f"Ring(n={self.n}, w={self.w}, W={self.bits}, L={self.L})"


# ---------------------------------------------------------------------------
# Host <-> digit conversion (numpy; copied from the reference)
# ---------------------------------------------------------------------------

def digits_from_int(x: int, L: int) -> np.ndarray:
    """Host: canonical digit vector of x (must satisfy -1 <= x < 2^(16*L))."""
    if x == -1:
        d = np.zeros(L, np.int32)
        d[0] = -1
        return d
    assert 0 <= x < (1 << (DIGIT_BITS * L)), "value out of canonical range"
    raw = x.to_bytes(2 * L, "little")
    return np.frombuffer(raw, dtype="<u2").astype(np.int32)


def int_from_digits(d: np.ndarray) -> int:
    """Host: exact integer value of a (possibly redundant signed) digit vector."""
    d = np.asarray(d)
    if d.ndim != 1:
        raise ValueError("int_from_digits takes a single vector")
    if np.all((d >= 0) & (d < DIGIT_BASE)):  # fast canonical path
        raw = d.astype("<u2").tobytes()
        return int.from_bytes(raw, "little")
    val = 0
    for i, v in enumerate(d.tolist()):
        val += int(v) << (DIGIT_BITS * i)
    return val


# ---------------------------------------------------------------------------
# Redundant-digit primitives on [..., L] int32
# ---------------------------------------------------------------------------

def _wrap_inject(c: torch.Tensor) -> torch.Tensor:
    """Move per-digit carries one digit up, wrapping the top carry to digit 0
    negated (2^W == -1 mod p)."""
    return torch.cat([-c[..., -1:], c[..., :-1]], dim=-1)


def carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One local carry sweep.  From digit bound M, output bound is
    2^16 + M/2^16 + 1.  Exact in the ring."""
    c = x >> DIGIT_BITS                      # arithmetic shift: floor division
    r = x - (c << DIGIT_BITS)                # in [0, 2^16)
    return r + _wrap_inject(c)


def neg_digits(x: torch.Tensor) -> torch.Tensor:
    """Ring negation (ref: mpn_neg_n + carry fixups); trivial in signed
    redundant form."""
    return -x


def _exact_carries(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact incoming carry per digit (for initial cin=0) and the final
    carry-out (as a [..., 1] slice).  Requires d in [-2^16-1, 2^17) so every
    carry stays in {-1, 0, 1}.

    The carry transition f(cin) = floor((d + cin)/2^16) is carried as three
    planes (f at cin = -1/0/+1) composed by a Hillis-Steele doubling loop."""
    m1 = (d - 1) >> DIGIT_BITS
    z0 = d >> DIGIT_BITS
    p1 = (d + 1) >> DIGIT_BITS
    L = d.shape[-1]

    def ev(v):
        # evaluate the current composed transition at incoming-carry plane v
        return torch.where(v == -1, m1, torch.where(v == 0, z0, p1))

    k = 1
    while k < L:
        # previous window's planes, identity (-1/0/+1) filled for the first k
        pm1 = torch.cat([torch.full_like(d[..., :k], -1), m1[..., :-k]], dim=-1)
        pz0 = torch.cat([torch.zeros_like(d[..., :k]), z0[..., :-k]], dim=-1)
        pp1 = torch.cat([torch.full_like(d[..., :k], 1), p1[..., :-k]], dim=-1)
        m1, z0, p1 = ev(pm1), ev(pz0), ev(pp1)
        k *= 2
    cin = torch.cat([torch.zeros_like(z0[..., :1]), z0[..., :-1]], dim=-1)
    return cin, z0[..., -1:]


def exact_carries_nonneg(d: torch.Tensor) -> torch.Tensor:
    """Exact incoming carry per digit for NONNEGATIVE d with d + cin < 2^17
    (callers bound d <= 2^16 + 2 by two carry passes first).  Carries are
    binary, so the scan runs on generate/propagate planes.  Returns cin in
    {0, 1}; the caller guarantees the final carry dies."""
    g = d >> DIGIT_BITS                                  # {0, 1}
    p = ((d & DIGIT_MASK) == DIGIT_MASK).to(d.dtype)
    L = d.shape[-1]
    k = 1
    while k < L:
        gp = torch.cat([torch.zeros_like(g[..., :k]), g[..., :-k]], dim=-1)
        pp = torch.cat([torch.ones_like(p[..., :k]), p[..., :-k]], dim=-1)
        g = g | (p & gp)
        p = p & pp
        k *= 2
    return torch.cat([torch.zeros_like(g[..., :1]), g[..., :-1]], dim=-1)


def normmod(x: torch.Tensor) -> torch.Tensor:
    """Canonicalize (equivalent of mpn_normmod_2expp1): digits land in
    [0, 2^16), the residue -1 as [-1, 0, ...].  Works for digit magnitudes
    up to ~2^30.  Runs as the normmod row kernel on a GPU tensor; its
    identity-shift case, so it shares normmod_div's kernel."""
    from .fused import fused_normmod_div

    return fused_normmod_div(x, 0, DIGIT_BITS * x.shape[-1])


def normmod_div(x: torch.Tensor, d: int, W_bits: int) -> torch.Tensor:
    """normmod(div_2expmod(x, d, W)) in one pass (the scale + normalize tail
    of every driver)."""
    from .fused import fused_normmod_div

    return fused_normmod_div(x, (2 * W_bits - int(d)) % (2 * W_bits), W_bits)


def _normmod_core(x: torch.Tensor) -> torch.Tensor:
    # Bound digits into scan range: after two passes bound is ~2^16 + 2
    x = carry_pass(carry_pass(x))
    cin, cout = _exact_carries(x)
    r = x + cin
    r = r - ((r >> DIGIT_BITS) << DIGIT_BITS)          # digits now in [0, 2^16)
    # value == r + cout * 2^W == r - cout (mod p): subtract cout at digit 0.
    return _sub_small_at_0(r, cout)


def _prefix_and(b: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-AND of {0,1} int32 along the last axis."""
    L = b.shape[-1]
    k = 1
    while k < L:
        b = b & torch.cat([torch.ones_like(b[..., :k]), b[..., :-k]], dim=-1)
        k *= 2
    return b


def _sub_small_at_0(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """r has canonical digits in [0, 2^16); subtract s in {-1,0,1} (shaped
    [..., 1]) at digit 0, re-canonicalizing by ripple masks."""
    minus_one = torch.zeros_like(r)
    minus_one[..., 0] = -1

    # +1 ripple (s == -1): leading 0xffff digits flip to 0, the first other
    # digit gets +1.  If all digits are 0xffff the result is 2^W == -1.
    prop_p = _prefix_and((r == DIGIT_MASK).to(torch.int32))  # inclusive
    prop_p_excl = torch.cat([torch.ones_like(prop_p[..., :1]), prop_p[..., :-1]], dim=-1)
    bump_p = prop_p_excl - prop_p                     # one-hot at first non-propagate
    res_plus = torch.where(prop_p == 1, 0, r) + bump_p
    res_plus = torch.where(prop_p[..., -1:] == 1, minus_one, res_plus)

    # -1 ripple (s == +1): leading zero digits become 0xffff, the first
    # nonzero digit gets -1.  If all digits are 0 the result is -1.
    prop_m = _prefix_and((r == 0).to(torch.int32))
    prop_m_excl = torch.cat([torch.ones_like(prop_m[..., :1]), prop_m[..., :-1]], dim=-1)
    bump_m = prop_m_excl - prop_m
    res_minus = torch.where(prop_m == 1, DIGIT_MASK, r) - bump_m
    res_minus = torch.where(prop_m[..., -1:] == 1, minus_one, res_minus)

    return torch.where(s == 0, r, torch.where(s == -1, res_plus, res_minus))


# ---------------------------------------------------------------------------
# Shifts: multiplication by powers of two mod p (all twiddles reduce to this)
# ---------------------------------------------------------------------------

def shift_digits_static(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * 2^(16*k) mod p for a static digit count k: negacyclic rotation,
    wrapped digits re-enter negated."""
    L = x.shape[-1]
    k %= 2 * L
    sign = 1
    if k >= L:
        k -= L
        sign = -1
    if k == 0:
        return x if sign == 1 else -x
    rolled = torch.cat([-x[..., L - k:], x[..., :L - k]], dim=-1)
    return rolled if sign == 1 else -rolled


def shift_bits_var(x: torch.Tensor, b) -> torch.Tensor:
    """x * 2^b mod p for b in [0, 16) (an int, or an int32 tensor
    broadcastable to x[..., :1]).

    Overflow-safe split: x*2^b = hi*2^16 + lo*2^b with hi = x >> (16-b)
    (arithmetic), lo = x - hi*2^(16-b); the hi part moves one digit up with
    negacyclic wrap.  From digit bound M the output bound is 2^16 + M/2 + 1."""
    sh = DIGIT_BITS - b
    hi = x >> sh
    lo = x - (hi << sh)
    return (lo << b) + _wrap_inject(hi)


def _rotate_digits_var(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Negacyclic digit rotation by per-row k in [0, L) (k broadcastable to
    x[..., :1]): out[i] = x[i - k] for i >= k, -x[L - k + i] below.  A gather
    -- the direct indexing the TPU's barrel shifter stood in for."""
    L = x.shape[-1]
    i = torch.arange(L, device=x.device, dtype=k.dtype)
    src = torch.remainder(i - k, L)
    shape = torch.broadcast_shapes(x.shape, src.shape)
    out = torch.gather(x.expand(shape), -1, src.expand(shape).long())
    return torch.where(i < k, -out, out)


def shift_mod(x: torch.Tensor, s, W_bits: int) -> torch.Tensor:
    """x * 2^s mod p = 2^W + 1, for s a python int (static) or an integer
    tensor broadcastable to x[..., :1] (per-row twiddles).

    The exponent decomposes as s = (negate? W:0) + 16*k + b: a negacyclic
    digit rotation by k, then a sub-digit shift by b.  The tensor path always
    applies the sub-digit shift (at b = 0 it is a carry pass), which is the
    exact sequence the ladder kernel (csrc/ladder.cu) runs."""
    L = x.shape[-1]
    assert W_bits == L * DIGIT_BITS

    if isinstance(s, (int, np.integer)):
        s = int(s) % (2 * W_bits)
        sign = 1
        if s >= W_bits:
            s -= W_bits
            sign = -1
        k, b = divmod(s, DIGIT_BITS)
        out = shift_digits_static(x, k)
        if b:
            out = shift_bits_var(out, b)
        return out if sign == 1 else -out

    s = torch.remainder(s, 2 * W_bits).to(torch.int32)
    neg = s >= W_bits
    s = torch.where(neg, s - W_bits, s)
    out = shift_bits_var(_rotate_digits_var(x, s >> 4), s & 15)
    return torch.where(neg, -out, out)


def mul_2expmod(x: torch.Tensor, d, W_bits: int) -> torch.Tensor:
    """t = x * 2^d mod p (ref: mpn_mul_2expmod_2expp1)."""
    return shift_mod(x, d, W_bits)


def div_2expmod(x: torch.Tensor, d, W_bits: int) -> torch.Tensor:
    """t = x / 2^d mod p = x * 2^(2W-d), since 2^(2W) == 1 (mod p)."""
    if isinstance(d, (int, np.integer)):
        return shift_mod(x, (2 * W_bits - int(d)) % (2 * W_bits), W_bits)
    return shift_mod(x, torch.remainder(-d, 2 * W_bits), W_bits)
