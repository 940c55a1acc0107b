"""The plain reference: exact big-integer products and squares mod 2^N+1 in
plain PyTorch, written apart from the program under test.

It imports torch alone: nothing of the program, of its JAX counterpart or
of JAX.  Numbers travel as canonical base-2^16 digits (int32 or int64
tensors, least significant first), the form in which the benchmark makes
the inputs and the program returns its results; the -1 residue of a
Fermat ring, 2^N, is the vector [-1, 0, ..., 0], as the program writes it.

Method: the digits are split into bytes, the acyclic convolution of the
byte vectors is taken by a real FFT in float64 (`torch.fft`), rounded to
integers, and the carries are resolved exactly in int64, on base-2^16
digits again.  With 8-bit
digits a coefficient stays below 2^(16 + log2 n), so at the sizes the
benchmark runs (n <= 2^28) float64's rounding error is far below 1/2;
every call measures it (`roundoff`), and the judge refuses a reference
whose roundoff reaches ROUNDOFF_LIMIT.  `dtype=torch.float32` runs the same
method a precision lower: the benchmark's control, which must come out
wrong at the cells' sizes.

The carry resolution is exact and parallel: a few passes of local carries
bring every digit below 2^17 - 1, then one carry-lookahead pass (a running
count of the digits that stop a carry, by a device-wide cumsum) settles
the carries of 0 and 1 that are left, however far they ripple."""

from __future__ import annotations

import torch

# the reference's own guard: past this distance from an integer a rounded
# FFT coefficient is no longer certain (the sizes run read ~1e-3)
ROUNDOFF_LIMIT = 0.25
MASK = (1 << 16) - 1


def to_bytes(d16: torch.Tensor) -> torch.Tensor:
    """Canonical base-2^16 digits [n] -> base-2^8 digits [2n] (int64)."""
    d = d16.to(torch.int64)
    return torch.stack([d & 255, d >> 8], dim=-1).reshape(-1)


def resolve(v: torch.Tensor, cin: int = 0) -> tuple[torch.Tensor, int]:
    """Digits v in [0, 2^17 - 2] (int64) plus a carry cin in {0, 1} into
    digit 0 -> (canonical base-2^16 digits, the carry out of the top digit).

    Every carry left is 0 or 1: digit k receives 1 exactly where the
    nearest digit below it that is not 2^16 - 1 is at least 2^16 (or, where
    all digits below are 2^16 - 1, where cin is 1).  That nearest digit is
    found with a running count of the digits that stop a carry (a
    device-wide cumsum) and the list of their positions."""
    stops = v != MASK
    pos = torch.nonzero(stops).squeeze(1)
    count = torch.cumsum(stops, dim=0)                 # stops at or below each digit
    gen = torch.cat([torch.tensor([bool(cin)], device=v.device), (v > MASK)[pos]])
    # carry into digit k: gen of the nearest stop below k (entry 0: cin)
    carry = torch.cat([gen[:1], gen[count[:-1]]])
    cout = bool(gen[count[-1]])
    return (v + carry) & MASK, int(cout)


def normalize(r: torch.Tensor, n_out: int) -> tuple[torch.Tensor, int]:
    """Nonnegative int64 coefficients r of weights 2^(8k) -> (the canonical
    base-2^16 digits of their sum, n_out of them; what overflowed the top).
    Pairs of coefficients first become one of weight 2^(16k) (r < 2^44, so
    the pair stays below 2^53), then local carries run until every digit is
    below 2^17 - 1, and resolve() settles the rest."""
    if r.numel() % 2:
        r = torch.cat([r, r.new_zeros(1)])
    pairs = r[0::2] + (r[1::2] << 8)
    v = torch.zeros(n_out, dtype=torch.int64, device=r.device)
    v[: pairs.numel()] = pairs[:n_out]
    overflow = int(pairs[n_out:].abs().sum()) if pairs.numel() > n_out else 0
    del pairs
    while int(v.max()) > 2 * MASK:
        hi = v >> 16
        overflow += int(hi[-1])
        v &= MASK
        v[1:] += hi[:-1]
        del hi
    v, cout = resolve(v)
    return v, overflow + cout


def convolve(a8: torch.Tensor, b8: torch.Tensor | None, dtype=torch.float64
             ) -> tuple[torch.Tensor, float]:
    """The acyclic convolution of two byte vectors (b8 None: of a8 with
    itself) by a real FFT in `dtype`, rounded -> (int64 coefficients,
    the largest distance of an FFT coefficient from its integer)."""
    n = a8.numel() + (a8 if b8 is None else b8).numel() - 1
    size = 1 << (n - 1).bit_length()
    fa = torch.fft.rfft(a8.to(dtype), n=size)
    if b8 is None:
        fa.mul_(fa)
    else:
        fa.mul_(torch.fft.rfft(b8.to(dtype), n=size))
    c = torch.fft.irfft(fa, n=size)[:n]
    del fa
    r = torch.round(c)
    roundoff = float(c.sub_(r).abs_().max()) if n else 0.0
    del c
    return r.clamp_(min=0).to(torch.int64), roundoff


def mul_digits(a16: torch.Tensor, b16: torch.Tensor, dtype=torch.float64
               ) -> tuple[torch.Tensor, float]:
    """The product of two canonical digit vectors -> (its canonical base-2^16
    digits, len(a16) + len(b16) of them, int64; the FFT's roundoff)."""
    r, roundoff = convolve(to_bytes(a16), to_bytes(b16), dtype)
    prod, overflow = normalize(r, a16.numel() + b16.numel())
    if overflow and dtype == torch.float64:
        raise ArithmeticError("reference product overflowed its digits")
    return prod, roundoff


def _is_minus1(x16: torch.Tensor) -> bool:
    return int(x16[0]) == -1 and not bool(x16[1:].any())


def sqrmod_fermat(x16: torch.Tensor, dtype=torch.float64) -> tuple[torch.Tensor, float]:
    """x^2 mod 2^N+1 for a canonical residue x of N = 16 len(x16) bits
    -> (its canonical digits, 2^N as [-1, 0, ...]; the FFT's roundoff).

    The square's 2N bits are lo + 2^N hi == lo - hi (mod 2^N+1), taken as
    lo + ~hi + 1 over N bits: the carry out says whether lo >= hi; where
    it is not, 2^N + 1 is added back, which is the sum plus 1."""
    n16 = x16.numel()
    if _is_minus1(x16):                       # (-1)^2 = 1
        out = torch.zeros(n16, dtype=torch.int64, device=x16.device)
        out[0] = 1
        return out, 0.0
    r, roundoff = convolve(to_bytes(x16), None, dtype)
    sq, overflow = normalize(r, 2 * n16)
    del r
    if overflow and dtype == torch.float64:
        raise ArithmeticError("reference square overflowed its digits")
    lo, hi = sq[:n16], sq[n16:]
    diff, no_borrow = resolve(lo + (MASK - hi), 1)
    if not no_borrow:
        diff, wrapped = resolve(diff, 1)
        if wrapped:                           # the sum was 2^N: the -1 form
            out = torch.zeros(n16, dtype=torch.int64, device=x16.device)
            out[0] = -1
            return out, roundoff
    return diff, roundoff
