"""Radix-2 butterflies over Z/(2^W+1)Z (counterpart of
mpir_fft_tpu/ops/butterfly.py).  A twiddle by z^i is never a multiplication:
it is limb.shift_mod's negacyclic rotation plus sub-digit shift.

The butterflies here are carry-free (the reference's carry=False form): the
ladder runs k <= 4 consecutive stages and carries once at the end, and the
truncated transforms' glue (ops/truncate.py) carries each output itself.
Digit magnitude roughly doubles per stage, ~2^(18+k) from the ~2^17
inter-launch invariant, far inside int32."""

from __future__ import annotations

from .limb import div_2expmod, shift_mod


def butterfly_fwd(a, b, e_t, W: int, e_s=None):
    """DIF butterfly (ref FFT_radix2_butterfly, mul_fft.c:553-576):
        s = a + b            (times 2^e_s with e_s: the fused-twiddle form,
                              ref FFT_radix2_twiddle_butterfly mul_fft.c:517-548)
        t = (a - b) * 2^e_t  (mod p)
    e_t, e_s: python ints or integer tensors broadcastable to [..., 1]."""
    s = a + b
    if e_s is not None:
        s = shift_mod(s, e_s, W)
    return s, shift_mod(a - b, e_t, W)


def butterfly_inv(s, t, e, W: int, e_s=None, e_t=None):
    """Inverse DIF butterfly (ref FFT_radix2_inverse_butterfly,
    mul_fft.c:639-652):  a = s + t / 2^e,  b = s - t / 2^e  (mod p).
    With e_s / e_t both inputs are first divided by their extra twiddles
    (ref FFT_radix2_twiddle_inverse_butterfly, mul_fft.c:721-752)."""
    if e_s is not None:
        s = div_2expmod(s, e_s, W)
    if e_t is not None:
        e = e + e_t
    h = div_2expmod(t, e, W)
    return s + h, s - h
