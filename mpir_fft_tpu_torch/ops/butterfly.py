"""Radix-2 butterflies over Z/(2^W+1)Z (counterpart of
mpir_fft_tpu/ops/butterfly.py).  A twiddle by z^i is never a multiplication:
it is limb.shift_mod's negacyclic rotation plus sub-digit shift.

The butterflies here are carry-free (the reference's carry=False form): the
only caller, the ladder, runs k <= 4 consecutive stages and carries once at
the end.  Digit magnitude roughly doubles per stage, ~2^(18+k) from the
~2^17 inter-launch invariant, far inside int32."""

from __future__ import annotations

from .limb import div_2expmod, shift_mod


def butterfly_fwd(a, b, e_t, W: int):
    """DIF butterfly (ref FFT_radix2_butterfly, mul_fft.c:553-576):
        s = a + b,   t = (a - b) * 2^e_t  (mod p)
    e_t: python int or integer tensor broadcastable to [..., 1]."""
    return a + b, shift_mod(a - b, e_t, W)


def butterfly_inv(s, t, e, W: int):
    """Inverse DIF butterfly (ref FFT_radix2_inverse_butterfly,
    mul_fft.c:639-652):  a = s + t / 2^e,  b = s - t / 2^e  (mod p)."""
    h = div_2expmod(t, e, W)
    return s + h, s - h
