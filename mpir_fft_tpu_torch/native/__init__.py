"""Byte I/O between integer files and digit tensors, and the GMP host oracle
(counterpart of mpir_fft_tpu/native/__init__.py).

`digits_from_bytes` / `bytes_from_digits` are torch: the buffer crosses as
16-bit digits and is widened to int32, or checked and narrowed, on the
tensor's device, with one copy each way.  Their byte format is the
reference's: little-endian magnitude, 2 bytes a digit, trailing zero digits
kept.

`gmp_mul` and `gmp_baseline` run GMP's assembly mpn_mul on the host, from
`gmp.c` (the port's copy of the reference's `gmp_mul_bytes` and
`gmp_baseline.c`), built at first use with `cc -O2` against
`libgmp.so.10` into `native/build/` (git-ignored; the file name carries a
hash of the source).  Where `cc` or `libgmp.so.10` is missing they return
None and the caller names the oracle or baseline it used instead."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np
import torch

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS

SOURCE = pathlib.Path(__file__).resolve().parent / "gmp.c"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"


def digits_from_bytes(buf: bytes, L: int, device="cuda") -> torch.Tensor:
    """Little-endian byte buffer -> canonical int32 digits [L] on `device`:
    an odd byte count pads one zero byte; digits past the buffer are 0,
    bytes past 2 L digits are dropped (as marshal.c digits_from_bytes)."""
    host = np.zeros(L, np.int16)
    n = min(len(buf), 2 * L)
    host.view(np.uint8)[:n] = np.frombuffer(buf, np.uint8, count=n)
    # int16 crosses (torch's uint16 has few kernels); the mask restores 16 bits
    return torch.from_numpy(host).to(device).to(torch.int32) & ((1 << DIGIT_BITS) - 1)


def bytes_from_digits(t: torch.Tensor) -> bytes:
    """Canonical digits [L] (0 <= d < 2^16, checked on the tensor's device)
    -> 2 L little-endian bytes.  Raises ValueError("digits not canonical")
    otherwise, as marshal.c bytes_from_digits returns -1."""
    if t.ndim != 1:
        raise ValueError("bytes_from_digits takes a single digit vector")
    if not bool(((t >= 0) & (t < 1 << DIGIT_BITS)).all()):
        raise ValueError("digits not canonical")
    narrow = torch.where(t >= 1 << 15, t - (1 << DIGIT_BITS), t).to(torch.int16)
    return narrow.cpu().numpy().astype("<i2", copy=False).tobytes()


@functools.cache
def _lib() -> ctypes.CDLL | None:
    """gmp.c built and loaded, or None where cc or libgmp.so.10 is missing."""
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libmf_gmp_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build beside, then rename: concurrent first uses each get a whole file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, str(SOURCE),
                            "-l:libgmp.so.10"], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.mf_gmp_mul_bytes.restype = ctypes.c_int
    lib.mf_gmp_mul_bytes.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                     ctypes.c_size_t, ctypes.c_char_p]
    lib.mf_gmp_baseline.restype = ctypes.c_double
    lib.mf_gmp_baseline.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
    return lib


def gmp_mul(a: bytes, b: bytes) -> bytes | None:
    """The exact product of two little-endian magnitude byte buffers by
    GMP's mpn_mul (len(a) + len(b) bytes): the fast host oracle for
    checking products on the card.  None where GMP is not available."""
    lib = _lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(len(a) + len(b))
    if lib.mf_gmp_mul_bytes(a, len(a), b, len(b), out) != 0:
        raise MemoryError("gmp_mul: allocation failed")
    return out.raw


def gmp_baseline(bits: int, reps: int = 3) -> dict | None:
    """GMP mpn_mul of two bits-bit operands on the host, best of reps wall
    times after a warm-up, in the reference harness's JSON keys; None where
    GMP is not available."""
    if bits < 1 or reps < 1:
        raise ValueError("gmp_baseline: bits and reps must be positive")
    lib = _lib()
    if lib is None:
        return None
    limbs = ctypes.c_long()
    s = lib.mf_gmp_baseline(bits, reps, ctypes.byref(limbs))
    if s < 0:
        raise MemoryError("gmp_baseline: allocation failed")
    return {"metric": f"gmp_mpn_mul_{bits}bit_walltime", "value": round(s, 6), "unit": "s",
            "limbs": limbs.value}
