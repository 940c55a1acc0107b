"""Wrappers of the transform and normalisation kernels (counterpart of
mpir_fft_tpu/ops/fused.py), each beside its plain torch version.

| wrapper                    | CUDA kernel             | replaces (TPU kernel)                  |
|----------------------------|-------------------------|----------------------------------------|
| fused_butterfly_ladder     | csrc/ladder.cu          | fused.fused_butterfly_ladder           |
| fused_normmod_div          | csrc/normmod.cu         | fused.fused_rows(normmod_div's core)   |
| fused_canonicalize_plain   | csrc/canonicalize.cu    | fused.fused_canonicalize_plain         |

A wrapper takes its plain version only for a CPU tensor; for a CUDA tensor
it launches its kernel or raises.  The plain versions compute exactly what
the kernels compute (same integer sequence, so equal digits), and are what
the CPU tests hold against the JAX package.

Blocking is Hopper's, not Mosaic's: a ladder CTA keeps K = 2^k ring
elements of one h-position in shared memory (ping-pong, 2*K*L*4 bytes), so
k is capped by that budget and by the deferred-carry growth ~2^(18+k)."""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .butterfly import butterfly_fwd, butterfly_inv
from .limb import (
    DIGIT_BITS,
    _normmod_core,
    carry_pass,
    exact_carries_nonneg,
    shift_mod,
)

# stages per ladder launch: 4 keeps the uncarried digits below ~2^22; the
# shared-memory budget shrinks it for wide rings (L = 2048 -> 3)
LADDER_MAX_STAGES = 4
LADDER_SMEM_BYTES = 128 * 1024


def ladder_stages(L: int) -> int:
    """Stages per ladder launch at digit width L: the largest k <=
    LADDER_MAX_STAGES whose ping-pong block 2 * 2^k * L * 4 bytes fits
    LADDER_SMEM_BYTES (at least 1)."""
    k = LADDER_MAX_STAGES
    while k > 1 and 2 * (1 << k) * L * 4 > LADDER_SMEM_BYTES:
        k -= 1
    return k


def _require(x: torch.Tensor, what: str, ndim: int | None = None) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: int32 digits required, got {x.dtype}")
    if ndim is not None and x.ndim != ndim:
        raise ValueError(f"{what}: {ndim}-D input required, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous input required")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# 1. butterfly ladder
# ---------------------------------------------------------------------------

def ladder_plain(kind: str, xp: torch.Tensor, steps: tuple, W: int) -> torch.Tensor:
    """Plain version of the ladder: k = len(steps) radix-2 stages on
    xp (N, K, h, L).  Stage j pairs K-indices (q, q+m), m = K >> (j+1), with
    twiddle exponent (qm*h + hpos) * steps[j]; 'fwd' runs j = 0..k-1 DIF
    butterflies, 'inv' runs j = k-1..0 inverse butterflies, carry-free, then
    one carry_pass."""
    N, K, h, L = xp.shape
    k = len(steps)
    order = range(k) if kind == "fwd" else range(k - 1, -1, -1)
    hpos = torch.arange(h, device=xp.device, dtype=torch.int64)
    x = xp
    for j in order:
        m = K >> (j + 1)
        xr = x.reshape(N, K // (2 * m), 2, m, h, L)
        a, b = xr[:, :, 0], xr[:, :, 1]
        qm = torch.arange(m, device=xp.device, dtype=torch.int64)[:, None]
        e = torch.remainder((qm * h + hpos) * steps[j], 2 * W)[..., None]
        if kind == "fwd":
            s, t = butterfly_fwd(a, b, e, W)
        else:
            s, t = butterfly_inv(a, b, e, W)
        x = torch.stack([s, t], dim=2).reshape(N, K, h, L)
    return carry_pass(x)


def fused_butterfly_ladder(kind: str, xp: torch.Tensor, steps: tuple, W: int) -> torch.Tensor:
    """k = len(steps) consecutive FFT stages in one pass over xp (N, K, h, L),
    K = 2^k: each batch row holds one length-(K*h) DIF block group, position
    p at K-index p // h, h-index p % h (see ladder_plain for the stages).
    Output: bounded redundant digits (one carry_pass after the stages)."""
    if kind not in ("fwd", "inv"):
        raise ValueError(f"kind must be 'fwd' or 'inv', got {kind!r}")
    _require(xp, "ladder", ndim=4)
    N, K, h, L = xp.shape
    k = len(steps)
    if K != 1 << k or W != DIGIT_BITS * L:
        raise ValueError(f"ladder: K={K} must be 2^len(steps), W={W} must be 16*L")
    if xp.device.type == "cpu":
        return ladder_plain(kind, xp, steps, W)
    if 2 * K * L * 4 > LADDER_SMEM_BYTES:
        raise ValueError(f"ladder: K={K}, L={L} exceeds the shared-memory block")
    out = torch.empty_like(xp)
    st = (ctypes.c_longlong * k)(*[int(s) for s in steps])   # read at launch
    with torch.cuda.device(xp.device):
        rc = kernels.lib().mf_ladder(
            xp.data_ptr(), out.data_ptr(), N, K, h, L, int(kind == "inv"),
            ctypes.cast(st, ctypes.c_void_p), k, kernels.stream_of(xp))
    kernels.check(rc, "ladder")
    kernels.LAUNCHES["ladder"] += 1
    return out


# ---------------------------------------------------------------------------
# 3. normmod rows (the normmod_div tail and normmod)
# ---------------------------------------------------------------------------

def normmod_rows_plain(x: torch.Tensor, s: int, W: int) -> torch.Tensor:
    """Plain version: normmod(x * 2^s mod p) with a static s."""
    return _normmod_core(shift_mod(x, s, W))


def fused_normmod_div(x: torch.Tensor, s: int, W: int) -> torch.Tensor:
    """Canonical digits of x * 2^s mod p for every [..., L] row: the static
    shift, two carry passes, the exact carry scan and the fold of the
    carry-out with the -1 form, in one pass.  normmod_div(x, d) is s = 2W - d;
    normmod is s = 0."""
    _require(x, "normmod")
    L = x.shape[-1]
    if W != DIGIT_BITS * L:
        raise ValueError(f"normmod: W={W} must be 16*L (L={L})")
    s = int(s) % (2 * W)
    if x.device.type == "cpu":
        return normmod_rows_plain(x, s, W)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_normmod(
            x.data_ptr(), out.data_ptr(), x.numel() // L, L, s, kernels.stream_of(x))
    kernels.check(rc, "normmod")
    kernels.LAUNCHES["normmod"] += 1
    return out


# ---------------------------------------------------------------------------
# 4. exact non-modular carry of long nonnegative vectors
# ---------------------------------------------------------------------------

def canonicalize_plain_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: two carry passes (carries move one digit up; the top
    one is dropped, the value must fit), then the exact binary carry scan."""
    for _ in range(2):
        c = x >> DIGIT_BITS
        r = x - (c << DIGIT_BITS)
        x = r + torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
    r = x + exact_carries_nonneg(x)
    return r - ((r >> DIGIT_BITS) << DIGIT_BITS)


def fused_canonicalize_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact non-modular carry canonicalization of nonnegative redundant
    digit vectors (digits < 2^20); every leading index is an independent
    vector whose true value must fit it.  The kernel is a three-pass tiled
    scan (tile carry passes + (g, p) summaries, a scan of the summaries per
    vector, a seeded per-tile apply); carries never cross vectors."""
    _require(x, "canonicalize")
    if x.device.type == "cpu":
        return canonicalize_plain_torch(x)
    N = x.shape[-1]
    Bt = x.numel() // N
    T = kernels.lib().mf_canonicalize_tile()
    R = -(-N // T)
    out = torch.empty_like(x)
    y = torch.empty((Bt, R * T), dtype=torch.int32, device=x.device)
    summ = torch.empty((4, Bt, R), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_canonicalize(
            x.data_ptr(), out.data_ptr(), y.data_ptr(), summ[0].data_ptr(),
            summ[1].data_ptr(), summ[2].data_ptr(), summ[3].data_ptr(),
            Bt, N, R, kernels.stream_of(x))
    kernels.check(rc, "canonicalize")
    kernels.LAUNCHES["canonicalize"] += 1
    return out
