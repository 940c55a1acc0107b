"""Wrappers of the transform and normalisation kernels (counterpart of
mpir_fft_tpu/ops/fused.py), each beside its plain torch version.

| wrapper                    | CUDA kernel             | replaces (TPU kernel)                  |
|----------------------------|-------------------------|----------------------------------------|
| fused_butterfly_ladder     | csrc/ladder.cu          | fused.fused_butterfly_ladder           |
| fused_transform            | csrc/transform_small.cu | fused.fused_batched (whole transforms; |
|                            |                         | with fused_twiddle_half as an option)  |
| fused_normmod_div          | csrc/normmod.cu         | fused.fused_rows(normmod_div's core)   |
| fused_canonicalize_plain   | csrc/canonicalize.cu    | fused.fused_canonicalize_plain         |
| fused_twiddle_half         | csrc/twiddle_half.cu    | fused.fused_twiddle_half               |
| fused_sqrt2_top_fwd        | csrc/sqrt2_top.cu       | fused.fused_sqrt2_top_fwd              |
| fused_sqrt2_top_inv        | csrc/sqrt2_top.cu       | fused.fused_sqrt2_top_inv              |
| fused_mfa_cols             | csrc/mfa_cols.cu        | fused.fused_batched_idx (MFA columns)  |
| fused                      | csrc/mfa_cols.cu        | fused.fused (one whole block)          |

The NTT's link kernels (csrc/ntt_links.cu) are wrapped in ops/ntt.py, beside
the integer helpers their plain versions are built from.

A wrapper takes its plain version only for a CPU tensor; for a CUDA tensor
it launches its kernel or raises.  The plain versions compute what the
kernels compute, and are what the CPU tests hold against the JAX package:
the same integer sequence, so equal digits, except the sqrt2 top layer's
redundant outputs (a different sequence of the same values: equal after
normmod; its canonical norm tail is identical).

Blocking is Hopper's, not Mosaic's: a ladder CTA keeps K = 2^k ring
elements of one h-position in one shared-memory buffer (K*L*4 bytes, the
stages in place), so k is capped by that budget (LADDER_BUF_BYTES) and by
the deferred-carry growth ~2^(18+k); the whole-row transform keeps a whole
(C, L) row in one such buffer (to WHOLE_BUF_BYTES, several CTAs an SM) or,
for the wider rows the reference fuses (to 512 KB), in one CTA of up to
227 KB or a thread-block cluster of 2, 4 or 8 CTAs (whole_cluster), and
runs the same stage routine on it."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .butterfly import butterfly_fwd, butterfly_inv
from .limb import (
    DIGIT_BITS,
    _normmod_core,
    carry_pass,
    exact_carries_nonneg,
    shift_digits_static,
    shift_mod,
)

# stages per ladder launch: 4 keeps the uncarried digits below ~2^22; the
# shared-memory budget of the group's one K*L buffer shrinks it for wide
# rings (L 2048 -> 3, L 4096 -> 2): a 64 KB buffer lets three CTAs share an
# SM, so one CTA's loads and stores overlap the others' stages
LADDER_MAX_STAGES = 4
LADDER_BUF_BYTES = 64 * 1024

# the normmod routes' limits (csrc/normmod.cu kShortMaxL, kRowMaxL, kMaxL:
# the long route's digit indices are C ints)
NORMMOD_SHORT_MAX = 512
NORMMOD_ROW_MAX = 8192
NORMMOD_LONG_MAX = 1 << 30
# the canonicalize routes: rows up to CANON_ROW_MAX digits one CTA each,
# longer ones tiles of CANON_TILE (csrc/canonicalize.cu kRowMax, kTile)
CANON_ROW_MAX = 8192
CANON_TILE = 2048


def ladder_stages(L: int) -> int:
    """Stages per ladder launch at digit width L: the largest k <=
    LADDER_MAX_STAGES whose buffer 2^k * L * 4 bytes fits LADDER_BUF_BYTES
    (at least 1)."""
    k = LADDER_MAX_STAGES
    while k > 1 and not ladder_fits(1 << k, L):
        k -= 1
    return k


def ladder_smem_bytes(K: int, L: int) -> int:
    """Shared memory of one ladder-group CTA (the ladder and the Garner
    kernels' post leg; the layout of csrc/ladder_group.cuh): the K*L-digit
    buffer, two twiddle tables of k*K/2 ints and K pre_half exponents."""
    k = K.bit_length() - 1
    return 4 * (K * L + k * K + K)


def ladder_fits(K: int, L: int) -> bool:
    """Do the ladder kernels take a group of K rows of L digits: its
    buffer within LADDER_BUF_BYTES, the rule both wrappers check (the
    kernels check none of their own).  The tables add at most a few KB, so
    the block stays far inside Hopper's 227 KB."""
    return K * L * 4 <= LADDER_BUF_BYTES


def ladder_groups(C: int, L: int, kind: str, skip_inner: int = 0) -> list[tuple[int, int]]:
    """(first stage l, stage count kg) of each ladder launch of a length-C
    transform at digit width L, in execution order.  skip_inner (inverse
    only): the innermost skip_inner stages already ran, so the groups cover
    stages 0 .. D - skip_inner - 1."""
    D = C.bit_length() - 1
    kmax = ladder_stages(L)
    groups = []
    if kind == "fwd":
        assert skip_inner == 0
        l = 0
        while l < D:
            kg = min(kmax, D - l)
            groups.append((l, kg))
            l += kg
    else:
        l_hi = D - skip_inner
        while l_hi > 0:
            kg = min(kmax, l_hi)
            groups.append((l_hi - kg, kg))
            l_hi -= kg
    return groups


def _require(x: torch.Tensor, what: str, ndim: int | None = None,
             dtype: torch.dtype = torch.int32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what}: {dtype} input required, got {x.dtype}")
    if ndim is not None and x.ndim != ndim:
        raise ValueError(f"{what}: {ndim}-D input required, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous input required")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# 1. butterfly ladder
# ---------------------------------------------------------------------------

def ladder_plain(kind: str, xp: torch.Tensor, steps: tuple, W: int,
                 pe: torch.Tensor | None = None, pre_half: tuple | None = None) -> torch.Tensor:
    """Plain version of the ladder: k = len(steps) radix-2 stages on
    xp (N, K, h, L).  Stage j pairs K-indices (q, q+m), m = K >> (j+1), with
    twiddle exponent (qm*h + hpos) * steps[j]; 'fwd' runs j = 0..k-1 DIF
    butterflies, 'inv' runs j = k-1..0 inverse butterflies, carry-free, then
    one carry_pass.  pe (N, K/2, 2), for h == 1 only: the innermost stage
    (m == 1) also multiplies s by 2^pe0 and t by 2^pe1 ('fwd'), or divides
    them out before the butterfly ('inv') -- the reference's last-stage
    table (fused.py:268-273, :430-432).  pre_half = (e0, step2), 'fwd'
    only: first, row (q, hpos) -- transform position j = q*h + hpos -- is
    multiplied by 2^((e0 + j*step2)/2), half-bit exponents (the reference's
    fused.py:275, :416-417; the row body of twiddle_half_rows_plain)."""
    N, K, h, L = xp.shape
    k = len(steps)
    order = range(k) if kind == "fwd" else range(k - 1, -1, -1)
    hpos = torch.arange(h, device=xp.device, dtype=torch.int64)
    x = xp
    if pre_half is not None:
        e0, st2 = pre_half
        j = torch.arange(K, device=xp.device, dtype=torch.int64)[:, None] * h + hpos
        e2 = torch.remainder(e0 + j * st2, 4 * W)[None, :, :, None].expand(N, K, h, 1)
        x = twiddle_half_rows_plain(x.reshape(-1, L), e2.reshape(-1, 1), W).reshape(xp.shape)
    for j in order:
        m = K >> (j + 1)
        xr = x.reshape(N, K // (2 * m), 2, m, h, L)
        a, b = xr[:, :, 0], xr[:, :, 1]
        qm = torch.arange(m, device=xp.device, dtype=torch.int64)[:, None]
        e = torch.remainder((qm * h + hpos) * steps[j], 2 * W)[..., None]
        pes = pet = None
        if pe is not None and m == 1:
            pes = pe[..., 0].reshape(N, K // 2, 1, 1, 1)
            pet = pe[..., 1].reshape(N, K // 2, 1, 1, 1)
        if kind == "fwd":
            s, t = butterfly_fwd(a, b, e if pet is None else e + pet, W, e_s=pes)
        else:
            s, t = butterfly_inv(a, b, e, W, e_s=pes, e_t=pet)
        x = torch.stack([s, t], dim=2).reshape(N, K, h, L)
    return carry_pass(x)


def fused_butterfly_ladder(kind: str, xp: torch.Tensor, steps: tuple, W: int,
                           pe: torch.Tensor | None = None,
                           pre_half: tuple | None = None) -> torch.Tensor:
    """k = len(steps) consecutive FFT stages in one pass over xp (N, K, h, L),
    K = 2^k: each batch row holds one length-(K*h) DIF block group, position
    p at K-index p // h, h-index p % h (see ladder_plain for the stages, the
    optional last-stage table pe, int32 (N, K/2, 2) in [0, 2W), h == 1, and
    the half-bit twiddle pre_half = (e0, step2) of a transform's first
    group, 'fwd' only: each batch row is then a whole transform).
    Output: bounded redundant digits (one carry_pass after the stages).
    Launches count under "ladder", "ladder_pe" with a table, or
    "ladder_pre_half" with the twiddle."""
    if kind not in ("fwd", "inv"):
        raise ValueError(f"kind must be 'fwd' or 'inv', got {kind!r}")
    if pre_half is not None and kind != "fwd":
        raise ValueError("ladder: pre_half is a forward option")
    _require(xp, "ladder", ndim=4)
    N, K, h, L = xp.shape
    k = len(steps)
    if K != 1 << k or W != DIGIT_BITS * L:
        raise ValueError(f"ladder: K={K} must be 2^len(steps), W={W} must be 16*L")
    if pe is not None:
        _require(pe, "ladder pe", ndim=3)
        if h != 1 or tuple(pe.shape) != (N, K // 2, 2) or pe.device != xp.device:
            raise ValueError(f"ladder: pe {tuple(pe.shape)} must be ({N}, {K // 2}, 2) on "
                             f"{xp.device}, for h == 1 (h={h})")
    if xp.device.type == "cpu":
        return ladder_plain(kind, xp, steps, W, pe, pre_half)
    if not ladder_fits(K, L):
        raise ValueError(f"ladder: K={K} rows of L={L} exceed the ladder's buffer")
    e0, st2 = (0, 0) if pre_half is None else (int(v) % (4 * W) for v in pre_half)
    out = torch.empty_like(xp)
    st = _steps_arg(steps)
    with torch.cuda.device(xp.device):
        rc = kernels.lib().mf_ladder(
            xp.data_ptr(), out.data_ptr(), N, K, h, L, int(kind == "inv"),
            ctypes.cast(st, ctypes.c_void_p), k, None if pe is None else pe.data_ptr(),
            int(pre_half is not None), e0, st2, kernels.stream_of(xp))
    kernels.check(rc, "ladder")
    kernels.LAUNCHES["ladder_pre_half" if pre_half is not None
                     else "ladder" if pe is None else "ladder_pe"] += 1
    return out


def _steps_arg(steps) -> ctypes.Array:
    """Stage exponents as the host long long[k] a ladder-group kernel reads
    at launch."""
    return (ctypes.c_longlong * len(steps))(*[int(s) for s in steps])


# ---------------------------------------------------------------------------
# 2. whole transforms of batch rows
# ---------------------------------------------------------------------------

# the rows the whole-row transform takes: every row the reference fuses
# (mpir_fft_tpu/ops/fused.py MAX_FUSED_L :42, _padded_row_bytes /
# whole_row_ok :83-94, MAX_FUSED_ROW_BYTES :89, as ops/transforms.py
# _auto_fusable :50-62 applies them; the same numbers as the MFA columns'
# rule below), and every row of at most WHOLE_BUF_BYTES -- one in-place
# buffer of a CTA of the small layout, four of which share an SM at (256, 48)
WHOLE_MAX_FUSED_L = 1024
WHOLE_MAX_ROW_BYTES = 512 * 1024
WHOLE_BUF_BYTES = 64 * 1024
# a wide row's CTA: Hopper's opt-in dynamic shared memory a block, and the
# cluster sizes that hold a wide row (8 is the portable maximum)
WHOLE_CTA_SMEM = 227 * 1024
WHOLE_CLUSTERS = (1, 2, 4, 8)


def _padded_row_bytes(C: int, L: int) -> int:
    """The reference's padded block of a (C, L) int32 row: C up to a
    multiple of 8 rows, L to one of 128 lanes."""
    return -(-C // 8) * 8 * (-(-L // 128) * 128) * 4


def whole_fits(C: int, L: int) -> bool:
    """Does the whole-row transform take a (C, L) row: the reference's rule
    (L <= 1024 and a padded row within 512 KB) or a row of at most
    WHOLE_BUF_BYTES (the small layout: the recursive mulmod's inner rings
    at any L)."""
    return C * L * 4 <= WHOLE_BUF_BYTES or (
        L <= WHOLE_MAX_FUSED_L and _padded_row_bytes(C, L) <= WHOLE_MAX_ROW_BYTES)


def whole_smem_bytes(C: int, R: int, L: int) -> int:
    """Dynamic shared memory of one wide-row CTA holding C / R rows of a
    (C, L) row (csrc/transform_small.cu wide_smem_bytes): the rows, the C/2
    exponents u*w mod 2W, two ladder tables of log2(C/R) stages of C/(2R)
    pairs, the rows' half-bit exponents."""
    rpc = C // R
    tab = max(rpc.bit_length() - 1, 1) * (rpc // 2 if rpc > 2 else 1)
    return 4 * (rpc * L + C // 2 + 2 * tab + rpc)


def whole_cluster(B: int, C: int, L: int, sms: int) -> int:
    """The CTAs that hold one (C, L) row that whole_fits admits, in a batch
    of B rows on a card of sms SMs: 1 for a row of at most WHOLE_BUF_BYTES
    (the small layout); else the fewest of WHOLE_CLUSTERS whose CTA
    (whole_smem_bytes) fits WHOLE_CTA_SMEM, doubled while the batch's B * R
    CTAs would fill at most half the card, up to 8 (a wide row is one CTA an
    SM, so a small batch otherwise leaves most SMs idle).  A wide row has
    C >= 32, so each R divides it into at least 4 rows a CTA."""
    if C * L * 4 <= WHOLE_BUF_BYTES:
        return 1
    ok = [R for R in WHOLE_CLUSTERS if whole_smem_bytes(C, R, L) <= WHOLE_CTA_SMEM]
    R = ok[0]
    while 2 * R in ok and 2 * B * R <= sms:
        R *= 2
    return R


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transform_plain(kind: str, x: torch.Tensor, w: int, W: int, pre_half: tuple | None = None,
                    post_half: tuple | None = None) -> torch.Tensor:
    """Plain version of the whole-transform kernel: the ladder groups of a
    length-C transform (ladder_groups), each one ladder_plain pass over x
    (B, C, L) -- the sequence the kernel runs on a shared-memory row.
    pre_half = (e0, step2), 'fwd': first twiddle_half_plain of the rows;
    post_half, 'inv': twiddle_half_plain of the result."""
    B, C, L = x.shape
    if pre_half is not None:
        x = twiddle_half_plain(x, *pre_half, W)
    for l, kg in ladder_groups(C, L, kind):
        K = 1 << kg
        steps = tuple(w << (l + j) for j in range(kg))
        x = ladder_plain(kind, x.reshape(-1, K, C >> (l + kg), L), steps, W).reshape(B, C, L)
    if post_half is not None:
        x = twiddle_half_plain(x, *post_half, W)
    return x


def fused_transform(kind: str, x: torch.Tensor, w: int, W: int, pre_half: tuple | None = None,
                    post_half: tuple | None = None) -> torch.Tensor:
    """The whole radix-2 transform (fft_radix2 for 'fwd', ifft_radix2 for
    'inv', root 2^w) of every (C, L) row of x (B, C, L) in one launch, the
    row resident in the shared memory of one CTA or of a thread-block
    cluster of R = whole_cluster(B, C, L, the card's SMs) CTAs; the rows
    whole_fits admits, else ValueError.  pre_half = (e0, step2), 'fwd' only:
    row j is first multiplied by 2^((e0 + j*step2)/2) (half-bit exponents);
    post_half, 'inv' only: the output row j is multiplied so -- the
    negacyclic weights (ops/negacyclic.py) in the same launch.  Output:
    bounded redundant digits (a carry pass after every ladder group, as on
    the ladder path).  Launches count under "transform_small", or
    "transform_small_half" with an option."""
    if kind not in ("fwd", "inv"):
        raise ValueError(f"kind must be 'fwd' or 'inv', got {kind!r}")
    if (pre_half is not None and kind != "fwd") or (post_half is not None and kind != "inv"):
        raise ValueError("transform_small: pre_half is a forward option, post_half an inverse one")
    _require(x, "transform_small", ndim=3)
    B, C, L = x.shape
    if C < 2 or C & (C - 1) or W != DIGIT_BITS * L:
        raise ValueError(f"transform_small: C={C} must be a power of two >= 2, W={W} 16*L")
    if x.device.type == "cpu":
        return transform_plain(kind, x, w, W, pre_half, post_half)
    if not whole_fits(C, L):
        raise ValueError(f"transform_small: the whole-row transform does not take a ({C}, {L}) "
                         "row (whole_fits)")
    R = whole_cluster(B, C, L, _sm_count(x.device.index))
    return _launch_transform(kind, x, w, W, pre_half if kind == "fwd" else post_half, R)


def _launch_transform(kind: str, x: torch.Tensor, w: int, W: int, half: tuple | None,
                      R: int) -> torch.Tensor:
    """One launch of csrc/transform_small.cu on the checked (B, C, L) CUDA
    tensor x, R CTAs a row (whole_cluster's choice; utils/transform_bench
    passes others to measure it)."""
    B, C, L = x.shape
    e0, st2 = (0, 0) if half is None else (int(v) for v in half)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_transform_small(
            x.data_ptr(), out.data_ptr(), B, C, L, int(w), int(kind == "inv"),
            ladder_stages(L), int(half is not None), e0, st2, R, kernels.stream_of(x))
    kernels.check(rc, "transform_small")
    kernels.LAUNCHES["transform_small" if half is None else "transform_small_half"] += 1
    return out


# ---------------------------------------------------------------------------
# 3. normmod rows (the normmod_div tail and normmod)
# ---------------------------------------------------------------------------

def normmod_rows_plain(x: torch.Tensor, s: int, W: int) -> torch.Tensor:
    """Plain version: normmod(x * 2^s mod p) with a static s."""
    return _normmod_core(shift_mod(x, s, W))


def normmod_route(L: int) -> str:
    """The normmod kernel a row of L digits takes: "short" (several rows a
    warp, L <= NORMMOD_SHORT_MAX), "block" (one CTA a row, L <=
    NORMMOD_ROW_MAX) or "long" (a chained scan over 2048-digit tiles, one
    CTA each: the mulmod_int rings).  The limits are csrc/normmod.cu's
    mf_normmod_short_max and mf_normmod_row_max."""
    return "short" if L <= NORMMOD_SHORT_MAX else "block" if L <= NORMMOD_ROW_MAX else "long"


def fused_normmod_div(x: torch.Tensor, s: int, W: int) -> torch.Tensor:
    """Canonical digits of x * 2^s mod p for every [..., L] row: the static
    shift, two carry passes, the exact carry scan and the fold of the
    carry-out with the -1 form, in one pass.  normmod_div(x, d) is s = 2W - d;
    normmod is s = 0.  The route is normmod_route(L): short rows several to
    a warp, block rows one CTA each, and rows too long for a block (a
    mulmod_int ring at N >= 2^18) a single-pass chained scan over the card,
    whose tickets, status words and two words a row are the only scratch
    (mf_normmod_scratch(B, L) ints), then a launch that folds the carry
    out into the first digits.  Launches count under "normmod", or
    "normmod_long" on the long route."""
    _require(x, "normmod")
    L = x.shape[-1]
    if W != DIGIT_BITS * L:
        raise ValueError(f"normmod: W={W} must be 16*L (L={L})")
    s = int(s) % (2 * W)
    if x.device.type == "cpu":
        return normmod_rows_plain(x, s, W)
    if L > NORMMOD_LONG_MAX:
        raise ValueError(f"normmod: rows of {L} digits exceed the kernel's {NORMMOD_LONG_MAX}")
    B = x.numel() // L
    out = torch.empty_like(x)
    long = normmod_route(L) == "long"
    n = kernels.lib().mf_normmod_scratch(B, L) if long else 0
    scratch = torch.empty(n, dtype=torch.int32, device=x.device) if long else None
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_normmod(
            x.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), n,
            B, L, s, kernels.stream_of(x))
    kernels.check(rc, "normmod")
    kernels.LAUNCHES["normmod_long" if long else "normmod"] += 1
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
    vector whose true value must fit it.  The kernel reads each digit once
    and writes it once: one CTA a row up to CANON_ROW_MAX digits, longer
    rows a single-pass chained scan over CANON_TILE-digit tiles, whose
    status words are the only scratch; carries never cross vectors."""
    _require(x, "canonicalize")
    if x.device.type == "cpu":
        return canonicalize_plain_torch(x)
    N = x.shape[-1]
    Bt = x.numel() // N if N else 0
    out = torch.empty_like(x)
    n = kernels.lib().mf_canonicalize_scratch(Bt, N)
    scratch = torch.empty(n, dtype=torch.int32, device=x.device) if n else None
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_canonicalize(
            x.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), n,
            Bt, N, kernels.stream_of(x))
    kernels.check(rc, "canonicalize")
    kernels.LAUNCHES["canonicalize"] += 1
    return out


# ---------------------------------------------------------------------------
# 5. half-bit twiddles and the sqrt2 top layer (odd w)
# ---------------------------------------------------------------------------

def twiddle_half_rows_plain(x: torch.Tensor, e2: torch.Tensor, W: int) -> torch.Tensor:
    """Plain version of the half-bit twiddle row body (the reference's
    _twiddle_half_rows, fused.py:714-736): x * 2^(e2/2) mod p for an int64
    exponent column e2 in [0, 4W) broadcastable to x[..., :1].  Even e2 is
    shift_mod by k = e2/2; odd e2 is carry_pass(hi - lo) with
    2^(k+1/2) = 2^(k+3W/4) - 2^(k+W/4): hi, lo are static rotations by 3L/4
    and L/4 digits of base = shift_mod(x, k) when L % 4 == 0, else two
    sub-digit shift_mods of x."""
    L = x.shape[-1]
    k = e2 >> 1
    base = shift_mod(x, k, W)
    if L % 4 == 0:
        hi = shift_digits_static(base, (3 * L) // 4)
        lo = shift_digits_static(base, L // 4)
    else:   # the W/4 offset is not a whole digit: two more shifts of x
        hi = shift_mod(x, torch.remainder(k + 3 * W // 4, 2 * W), W)
        lo = shift_mod(x, torch.remainder(k + W // 4, 2 * W), W)
    return torch.where((e2 & 1) == 1, carry_pass(hi - lo), base)


def _affine_half_exps(j: torch.Tensor, e0: int, step: int, W: int) -> torch.Tensor:
    return torch.remainder(e0 + j * step, 4 * W)[..., None]


def twiddle_half_plain(x: torch.Tensor, e0: int, step: int, W: int) -> torch.Tensor:
    """Plain version of fused_twiddle_half: x[..., j, :] times
    2^((e0 + j*step)/2), j the index along axis -2."""
    L, h = x.shape[-1], x.shape[-2]
    j = torch.arange(x.numel() // L, dtype=torch.int64, device=x.device) % h
    return twiddle_half_rows_plain(
        x.reshape(-1, L), _affine_half_exps(j, e0, step, W), W).reshape(x.shape)


def fused_twiddle_half(x: torch.Tensor, e0: int, step: int, W: int) -> torch.Tensor:
    """x[..., j, :] * 2^((e0 + j*step)/2) mod p (half-bit exponents) in one
    pass, j the index along axis -2; leading axes replicate."""
    _require(x, "twiddle_half")
    L = x.shape[-1]
    if x.ndim < 2 or W != DIGIT_BITS * L:
        raise ValueError(f"twiddle_half: shape {tuple(x.shape)} needs rows on axis -2, W=16*L")
    h = x.shape[-2]
    B = x.numel() // L
    if x.device.type == "cpu":
        return twiddle_half_plain(x, e0, step, W)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_twiddle_half(
            x.data_ptr(), out.data_ptr(), B, L, h, int(e0), int(step), kernels.stream_of(x))
    kernels.check(rc, "twiddle_half")
    kernels.LAUNCHES["twiddle_half"] += 1
    return out


def sqrt2_top_fwd_plain(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Plain version of the forward top layer on x [..., C, L], C = 2h:
    [carry_pass(a + b), (a - b) * 2^(j w / 2)] with a, b the halves."""
    h = x.shape[-2] // 2
    a, b = x[..., :h, :], x[..., h:, :]
    e2 = _affine_half_exps(torch.arange(h, device=x.device), 0, w, W)
    return torch.cat([carry_pass(a + b), twiddle_half_rows_plain(a - b, e2, W)], dim=-2)


def sqrt2_top_inv_plain(x: torch.Tensor, w: int, W: int, norm_div: int = 0) -> torch.Tensor:
    """Plain version of the inverse top merge on x [..., C, L] = [sL, oR]:
    u = oR * 2^(-j w / 2), [post(sL + u), post(sL - u)], post = carry_pass,
    or for norm_div > 0 normmod(v / 2^norm_div)."""
    h = x.shape[-2] // 2
    sl, orr = x[..., :h, :], x[..., h:, :]
    e2 = _affine_half_exps(torch.arange(h, device=x.device), 0, -w, W)
    u = twiddle_half_rows_plain(orr, e2, W)
    if norm_div:
        sdiv = (2 * W - norm_div) % (2 * W)

        def post(v):
            return _normmod_core(shift_mod(v, sdiv, W))
    else:
        post = carry_pass
    return torch.cat([post(sl + u), post(sl - u)], dim=-2)


def _require_top(x: torch.Tensor, what: str, W: int) -> tuple[int, int, int]:
    _require(x, what)
    L = x.shape[-1]
    if x.ndim < 2 or x.shape[-2] % 2 or W != DIGIT_BITS * L:
        raise ValueError(f"{what}: shape {tuple(x.shape)} needs an even axis -2 and W=16*L")
    h = x.shape[-2] // 2
    return x.numel() // (2 * h * L), h, L


def fused_sqrt2_top_fwd(x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Forward sqrt2 top layer of a length-C = 2h transform over the 4n-th
    root q = sqrt2^w (odd w) in one pass over x [..., C, L]: row j of the
    output holds s_j = a_j + b_j, row h + j holds t_j = (a_j - b_j) q^j (a,
    b: the halves), carried (digits in [-1, 2^16]; the kernel's digits
    equal the plain version's after normmod).  Both halves then transform
    as one [..., 2, h, L] array."""
    N, h, L = _require_top(x, "sqrt2_top_fwd", W)
    if x.device.type == "cpu":
        return sqrt2_top_fwd_plain(x, w, W)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_sqrt2_top_fwd(
            x.data_ptr(), out.data_ptr(), N, h, L, int(w), kernels.stream_of(x))
    kernels.check(rc, "sqrt2_top_fwd")
    kernels.LAUNCHES["sqrt2_top_fwd"] += 1
    return out


def fused_sqrt2_top_inv(x: torch.Tensor, w: int, W: int, norm_div: int = 0) -> torch.Tensor:
    """Inverse sqrt2 top merge in one pass over x [..., C, L] = [sL, oR] (the
    two inverse half transforms): u_j = oR_j q^-j, rows j and h + j of the
    output hold sL_j + u_j and sL_j - u_j, carried (digits in [-1, 2^16];
    the kernel's digits equal the plain version's after normmod).
    norm_div > 0 instead divides both by 2^norm_div and canonicalizes in
    the same pass (the drivers' scale + normalize tail; canonical digits,
    identical to the plain version's).  Rows up to 8192 digits on the
    card."""
    N, h, L = _require_top(x, "sqrt2_top_inv", W)
    if x.device.type == "cpu":
        return sqrt2_top_inv_plain(x, w, W, norm_div)
    s = (2 * W - int(norm_div)) % (2 * W) if norm_div else -1
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_sqrt2_top_inv(
            x.data_ptr(), out.data_ptr(), N, h, L, int(w), s, kernels.stream_of(x))
    kernels.check(rc, "sqrt2_top_inv")
    kernels.LAUNCHES["sqrt2_top_inv"] += 1
    return out


# ---------------------------------------------------------------------------
# 6. MFA column transforms with their cross twiddles
# ---------------------------------------------------------------------------

# which columns the column kernel takes: the reference's rule (section 2's
# numbers, as ops/mfa.py _run_cols :131-133 applies them to a full column);
# the rows one CTA of the column kernel holds (the rest of its 227 KB block
# is tables); a wider column takes a cluster of WHOLE_CLUSTERS CTAs
MFA_COL_CTA_BYTES = 192 * 1024


def mfa_col_fits(n2: int, L: int, full: bool) -> bool:
    """Does the column kernel take an (n2, L) column?  The reference's
    condition: L <= 1024, and a full column (trunc2 == n2) only where its
    padded block is at most 512 KB.  The rest -- full columns past 512 KB,
    every column at L 2048 -- takes the truncate.py recursion on the ladder,
    in both packages."""
    return L <= WHOLE_MAX_FUSED_L and (
        not full or _padded_row_bytes(n2, L) <= WHOLE_MAX_ROW_BYTES)


def mfa_col_cluster(n2: int, L: int) -> int | None:
    """The CTAs that hold one (n2, L) column: the fewest of 1, 2, 4, 8 whose
    share, n2 / R rows, fits MFA_COL_CTA_BYTES (R > 1: a thread-block
    cluster, at least 2 rows a CTA); None past a cluster of 8.  Every column
    of a plan the planner makes is held: its columns at L <= 1024 are at
    most (256, 1024), 1 MB, R 8.  The truncated columns of more than 1.5 MB
    that the reference's rule fuses but no plan gives take the truncate.py
    recursion (mfa._run_cols)."""
    for R in WHOLE_CLUSTERS:
        if n2 % R == 0 and (R == 1 or n2 // R >= 2) and (n2 // R) * L * 4 <= MFA_COL_CTA_BYTES:
            return R
    return None


def mfa_cols_plain(kind: str, x: torch.Tensor, w: int, W: int, n1: int, trunc2: int,
                   no_zero_tail: bool = False, block: tuple[int, int] | None = None
                   ) -> torch.Tensor:
    """Plain version of the column kernel: the truncated transform of
    ops/truncate.py (full at trunc2 == n2) of every (n2, L) column of x
    (B, n2, L) at root w * n1, with the cross twiddles of flat row b's column
    j1 = b & (n1 - 1) (mfa._block_cross_exps) as its post / pre table; with
    block = (off, cols), x holds columns [off, off + cols) of the n1, and
    j1 = off + (b & (cols - 1))."""
    from .mfa import _block_cross_exps
    from .truncate import truncated

    B, n2, _ = x.shape
    off, cols = block or (0, n1)
    pe = _block_cross_exps(B, 0, cols - 1, n2, w, W, x.device, off)
    return truncated(kind, no_zero_tail)(x, w * n1, W, trunc2, pe)


# schedule op codes: csrc/mfa_cols.cu's Op, in the same order
(_OP_FFT, _OP_IFFT, _OP_TOP_FWD, _OP_FOLD, _OP_DOUBLE, _OP_RESTORE, _OP_PE_DIV,
 _OP_TAIL0, _OP_TAIL1, _OP_BFLY_INV, _OP_OUT1) = range(11)


def _sched_fwd(ops: list, lo: int, C: int, w: int, trunc: int, one: bool) -> None:
    """fft_trunc (one=False) / fft_trunc1 (one=True) of rows [lo, lo+C) with
    the column's table, as in-place row ops (see mfa_cols_schedule)."""
    if trunc == C:
        ops.append((_OP_FFT, lo, C, 0, 0, 0, w, 1))
        return
    h = C // 2
    if trunc <= h:
        if one:
            ops.append((_OP_FOLD, lo, h, 0, h, 0, 0, 0))
        _sched_fwd(ops, lo, h, 2 * w, trunc, one)
        return
    ops.append((_OP_TOP_FWD, lo, h, h if one else trunc - h, 0, 0, w, 0))
    ops.append((_OP_FFT, lo, h, 0, 0, 0, 2 * w, 1))
    _sched_fwd(ops, lo + h, h, 2 * w, trunc - h, True)


def _sched_inv(ops: list, lo: int, C: int, w: int, trunc: int, one: bool, pe: bool,
               top: bool) -> None:
    """ifft_trunc (one=False) / ifft_trunc1 (one=True) of rows [lo, lo+C),
    with the column's table where pe, as in-place row ops.  The functional
    code's outputs past trunc are its inputs there: RESTORE copies them
    back from the kernel's input where the in-place ops overwrote them and
    a caller reads them (ifft_trunc's levels, whose inputs are the
    column's own rows) or the caller is the top level."""
    if trunc == C:
        ops.append((_OP_IFFT, lo, C, 0, 0, 0, w, int(pe)))
        return
    h = C // 2
    lgh, lgC = h.bit_length() - 1, C.bit_length() - 1
    if not one and trunc <= h:
        _sched_inv(ops, lo, h, 2 * w, trunc, False, pe, False)
        ops.append((_OP_DOUBLE, lo, h, 0, 0, 0, 0, 0))
        return
    if one and trunc <= h:
        if pe:
            ops.append((_OP_PE_DIV, lo, trunc, 0, 0, 0, 0, 0))
        if trunc < h:
            ops.append((_OP_FOLD, lo, h, trunc, h, 0, 0, 0))
        _sched_inv(ops, lo, h, 2 * w, trunc, True, False, False)
        ops.append((_OP_OUT1, lo, h, trunc, 0, lgC, 0, 0))
    else:
        k = trunc - h
        ops.append((_OP_IFFT, lo, h, 0, 0, 0, 2 * w, int(pe)))
        ops.append((_OP_TAIL1 if one else _OP_TAIL0, lo, h, k, lgh, lgC, w, 0))
        if pe:
            ops.append((_OP_PE_DIV, lo + h, k, 0, 0, 0, 0, 0))
        _sched_inv(ops, lo + h, h, 2 * w, k, True, False, False)
        ops.append((_OP_BFLY_INV, lo, h, k, 0, 0, w, 0))
    if top or not one:
        ops.append((_OP_RESTORE, lo + trunc, C - trunc, 0, 0, 0, 0, 0))


@functools.lru_cache(maxsize=256)
def mfa_cols_schedule(kind: str, n2: int, w_col: int, trunc2: int,
                      no_zero_tail: bool) -> tuple:
    """The column kernel's program: the recursion of the truncated
    transform (ops/truncate.py) of one (n2, L) column at root w_col, as a
    host-built list of in-place row ops (kind, lo, n, k, e1, e2, w, pe),
    each over rows of the column in shared memory:
      FFT / IFFT (lo, C, w, pe)      a whole sub-transform (ladder groups,
                                     a carry after each), table at its
                                     last / first stage
      TOP_FWD (lo, h, k, w)          s = carry(a+b) for j < k, t = (a-b) z^j
                                     (a alone past k)
      FOLD (lo, h, j0, j1)           x_j = carry(x_j + x_{j+h}), j in [j0, j1)
      DOUBLE (lo, n)                 x_j = carry(2 x_j)
      RESTORE (lo, n)                x_j = the kernel's input row
      PE_DIV (lo, n)                 x_j / 2^pe_j
      TAIL0 / TAIL1 (lo, h, k, lgh, lgC, w)  the inverse's right-input
                                     reconstruction and left tail, j in [k, h)
      BFLY_INV (lo, h, k, w)         the cross inverse butterflies, j < k
      OUT1 (lo, h, trunc, lgC)       ifft_trunc1's left outputs, j < trunc
    The sequence depends only on (kind, n2, trunc2, flavour): the same
    integer ops in the same order as the functional version, so the kernel's
    digits equal mfa_cols_plain's (tests/test_torch_mfa.py runs a torch
    interpreter of this schedule against it)."""
    ops: list = []
    if kind == "fwd":
        _sched_fwd(ops, 0, n2, w_col, trunc2, no_zero_tail)
    else:
        _sched_inv(ops, 0, n2, w_col, trunc2, no_zero_tail, True, True)
    return tuple(ops)


@functools.lru_cache(maxsize=256)
def _schedule_on(key: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(mfa_cols_schedule(*key), dtype=torch.int64, device=device)


def fused_mfa_cols(kind: str, x: torch.Tensor, w: int, W: int, n1: int, trunc2: int,
                   no_zero_tail: bool = False, block: tuple[int, int] | None = None
                   ) -> torch.Tensor:
    """The column pass of a 2-D MFA transform in one launch: every (n2, L)
    column of x (B, n2, L) -- flat row b is column j1 = b & (n1 - 1) of its
    (n1, n2) block, leading axes flattened into B -- transformed at root
    w * n1 by the truncated transform of `kind` and flavour at trunc2 rows
    (full at trunc2 == n2), with the cross twiddles 2^(w revbin(j2) j1)
    multiplied in at the forward's last stage (divided out at the inverse's
    first).  block = (off, cols): x holds columns [off, off + cols) of the
    n1 (a rank's share, ops/mfa.py's sharded passes), flat row b is column
    off + (b & (cols - 1)).  Each column resident in the shared memory of
    one CTA or of a cluster of R CTAs (mfa_col_cluster); the columns the
    reference fuses (mfa_col_fits), else ValueError, as on the card past a
    cluster of 8.
    Output: bounded redundant digits."""
    if kind not in ("fwd", "inv"):
        raise ValueError(f"kind must be 'fwd' or 'inv', got {kind!r}")
    _require(x, "mfa_cols", ndim=3)
    B, n2, L = x.shape
    off, cols = block or (0, n1)
    if (B == 0 or n1 < 1 or n1 & (n1 - 1) or cols < 1 or cols & (cols - 1) or B % cols
            or off < 0 or off % cols or off + cols > n1 or n2 < 1 or n2 & (n2 - 1)
            or not 1 <= trunc2 <= n2 or W != DIGIT_BITS * L):
        raise ValueError(f"mfa_cols: shape {tuple(x.shape)}, n1={n1}, block={block}, "
                         f"trunc2={trunc2}, W={W}: B a nonzero multiple of the block's "
                         "columns, n1, the block and n2 powers of two, the block aligned "
                         "inside n1, 1 <= trunc2 <= n2, W = 16 L required")
    if not mfa_col_fits(n2, L, trunc2 == n2):
        raise ValueError(f"mfa_cols: the reference does not fuse an ({n2}, {L}) column "
                         f"at trunc2 {trunc2}")
    if x.device.type == "cpu":
        return mfa_cols_plain(kind, x, w, W, n1, trunc2, no_zero_tail, block)
    return _launch_cols("mfa_cols", kind, x, w, n1, trunc2, no_zero_tail, off, cols)


def _launch_cols(counter: str, kind: str, x: torch.Tensor, w: int, n1: int, trunc2: int,
                 no_zero_tail: bool, off: int, cols: int) -> torch.Tensor:
    """One launch of csrc/mfa_cols.cu on the checked (B, n2, L) CUDA tensor
    x, counted under LAUNCHES[counter]."""
    B, n2, L = x.shape
    R = mfa_col_cluster(n2, L)
    if R is None:
        raise ValueError(f"{counter}: an ({n2}, {L}) column exceeds a cluster of "
                         f"{WHOLE_CLUSTERS[-1]} CTAs")
    sched = _schedule_on((kind, n2, w * n1, trunc2, bool(no_zero_tail)), x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_mfa_cols(
            x.data_ptr(), out.data_ptr(), sched.data_ptr(), sched.shape[0], B, n2, L,
            cols - 1, off, int(w), ladder_stages(L), R, kernels.stream_of(x))
    kernels.check(rc, counter)
    kernels.LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# 7. one whole block's transform in one launch
# ---------------------------------------------------------------------------

def fused_plain(kind: str, x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """Plain version of fused: the column kernel's plain version on x as
    one column (n1 = 1: no cross twiddle), its full transform."""
    return mfa_cols_plain(kind, x[None], w, W, 1, x.shape[0])[0]


def fused(kind: str, x: torch.Tensor, w: int, W: int) -> torch.Tensor:
    """The whole transform of one (C, L) block in one launch -- the
    reference's fused(fn, x) (mpir_fft_tpu/ops/fused.py:154) with fn its
    fft_radix2 (kind "fwd") or ifft_radix2 ("inv") at root 2^w: csrc/
    mfa_cols.cu on x as a single column (n1 = 1, trunc2 = C, cross
    exponent 0), held in one CTA or a cluster (mfa_col_cluster).  The
    blocks the column kernel takes (mfa_col_fits on a full column), else
    ValueError.  Counted under LAUNCHES["fused"].  Output: bounded
    redundant digits, equal to the reference's after normmod."""
    if kind not in ("fwd", "inv"):
        raise ValueError(f"kind must be 'fwd' or 'inv', got {kind!r}")
    _require(x, "fused", ndim=2)
    C, L = x.shape
    if C < 1 or C & (C - 1) or W != DIGIT_BITS * L or not mfa_col_fits(C, L, True):
        raise ValueError(f"fused: a ({C}, {L}) block at W={W}: C a power of two, W = 16 L "
                         f"and a block the column kernel holds (mfa_col_fits) required")
    if x.device.type == "cpu":
        return fused_plain(kind, x, w, W)
    return _launch_cols("fused", kind, x[None], w, 1, C, False, 0, 1)[0]
