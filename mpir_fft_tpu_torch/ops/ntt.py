"""Pointwise multiplication mod p = 2^(16M)+1 by a dense negacyclic NTT over
three small primes with CRT recombination (counterpart of
mpir_fft_tpu/ops/ntt.py, its dense tier).

Per prime p, c mod p = INTT_p(NTT_p(a) * NTT_p(b)), each transform ONE int8
matrix product [B, kM] @ [kM, kM] with int32 sums: a value mod p enters as
k = 2 signed-int8 planes (v = v0 + 256 v1, balanced), and the 256^j factors
of the high planes sit in the matrix (row-plane j of the block holds the
planes of 256^j V mod p), so the raw sums S = [S0 | S1] fold to the value
S0 + 256 S1 mod p.  Three primes == 1 mod 4096 (P ~ 2^44.8) cover M <= 2048:
after one balanced carry pass the digits are below 2^15 + 2^9 + 2, so the
negacyclic coefficients stay below M (2^15 + 2^9 + 2)^2 < 2^41.1 < P/2.
Garner's mixed radix gives the signed coefficient c exactly in int64; its
three base-2^16 pieces land at digits i, i+1, i+2 (negacyclic) and one
carry pass bounds the result.

The host part (primes, roots, plane-block matrices, Garner constants) is a
copy of the reference's.  The device part is plain torch on int32 / int64
tensors with exact integer reduction (the reference's f32-Barrett
reductions are a TPU workaround for slow integer division); the elementwise
links between the GEMMs run as the three kernels of csrc/ntt_links.cu,
wrapped here (input_planes, mid_planes, garner_carry) beside their plain
versions.  The GEMMs themselves are torch._int_mm (the reference leaves
them to XLA, outside any kernel).

Only the dense tier is ported: rings with M > TIER1_MAX_M (the reference's
4-step tier 2) take the recursive Fermat mulmod (ops/mulmod.py).  The
tier-2 host constants (PRIMES_T2, the tier-2 branch of _tier, the planes
and primes arguments of _matrices_p and _garner_consts) are copied with
the rest so that tier 2 (ROADMAP queue 1 item 5) can build on them; no
path of the port reaches them yet."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .fused import _require
from .limb import DIGIT_BITS, _wrap_inject, carry_pass, normmod

PRIMES = (12289, 40961, 61441)       # P ~ 2^44.8; |c| < P/2 up to M = 2048
PRIMES_T2 = (65537, 114689, 163841)  # P ~ 2^50.1; |c| < P/2 up to M = 8192
TIER1_MAX_M = 2048
NTT_MAX_M = 8192


def _tier(M: int) -> tuple[tuple[int, int, int], int]:
    """(primes, planes) serving transform length M."""
    if M <= TIER1_MAX_M:
        return PRIMES, 2
    return PRIMES_T2, 3


def ntt_supported(M: int) -> bool:
    return 4 <= M <= NTT_MAX_M and (M & (M - 1)) == 0


# ---------------------------------------------------------------------------
# Host: roots and plane-block transform matrices (copied from the reference)
# ---------------------------------------------------------------------------

def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def _generator(p: int) -> int:
    fs = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fs):
            return g
    raise AssertionError(f"no generator mod {p}")


@functools.lru_cache(maxsize=None)
def _psi(p: int, M: int) -> int:
    """Primitive 2M-th root mod p with psi^M == -1."""
    assert (p - 1) % (2 * M) == 0, (p, M)
    psi = pow(_generator(p), (p - 1) // (2 * M), p)
    assert pow(psi, M, p) == p - 1
    return psi


def _center(v: np.ndarray, p: int) -> np.ndarray:
    return np.where(v > p // 2, v - p, v).astype(np.int64)


def _split_planes(v: np.ndarray, k: int) -> list[np.ndarray]:
    """Signed value -> k planes with v = sum_j planes[j] * 256^j, the low
    k-1 balanced into [-128, 128)."""
    planes = []
    for _ in range(k - 1):
        lo = ((v + 128) % 256) - 128
        planes.append(lo)
        v = (v - lo) >> 8
    planes.append(v)
    return planes


def _plane_block(V: np.ndarray, p: int, k: int) -> np.ndarray:
    """[M, M] value matrix mod p -> [kM, kM] signed-int8 plane block so that
    for X = [x0 | .. | x_{k-1}] (input planes), X @ block = [S0 | .. | S_{k-1}]
    with  x @ V mod p == sum_j 256^j * S_j  (mod p)."""
    rows = []
    for j in range(k):
        Uj = (V * (256**j)) % p
        rows.append(np.concatenate(_split_planes(_center(Uj, p), k), axis=1))
    blk = np.concatenate(rows, axis=0)
    assert blk.min() >= -128 and blk.max() <= 127
    return blk.astype(np.int8)


def _matrices(M: int) -> list[dict]:
    primes, planes = _tier(M)
    return _matrices_p(M, primes, planes)


@functools.lru_cache(maxsize=None)
def _matrices_p(M: int, primes: tuple, planes: int) -> list[dict]:
    """Per prime: plane-block forward/inverse negacyclic NTT matrices.
    F[i, k] = psi^(i(2k+1)); G[k, j] = M^-1 psi^(-j(2k+1))  (mod p)."""
    out = []
    for p in primes:
        psi = _psi(p, M)
        pows = np.empty(2 * M, np.int64)
        acc = 1
        for e in range(2 * M):
            pows[e] = acc
            acc = acc * psi % p
        i = np.arange(M, dtype=np.int64)[:, None]
        k = np.arange(M, dtype=np.int64)[None, :]
        F = pows[(i * (2 * k + 1)) % (2 * M)]
        Minv = pow(M, -1, p)
        G = (Minv * pows[(-(k * (2 * i + 1))) % (2 * M)]) % p
        out.append({"p": p, "k": planes,
                    "F": _plane_block(F, p, planes),
                    "G": _plane_block(G, p, planes)})
    return out


@functools.lru_cache(maxsize=None)
def _garner_consts(primes: tuple[int, int, int]) -> dict:
    p1, p2, p3 = primes
    return {
        "inv12": pow(p1, -1, p2),
        "inv13": pow(p1, -1, p3),
        "inv23": pow(p2, -1, p3),
        "q": p1 * p2,
    }


@functools.lru_cache(maxsize=8)
def _blocks(M: int, device: torch.device) -> tuple[tuple[int, torch.Tensor, torch.Tensor], ...]:
    """Per prime (p, F, G): the int8 plane blocks as tensors on `device`,
    built once per (M, device).  At M = 2048 each is [4096, 4096] (16 MB).
    They are stored column-major (F.t() contiguous): torch._int_mm on the
    card then takes cuBLASLt's fast int8 layout, 7x faster at the 10^9-bit
    shape than a row-major block (chip_smoke.py prints both)."""
    def col_major(a):
        return torch.from_numpy(a).to(device).t().contiguous().t()

    return tuple((m["p"], col_major(m["F"]), col_major(m["G"])) for m in _matrices(M))


# ---------------------------------------------------------------------------
# Device: exact integer helpers on [..., M] / [..., kM] tensors (the plain
# versions of csrc/ntt_links.cu are built from these)
# ---------------------------------------------------------------------------

def _balanced_pass(x: torch.Tensor) -> torch.Tensor:
    """One carry sweep recentering digits to ~[-2^15, 2^15], the top carry
    wrapping negated into digit 0.  From |digit| <= B the output bound is
    2^15 + B/2^16 + 1 (exact in the ring)."""
    m = (x + (1 << (DIGIT_BITS - 1))) >> DIGIT_BITS
    r = x - (m << DIGIT_BITS)
    return r + _wrap_inject(m)


def _center_mod(x: torch.Tensor, p: int) -> torch.Tensor:
    """Exact centered representative of x mod p, in [-(p-1)/2, (p-1)/2]."""
    r = torch.remainder(x, p)
    return torch.where(r > p // 2, r - p, r)


def _to_planes(x: torch.Tensor, p: int) -> torch.Tensor:
    """[..., M] values -> [..., 2M] signed-int8 planes [lo | hi] of the
    centered residue mod p (lo balanced into [-128, 128))."""
    rc = _center_mod(x, p)
    lo = ((rc + 128) & 255) - 128
    hi = (rc - lo) >> 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def _fold_S(S: torch.Tensor, p: int) -> torch.Tensor:
    """Raw plane sums [..., 2M] = [S0 | S1] (|S_j| <= 2M 128^2 <= 2^26) ->
    values S0 + 256 S1 mod p in [0, p), [..., M].  S1 is reduced first so
    the sum stays int32-exact."""
    M = S.shape[-1] // 2
    return torch.remainder(S[..., :M] + (torch.remainder(S[..., M:], p) << 8), p)


def _dot_raw(planes: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """[B, 2M] int8 planes @ [2M, 2M] int8 block -> raw int32 plane sums
    (exact: |S_j| <= 2M 128^2).  torch._int_mm on the card wants more than
    16 rows, so a short batch is padded with zero rows.  On the card each
    call counts as one "int8_gemm" launch."""
    rows = planes.shape[0]
    if rows <= 16:
        planes = torch.cat([planes, planes.new_zeros((32 - rows, planes.shape[1]))])
    out = torch._int_mm(planes, blk)[:rows]
    if out.is_cuda:
        kernels.LAUNCHES["int8_gemm"] += 1
    return out


def _garner(r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """Residues in [0, p_j) -> the signed coefficient c (int64) with
    c == r_j mod p_j and |c| < P/2: mixed-radix digits
    c = v1 + p1 v2 + p1 p2 v3, the last one centered."""
    p1, p2, p3 = PRIMES
    g = _garner_consts(PRIMES)
    v1 = r1.to(torch.int64)
    v2 = torch.remainder(torch.remainder(r2 - v1, p2) * g["inv12"], p2)
    t = torch.remainder(torch.remainder(r3 - v1, p3) * g["inv13"], p3)
    v3 = torch.remainder(torch.remainder(t - v2, p3) * g["inv23"], p3)
    v3 = torch.where(v3 > p3 // 2, v3 - p3, v3)
    return v1 + p1 * v2 + g["q"] * v3


def _spread(c: torch.Tensor) -> torch.Tensor:
    """Signed coefficients c_i (|c| < 2^44) at digit i -> int32 digit sums
    s_i = c_i mod 2^16 + (c_(i-1) >> 16 mod 2^16) + (c_(i-2) >> 32), the
    pieces that pass the top wrapping negated (2^(16M) == -1).
    |s_i| < 2^17 + 2^12."""
    c0 = (c & 0xFFFF).to(torch.int32)
    c1 = ((c >> 16) & 0xFFFF).to(torch.int32)
    c2 = (c >> 32).to(torch.int32)
    return c0 + _wrap_inject(c1) + _wrap_inject(_wrap_inject(c2))


# ---------------------------------------------------------------------------
# The link kernels between the GEMMs (csrc/ntt_links.cu), tier 1: the three
# primes of PRIMES, two int8 planes [lo | hi] per value.  Each wrapper
# beside its plain version; a CPU tensor takes the plain version, a CUDA
# tensor launches the kernel or raises.
# ---------------------------------------------------------------------------

def input_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the balanced carry pass of x (B, M), then per prime
    the planes of the centered residue -> (3, B, 2M) int8."""
    xb = _balanced_pass(x)
    return torch.stack([_to_planes(xb, p) for p in PRIMES])


def mid_planes_plain(sa: torch.Tensor, sb: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version: fold both raw forward sums (B, 2M) mod p, multiply
    the centered values, the product's planes (B, 2M) int8."""
    fa = _center_mod(_fold_S(sa, p), p)
    fb = _center_mod(_fold_S(sb, p), p)
    return _to_planes(fa * fb, p)


def garner_carry_plain(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor) -> torch.Tensor:
    """Plain version: fold the three raw inverse sums (B, 2M) to residues,
    Garner to the signed coefficients, spread into digits, one carry pass
    -> (B, M) int32."""
    r1, r2, r3 = (_fold_S(s, p) for s, p in zip((s1, s2, s3), PRIMES))
    return carry_pass(_spread(_garner(r1, r2, r3)))


def _require_link(x: torch.Tensor, what: str, dtype: torch.dtype, width: int) -> int:
    """Check a (B, width * M) link operand; return M."""
    _require(x, what, ndim=2, dtype=dtype)
    M = x.shape[1] // width
    if x.shape[1] != width * M or M < 4 or M > TIER1_MAX_M or M & (M - 1):
        raise ValueError(f"{what}: shape {tuple(x.shape)} needs {width} x M columns, "
                         f"M a power of two in [4, {TIER1_MAX_M}]")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: 16-byte aligned rows required")
    return M


def input_planes(x: torch.Tensor) -> torch.Tensor:
    """Balanced carry pass + per-prime plane conversion in one pass:
    x (B, M) int32 digits (|digit| <= 2^25) -> (3, B, 2M) int8, slab j the
    planes [lo | hi] of prime PRIMES[j] (the forward GEMMs' inputs)."""
    M = _require_link(x, "input_planes", torch.int32, 1)
    if x.device.type == "cpu":
        return input_planes_plain(x)
    B = x.shape[0]
    out = torch.empty((len(PRIMES), B, 2 * M), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernels.lib().mf_input_planes(x.data_ptr(), out.data_ptr(), B, M,
                                           kernels.stream_of(x))
    kernels.check(rc, "input_planes")
    kernels.LAUNCHES["input_planes"] += 1
    return out


def mid_planes(sa: torch.Tensor, sb: torch.Tensor, p: int) -> torch.Tensor:
    """Fold both forward GEMM outputs, multiply mod p and replane for the
    inverse GEMM in one pass: sa, sb (B, 2M) raw int32 plane sums -> (B, 2M)
    int8 planes of (fa * fb) mod p."""
    M = _require_link(sa, "mid_planes", torch.int32, 2)
    _require_link(sb, "mid_planes", torch.int32, 2)
    if sa.shape != sb.shape or sa.device != sb.device:
        raise ValueError(f"mid_planes: operands differ: {tuple(sa.shape)} on {sa.device} "
                         f"vs {tuple(sb.shape)} on {sb.device}")
    if p not in PRIMES:
        raise ValueError(f"mid_planes: p={p} is not one of {PRIMES}")
    if sa.device.type == "cpu":
        return mid_planes_plain(sa, sb, p)
    B = sa.shape[0]
    out = torch.empty(sa.shape, dtype=torch.int8, device=sa.device)
    with torch.cuda.device(sa.device):
        rc = kernels.lib().mf_mid_planes(sa.data_ptr(), sb.data_ptr(), out.data_ptr(), B, M,
                                         PRIMES.index(p), kernels.stream_of(sa))
    kernels.check(rc, "mid_planes")
    kernels.LAUNCHES["mid_planes"] += 1
    return out


def garner_carry(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor) -> torch.Tensor:
    """The three primes' raw inverse GEMM sums (B, 2M) int32, in the order
    of PRIMES -> (B, M) bounded redundant digits (-2 <= d <= 2^16 + 1) of
    the negacyclic product: fold, Garner CRT, spread and carry in one pass."""
    M = _require_link(s1, "garner_carry", torch.int32, 2)
    for s in (s2, s3):
        _require_link(s, "garner_carry", torch.int32, 2)
        if s.shape != s1.shape or s.device != s1.device:
            raise ValueError(f"garner_carry: operands differ: {tuple(s1.shape)} on {s1.device} "
                             f"vs {tuple(s.shape)} on {s.device}")
    if s1.device.type == "cpu":
        return garner_carry_plain(s1, s2, s3)
    B = s1.shape[0]
    out = torch.empty((B, M), dtype=torch.int32, device=s1.device)
    with torch.cuda.device(s1.device):
        rc = kernels.lib().mf_garner_carry(s1.data_ptr(), s2.data_ptr(), s3.data_ptr(),
                                           out.data_ptr(), B, M, kernels.stream_of(s1))
    kernels.check(rc, "garner_carry")
    kernels.LAUNCHES["garner_carry"] += 1
    return out


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def mulmod_ntt(a: torch.Tensor, b: torch.Tensor, canonical: bool = False) -> torch.Tensor:
    """(a * b) mod 2^(16M)+1 on digit vectors [..., M] (broadcast), M a
    power of two in [4, 2048].  Inputs may be redundant (|digit| <= 2^25);
    the output is bounded redundant digits (|d| < 2^16 + 2^12) unless
    canonical=True.  `b is a` (a square) transforms once.

    The flow of the reference's link-fused dense tier (ntt.py:1000-1015):
    input_planes per operand, per prime two forward GEMMs, mid_planes and
    one inverse GEMM, then garner_carry on the three raw inverse sums."""
    M = a.shape[-1]
    if not ntt_supported(M):
        raise ValueError(f"mulmod_ntt: M={M} must be a power of two in [4, {NTT_MAX_M}]")
    if M > TIER1_MAX_M:
        raise NotImplementedError("mulmod_ntt: tier 2 (M > 2048) is not ported "
                                  "(ROADMAP queue 1 item 5); mulmod() recurses instead")
    square = b is a
    shape = torch.broadcast_shapes(a.shape, b.shape)
    pa = input_planes(a.expand(shape).reshape(-1, M).contiguous())
    pb = pa if square else input_planes(b.expand(shape).reshape(-1, M).contiguous())
    parts = []
    for i, (p, F, G) in enumerate(_blocks(M, a.device)):
        Sa = _dot_raw(pa[i], F)
        Sb = Sa if square else _dot_raw(pb[i], F)
        pp = mid_planes(Sa, Sb, p)
        del Sa, Sb
        parts.append(_dot_raw(pp, G))
    d = garner_carry(*parts).reshape(shape)
    return normmod(d) if canonical else d
